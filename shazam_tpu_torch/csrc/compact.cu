// K3: bit-packed peak mask -> (t, f)-ordered peak list per song.
//
// Replaces the Pallas kernel shazam_tpu/ops/pallas/compact.py
// (_ff_kernel + _tile_segment). The TPU version ranks candidates with
// sublane roll-adds, places them with an f32 one-hot matmul scatter (and
// patches its 2^24 exactness limit), and walks the tiles in grid order
// with a running cursor. Here one block owns one song:
//
//   1. per chunk of 1024 frames, each thread popcounts one frame's 65
//      mask words and a block-wide scan turns the counts into exclusive
//      frame offsets (plus the running total of earlier chunks);
//   2. each warp then takes whole frames: a warp scan over the per-word
//      popcounts gives every word its slot, and each lane writes its
//      word's set bits in ascending bin order.
//
// Slots >= capacity are not written; slots in [min(n, capacity),
// capacity) are zeroed; n_peaks is the EXACT count (callers detect
// overflow as n_peaks > capacity, and retry at a larger capacity).
//
// Bound: reads the (B, T, 65) mask twice (tiny) and writes 8 bytes per
// kept peak; one block per song, so it is latency bound.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads) compact_kernel(
    const uint32_t* __restrict__ bits,  // (B, T, 65)
    int n_frames, int capacity,
    int32_t* __restrict__ times,        // (B, capacity)
    int32_t* __restrict__ freqs,        // (B, capacity)
    int32_t* __restrict__ n_peaks) {    // (B,)
  __shared__ int frame_off[kThreads];
  __shared__ int warp_sum[kWarps];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t* song = bits + (int64_t)b * n_frames * shz::kMaskWords;
  int32_t* out_t = times + (int64_t)b * capacity;
  int32_t* out_f = freqs + (int64_t)b * capacity;

  int carry = 0;  // peaks in earlier chunks (same value in every thread)
  for (int c0 = 0; c0 < n_frames; c0 += kThreads) {
    const int t = c0 + threadIdx.x;
    int count = 0;
    if (t < n_frames) {
      const uint32_t* row = song + (int64_t)t * shz::kMaskWords;
      for (int w = 0; w < shz::kMaskWords; ++w) count += __popc(row[w]);
    }
    const int incl = warp_inclusive_scan(count, lane);
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) warp_sum[lane] = warp_inclusive_scan(warp_sum[lane], lane);
    __syncthreads();
    frame_off[threadIdx.x] =
        carry + incl - count + (warp > 0 ? warp_sum[warp - 1] : 0);
    const int chunk_total = warp_sum[kWarps - 1];
    __syncthreads();

    const int frames_here = min(kThreads, n_frames - c0);
    for (int i = warp; i < frames_here; i += kWarps) {
      const int tt = c0 + i;
      const uint32_t* row = song + (int64_t)tt * shz::kMaskWords;
      int off = frame_off[i];
      for (int w0 = 0; w0 < shz::kMaskWords; w0 += 32) {
        const int w = w0 + lane;
        uint32_t word = w < shz::kMaskWords ? row[w] : 0u;
        const int pc = __popc(word);
        const int wincl = warp_inclusive_scan(pc, lane);
        int pos = off + wincl - pc;
        off += __shfl_sync(kFull, wincl, 31);
        while (word) {
          const int bit = __ffs(word) - 1;
          word &= word - 1;
          if (pos < capacity) {
            out_t[pos] = tt;
            out_f[pos] = 32 * w + bit;
          }
          ++pos;
        }
      }
    }
    carry += chunk_total;
    __syncthreads();  // frame_off / warp_sum are rewritten next chunk
  }
  for (int i = min(carry, capacity) + threadIdx.x; i < capacity;
       i += kThreads) {
    out_t[i] = 0;
    out_f[i] = 0;
  }
  if (threadIdx.x == 0) n_peaks[b] = carry;
}

}  // namespace

SHZ_EXPORT int shz_compact(const unsigned int* bits, int batch, int n_frames,
                           int capacity, int* times, int* freqs, int* n_peaks,
                           void* stream) {
  if (batch <= 0) return 0;
  compact_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
      bits, n_frames, capacity, times, freqs, n_peaks);
  return (int)cudaGetLastError();
}
