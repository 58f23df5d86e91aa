// K2: power spectrogram -> bit-packed constellation peak mask.
//
// Replaces the Pallas kernel shazam_tpu/ops/pallas/peaks.py (_kernel).
// The TPU version runs log-step running reductions over a 128-frame tile
// with 128-lane freq halos, then ranks peaks per 128-bin group with a
// triangular matmul (GROUP_CAP slots per group). Here each block owns a
// kTileT x kTileF cell tile plus a radius-10 halo in shared memory and
// computes, for every cell, reference get_2D_peaks semantics in the power
// domain:
//
//   local_max = (21x21 max over the window == p)        (separable)
//   eroded    = AND over the window of bg, bg = (p == 0) | (p == 1)
//               (power 1 is dB 0; out-of-range cells count as background,
//               scipy's border_value=1)
//   mask      = (local_max != eroded) & (p >= power_threshold) & (f < 2049)
//
// Out-of-range cells load as 0: power is non-negative, so a zero pad
// leaves every window max unchanged (the window holds its own centre) and
// is background for the erosion. The erosion passes run only when the
// tile's window span holds an in-range background cell (silence, padded
// frames, song edges); otherwise no window can be all background and the
// erosion is identically false. The mask leaves as one 32-bit ballot word
// per warp: (B, T, 65) words, bit j of word w = bin 32 w + j. There is no
// per-group cap, so no overflow to report.
//
// Bound: ~45 shared-memory compares per cell for the two separable
// passes; DRAM traffic is one read of the (halo-amplified) spectrum and
// 1/32 of it written.
#include "common.cuh"

namespace {

constexpr int kRadius = 10;
constexpr int kTileT = 16;
constexpr int kTileF = 128;
constexpr int kRowsH = kTileT + 2 * kRadius;   // 36
constexpr int kColsH = kTileF + 2 * kRadius;   // 148
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) peak_mask_kernel(
    const float* __restrict__ power,   // (B, T, 2049)
    int n_frames, float threshold,
    uint32_t* __restrict__ bits) {     // (B, T, 65)
  __shared__ float tile[kRowsH][kColsH];
  __shared__ float fmax[kRowsH][kTileF];
  __shared__ uint8_t fbg[kRowsH][kTileF];

  const int f0 = blockIdx.x * kTileF;
  const int t0 = blockIdx.y * kTileT;
  const int b = blockIdx.z;
  const float* spec = power + (int64_t)b * n_frames * shz::kBins;

  int has_bg = 0;
  for (int i = threadIdx.x; i < kRowsH * kColsH; i += kThreads) {
    const int r = i / kColsH, c = i % kColsH;
    const int t = t0 + r - kRadius, f = f0 + c - kRadius;
    float v = 0.f;
    if (t >= 0 && t < n_frames && f >= 0 && f < shz::kBins) {
      v = spec[(int64_t)t * shz::kBins + f];
      has_bg |= (v == 0.f) | (v == 1.f);
    }
    tile[r][c] = v;
  }
  has_bg = __syncthreads_or(has_bg);

  // separable 21x21 max: along freq into fmax, then along time per cell
  for (int i = threadIdx.x; i < kRowsH * kTileF; i += kThreads) {
    const int r = i / kTileF, c = i % kTileF;
    float m = tile[r][c];
    uint8_t all_bg = 1;
#pragma unroll
    for (int d = 0; d <= 2 * kRadius; ++d) {
      const float v = tile[r][c + d];
      m = fmaxf(m, v);
      all_bg &= (uint8_t)((v == 0.f) | (v == 1.f));
    }
    fmax[r][c] = m;
    // out-of-range cells loaded as 0, so they read as background here
    fbg[r][c] = all_bg;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kTileT * kTileF; i += kThreads) {
    const int r = i / kTileF, c = i % kTileF;  // a warp = 32 bins of one row
    const int t = t0 + r, f = f0 + c;
    float m = fmax[r][c];
    uint8_t eroded = has_bg ? fbg[r][c] : 0;
#pragma unroll
    for (int d = 1; d <= 2 * kRadius; ++d) {
      m = fmaxf(m, fmax[r + d][c]);
      if (has_bg) eroded &= fbg[r + d][c];
    }
    const float p = tile[r + kRadius][c + kRadius];
    const bool local_max = (m == p);
    const bool hit = (local_max != (bool)eroded) && (p >= threshold) &&
                     (f < shz::kBins) && (t < n_frames);
    const uint32_t word = __ballot_sync(0xffffffffu, hit);
    const int w = f >> 5;
    if (lane == 0 && t < n_frames && w < shz::kMaskWords)
      bits[((int64_t)b * n_frames + t) * shz::kMaskWords + w] = word;
  }
}

}  // namespace

SHZ_EXPORT int shz_peak_mask(const float* power, int batch, int n_frames,
                             float threshold, unsigned int* bits,
                             void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  const dim3 grid((shz::kBins + kTileF - 1) / kTileF,
                  (n_frames + kTileT - 1) / kTileT, batch);
  peak_mask_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      power, n_frames, threshold, bits);
  return (int)cudaGetLastError();
}
