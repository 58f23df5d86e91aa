// K3: bit-packed peak mask -> (t, f)-ordered peak list per song.
//
// Replaces the Pallas kernel shazam_tpu/ops/pallas/compact.py
// (_ff_kernel + _tile_segment). The TPU version ranks candidates with
// sublane roll-adds, places them with an f32 one-hot matmul scatter (and
// patches its 2^24 exactness limit), and walks the tiles in grid order
// with a running cursor. Blocks on the card run in no order, so each song
// is spread over many blocks joined by a single-pass decoupled look-back
// scan (Merrill & Garland):
//
//   1. a block takes a ticket from a global counter (not blockIdx), so
//      every tile it waits on below has already been scheduled; ticket i
//      is tile j = i % tiles of song b = i / tiles, frames [jF, jF + F)
//      with F = kTile = 16;
//   2. the tile's F x 65 mask words, contiguous, come into shared memory
//      with 16-byte loads (scalar loads for an unaligned head and tail);
//   3. one warp per frame popcounts its 65 words (lane l: words l, 32 + l
//      and, on lane 0, word 64); one warp scan of both 32-word halves
//      packed in 16-bit fields gives every word its offset in the frame,
//      and a scan of the F frame totals gives the tile's aggregate;
//   4. warp 0 publishes {epoch, AGGREGATE, aggregate} in the tile's status
//      word (the song's first tile publishes its PREFIX at once), then
//      reads back 32 predecessors at a time, summing aggregates until it
//      meets an inclusive PREFIX, and publishes its own prefix;
//   5. each lane writes its words' set bits in ascending bin order to
//      slots excl + offset + rank, skipping slots >= capacity. The song's
//      last tile writes the exact count to n_peaks;
//   6. [min(n, capacity), capacity) is zeroed with 16-byte stores by
//      extra blocks, one per kFillSlots slots of a row, which take the
//      last tickets. Each finds n with the same look-back, from a tile
//      just past the song's last, so the fill runs beside the scan instead
//      of after it (on an H100 the song's last tile alone added about
//      2 us at the ingest shape, zeroing ~120 KB per song).
//
// Status words are 64-bit: epoch << 32 | flag << 30 | value (a song holds
// at most 2^30 - 1 peaks; the wrapper checks T * 2049 fits). The epoch is
// a per-call number from the wrapper, so words of earlier calls read as
// "not yet published" and the scratch needs no memset per call; the
// ticket counter runs on across calls and the wrapper passes the count it
// had before this launch (so a launch must not be replayed from a CUDA
// graph). The wrapper owns the scratch: scratch[0] holds the ticket and
// scratch[1 + i] tile i's status word.
//
// Bound: bytes (one read of the mask, the (B, capacity) outputs written
// once), under a microsecond at the main path's shapes. A launch drains
// in a few microseconds, so what this kernel can win is latency: all SMs
// instead of one per song, one coalesced load per tile, a look-back that
// costs one L2 round trip when the predecessors are done, and a tail fill
// off the scan's path.
#include <cuda/atomic>

#include "common.cuh"

namespace {

constexpr int kTile = 16;          // F: frames per block, one warp each
constexpr int kThreads = kTile * 32;
constexpr int kFillSlots = 2048;   // output slots per fill block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFlagShift = 30;
constexpr unsigned long long kAggregate = 1ull;
constexpr unsigned long long kPrefix = 2ull;
constexpr unsigned kValueMask = (1u << kFlagShift) - 1;

using Status = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

__device__ __forceinline__ unsigned long long pack(unsigned epoch,
                                                   unsigned long long flag,
                                                   int value) {
  return (unsigned long long)epoch << 32 | flag << kFlagShift |
         (unsigned)value;
}

__device__ __forceinline__ unsigned warp_inclusive_scan(unsigned v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Sum of the song's peaks before tile j (0 < j <= tiles; j = tiles gives
// the song's count), read from the status words of tiles j - 1, j - 2, ...
// (lane l reads tile k - l). Every one of them holds a ticket below this
// block's and publishes its aggregate without waiting on anything, so the
// spin ends.
__device__ int look_back(unsigned long long* status, int j, unsigned epoch,
                         int lane) {
  int excl = 0;
  unsigned stop = 0;
  for (int k = j - 1; !stop; k -= 32) {
    const int idx = k - lane;
    unsigned long long s = 0;
    unsigned need;
    for (unsigned ns = 32;; ns = min(2 * ns, 128u)) {
      bool ready = true, prefix = true;  // lanes before tile 0 add nothing
      if (idx >= 0) {
        s = Status(status[idx]).load(cuda::memory_order_acquire);
        ready = (unsigned)(s >> 32) == epoch;
        prefix = ready && (s >> kFlagShift & 3) == kPrefix;
      }
      const unsigned got = __ballot_sync(kFull, ready);
      stop = __ballot_sync(kFull, prefix);
      // lanes up to the nearest prefix (all 32 if none) must be ready
      need = stop ? ((stop & (0u - stop)) << 1) - 1 : kFull;
      if ((got & need) == need) break;
      __nanosleep(ns);
    }
    excl += warp_sum(need >> lane & 1 ? (int)(s & kValueMask) : 0);
  }
  return excl;
}

// Zero p[0, n) with 16-byte stores on the aligned middle.
__device__ __forceinline__ void zero_range(int32_t* p, int n, int tid,
                                           int n_threads) {
  const int head = min((int)((0u - (unsigned)((uintptr_t)p >> 2)) & 3u), n);
  int4* v = reinterpret_cast<int4*>(p + head);
  const int n_vec = (n - head) >> 2;
  const int tail = head + 4 * n_vec;
  if (tid < head) p[tid] = 0;
  if (tid < n - tail) p[tail + tid] = 0;
  for (int i = tid; i < n_vec; i += n_threads) v[i] = make_int4(0, 0, 0, 0);
}

// Writes a mask word's set bits, ascending, to slots pos, pos + 1, ...
__device__ __forceinline__ void write_bits(uint32_t word, int pos, int t,
                                           int bin0, int capacity,
                                           int32_t* out_t, int32_t* out_f) {
  for (; word && pos < capacity; ++pos) {
    out_t[pos] = t;
    out_f[pos] = bin0 + __ffs(word) - 1;
    word &= word - 1;
  }
}

// A fill block: zeroes slots [max(n, c * kFillSlots), (c + 1) *
// kFillSlots) of song b's rows, n from a look-back past the song's last
// tile.
__device__ void fill_chunk(int b, int c, int tiles, int capacity,
                           int32_t* times, int32_t* freqs,
                           unsigned long long* status, unsigned epoch,
                           int* s_n, int tid) {
  if (tid < 32) {
    const int n = look_back(status + (int64_t)b * tiles, tiles, epoch, tid);
    if (tid == 0) *s_n = n;
  }
  __syncthreads();
  const int lo = max(*s_n, c * kFillSlots);
  const int hi = min(capacity, (c + 1) * kFillSlots);
  if (lo < hi) {
    zero_range(times + (int64_t)b * capacity + lo, hi - lo, tid, kThreads);
    zero_range(freqs + (int64_t)b * capacity + lo, hi - lo, tid, kThreads);
  }
}

__global__ void __launch_bounds__(kThreads) compact_kernel(
    const uint32_t* __restrict__ bits,  // (B, T, 65)
    int n_frames, int tiles, int batch_tiles, int capacity,
    int32_t* __restrict__ times,        // (B, capacity)
    int32_t* __restrict__ freqs,        // (B, capacity)
    int32_t* __restrict__ n_peaks,      // (B,)
    unsigned long long* __restrict__ scratch, unsigned ticket_base,
    unsigned epoch, int fill_blocks) {
  constexpr int F = kTile;
  constexpr int kWords = F * shz::kMaskWords;
  // the tile's words, shifted by their 16-byte misalignment (0-3 words)
  __shared__ __align__(16) uint32_t words[kWords + 4];
  __shared__ int frame_off[F];
  __shared__ int s_tile, s_total;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0)
    s_tile = (int)(atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u) -
                   ticket_base);
  __syncthreads();
  const int tile = s_tile;
  if (tile >= batch_tiles) {  // past the tiles: a fill block
    const int f = tile - batch_tiles;
    const int b = f / fill_blocks;
    fill_chunk(b, f - b * fill_blocks, tiles, capacity, times, freqs,
               scratch + 1, epoch, &s_total, tid);
    return;
  }
  const int b = tile / tiles;
  const int j = tile - b * tiles;
  const int t0 = j * F;
  const int frames = min(F, n_frames - t0);

  const uint32_t* p0 = bits + ((int64_t)b * n_frames + t0) * shz::kMaskWords;
  const uint32_t* p1 = p0 + frames * shz::kMaskWords;
  const int shift = (int)((uintptr_t)p0 >> 2 & 3);
  const uint32_t* a0 = p0 - shift;  // words[i] holds a0[i]
  const uint4* v0 = reinterpret_cast<const uint4*>(a0 + (shift ? 4 : 0));
  const uint4* v1 =
      reinterpret_cast<const uint4*>((uintptr_t)p1 & ~(uintptr_t)15);
  for (const uint4* v = v0 + tid; v < v1; v += kThreads) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(v);
    *reinterpret_cast<uint4*>(words + (w - a0)) = __ldg(v);
  }
  if (tid < 4) {  // head [p0, v0) and tail [v1, p1): at most 3 words each
    const uint32_t* h = p0 + tid;
    if (h < reinterpret_cast<const uint32_t*>(v0)) words[h - a0] = __ldg(h);
    const uint32_t* e = reinterpret_cast<const uint32_t*>(v1) + tid;
    if (e < p1) words[e - a0] = __ldg(e);
  }
  __syncthreads();

  uint32_t wa = 0, wb = 0, wc = 0;  // words lane, 32 + lane, 64 (lane 0)
  if (warp < frames) {
    const uint32_t* row = words + shift + warp * shz::kMaskWords;
    wa = row[lane];
    wb = row[32 + lane];
    if (lane == 0) wc = row[64];
  }
  const int pa = __popc(wa), pb = __popc(wb);
  // both halves in one scan: each field sums to at most 1024 < 2^16
  const unsigned incl = warp_inclusive_scan(pa | pb << 16, lane);
  const unsigned tot = __shfl_sync(kFull, incl, 31);
  const int tot_a = tot & 0xffff, tot_b = tot >> 16;
  if (lane == 0) frame_off[warp] = tot_a + tot_b + __popc(wc);
  __syncthreads();

  if (warp == 0) {
    const int count = lane < F ? frame_off[lane] : 0;
    const int incl_f = (int)warp_inclusive_scan(count, lane);
    const int agg = __shfl_sync(kFull, incl_f, 31);
    unsigned long long* status = scratch + 1 + (int64_t)b * tiles;
    if (lane == 0)
      Status(status[j]).store(pack(epoch, j ? kAggregate : kPrefix, agg),
                              cuda::memory_order_release);
    const int excl = j ? look_back(status, j, epoch, lane) : 0;
    if (lane == 0 && j)
      Status(status[j]).store(pack(epoch, kPrefix, excl + agg),
                              cuda::memory_order_release);
    if (lane < F) frame_off[lane] = excl + incl_f - count;
    if (lane == 0) s_total = excl + agg;
  }
  __syncthreads();

  int32_t* out_t = times + (int64_t)b * capacity;
  int32_t* out_f = freqs + (int64_t)b * capacity;
  if (warp < frames) {
    const int t = t0 + warp;
    const int base = frame_off[warp];
    write_bits(wa, base + (int)(incl & 0xffff) - pa, t, 32 * lane, capacity,
               out_t, out_f);
    write_bits(wb, base + tot_a + (int)(incl >> 16) - pb, t, 32 * (32 + lane),
               capacity, out_t, out_f);
    if (lane == 0)
      write_bits(wc, base + tot_a + tot_b, t, 2048, capacity, out_t, out_f);
  }
  if (j == tiles - 1 && tid == 0) n_peaks[b] = s_total;  // the song's count
}

// T = 0: no tiles, but every song still gets n_peaks = 0 and zeroed rows.
__global__ void __launch_bounds__(256) empty_kernel(
    int capacity, int32_t* __restrict__ times, int32_t* __restrict__ freqs,
    int32_t* __restrict__ n_peaks) {
  const int b = blockIdx.x;
  if (threadIdx.x == 0) n_peaks[b] = 0;
  zero_range(times + (int64_t)b * capacity, capacity, threadIdx.x, 256);
  zero_range(freqs + (int64_t)b * capacity, capacity, threadIdx.x, 256);
}

}  // namespace

// A launch takes batch * (ceil(n_frames / kTile) + ceil(capacity /
// kFillSlots)) tickets (the wrapper mirrors both constants), and the
// wrapper sized the scratch for batch * ceil(n_frames / kTile) status
// words past the ticket.
SHZ_EXPORT int shz_compact(const unsigned int* bits, int batch, int n_frames,
                           int capacity, int* times, int* freqs, int* n_peaks,
                           unsigned long long* scratch,
                           unsigned int ticket_base, unsigned int epoch,
                           void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_frames == 0) {
    empty_kernel<<<batch, 256, 0, s>>>(capacity, times, freqs, n_peaks);
    return (int)cudaGetLastError();
  }
  const int tiles = (n_frames + kTile - 1) / kTile;
  const int fill_blocks = (capacity + kFillSlots - 1) / kFillSlots;
  compact_kernel<<<batch * (tiles + fill_blocks), kThreads, 0, s>>>(
      bits, n_frames, tiles, batch * tiles, capacity, times, freqs, n_peaks,
      scratch, ticket_base, epoch, fill_blocks);
  return (int)cudaGetLastError();
}
