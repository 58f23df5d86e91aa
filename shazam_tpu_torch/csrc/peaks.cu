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
//               (power 1 is dB 0; out-of-range cells count as background)
//   mask      = (local_max != eroded) & (p >= power_threshold) & (f < 2049)
//
// The erosion is never computed: its window holds its own centre, so
// eroded implies p is 0 or 1, while the gate (amp_min > 0, which the
// wrapper enforces) is above power 1. Wherever the gate holds, eroded is
// false and mask = local_max & gate; elsewhere the gate clears the mask.
// Out-of-range cells load as 0: power is non-negative, so a zero pad
// leaves every window max unchanged (the window holds its own centre). The
// mask leaves as one 32-bit ballot word per warp: (B, T, 65) words, bit j
// of word w = bin 32 w + j. There is no per-group cap, so no overflow to
// report.
//
// Bound: the card's memory (one read of the spectrum, 1/32 of it
// written). Reading every window cell from shared memory, one by one,
// took ~90 shared-memory instructions per cell. Both passes run in
// registers instead: a thread takes 28 consecutive values (seven 16-byte
// loads along freq, 28 scalar loads along time) and forms the 8 window
// maxima they cover with 33 fmaxf (window_max8), about 10 shared-memory
// instructions per cell. The fill makes 36 x 148 scalar loads per
// 16 x 128 tile, 2.6 times the tile, the halo mostly from L2.
#include "common.cuh"

namespace {

constexpr int kRadius = 10;
constexpr int kWidth = 2 * kRadius + 1;         // 21
constexpr int kTileT = 16;
constexpr int kTileF = 128;
constexpr int kRowsH = kTileT + 2 * kRadius;   // 36
constexpr int kColsH = kTileF + 2 * kRadius;   // 148, a multiple of 4
constexpr int kThreads = 256;
constexpr int kSeg = 8;                         // windows per thread task
constexpr int kSpan = kSeg + kWidth - 1;        // 28 values they cover
// fmax's pitch: 132 = 4 mod 32 words puts 8 consecutive rows' 16-byte
// stores in 8 distinct bank quads (a pitch of 128 would put them in one)
constexpr int kPitchM = kTileF + 4;
constexpr int kFill = (kRowsH * kColsH + kThreads - 1) / kThreads;  // 21

static_assert(kColsH % 4 == 0 && kPitchM % 4 == 0, "16-byte rows");
static_assert(kTileF % kSeg == 0 && kTileT % kSeg == 0, "whole segments");
static_assert(kTileF * (kTileT / kSeg) == kThreads, "one time task each");
static_assert(kThreads / kColsH == 1, "the fill steps one or two rows");

// out[j] = max(x[j .. j + 20]) for j = 0..7. Every window holds the core
// x[7 .. 20]; window j adds the suffix x[j .. 6] and the prefix
// x[21 .. 20 + j]. 33 fmaxf for the 8 windows (168 one by one).
__device__ __forceinline__ void window_max8(const float (&x)[kSpan],
                                            float (&out)[kSeg]) {
  float m = x[kSeg - 1];
#pragma unroll
  for (int k = kSeg; k < kWidth; ++k) m = fmaxf(m, x[k]);
  out[kSeg - 1] = m;
#pragma unroll
  for (int j = kSeg - 2; j >= 0; --j) out[j] = fmaxf(out[j + 1], x[j]);
  m = x[kWidth];
#pragma unroll
  for (int j = 1; j < kSeg; ++j) {
    out[j] = fmaxf(out[j], m);
    if (j + 1 < kSeg) m = fmaxf(m, x[kWidth + j]);
  }
}

__global__ void __launch_bounds__(kThreads) peak_mask_kernel(
    const float* __restrict__ power,   // (B, T, 2049)
    int n_frames, float threshold,
    uint32_t* __restrict__ bits) {     // (B, T, 65)
  __shared__ __align__(16) float tile[kRowsH][kColsH];
  __shared__ __align__(16) float fmax[kRowsH][kPitchM];

  const int f0 = blockIdx.x * kTileF;
  const int t0 = blockIdx.y * kTileT;
  const int b = blockIdx.z;
  const float* spec = power + (int64_t)b * n_frames * shz::kBins;

  // fill: a thread takes halo cells threadIdx.x + 256 k, k < 21, and
  // puts all its loads in flight before its stores; its cell (fr, fc)
  // steps by 256 = 1 row + 108 columns instead of a division per cell.
  float v[kFill];
  int fr = threadIdx.x / kColsH, fc = threadIdx.x % kColsH;
#pragma unroll
  for (int k = 0; k < kFill; ++k) {
    const int t = t0 + fr - kRadius, f = f0 + fc - kRadius;
    v[k] = (fr < kRowsH && t >= 0 && t < n_frames && f >= 0 &&
            f < shz::kBins)
               ? spec[(int64_t)t * shz::kBins + f] : 0.f;
    fc += kThreads % kColsH;
    fr += kThreads / kColsH;
    if (fc >= kColsH) {
      fc -= kColsH;
      ++fr;
    }
  }
  float* flat = &tile[0][0];
#pragma unroll
  for (int k = 0; k < kFill; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < kRowsH * kColsH) flat[i] = v[k];
  }
  __syncthreads();

  // freq pass: fmax[r][c] = max(tile[r][c .. c + 20]). A task is 8
  // columns of one halo row; consecutive threads take consecutive rows,
  // whose 16-byte reads (148 = 20 mod 32 words apart) hit distinct banks.
  for (int i = threadIdx.x; i < kRowsH * (kTileF / kSeg); i += kThreads) {
    const int r = i % kRowsH, c = (i / kRowsH) * kSeg;
    const float4* src = reinterpret_cast<const float4*>(&tile[r][c]);
    float x[kSpan];
#pragma unroll
    for (int k = 0; k < kSpan / 4; ++k) {
      const float4 q = src[k];
      x[4 * k] = q.x;
      x[4 * k + 1] = q.y;
      x[4 * k + 2] = q.z;
      x[4 * k + 3] = q.w;
    }
    float m[kSeg];
    window_max8(x, m);
    float4* dst = reinterpret_cast<float4*>(&fmax[r][c]);
    dst[0] = make_float4(m[0], m[1], m[2], m[3]);
    dst[1] = make_float4(m[4], m[5], m[6], m[7]);
  }
  __syncthreads();

  // time pass: a thread takes column c of output rows r0 .. r0 + 7 (a warp
  // = 32 consecutive columns, conflict-free), gates each and ballots it
  const int lane = threadIdx.x & 31;
  const int c = threadIdx.x % kTileF, r0 = (threadIdx.x / kTileF) * kSeg;
  const int f = f0 + c;
  float x[kSpan];
#pragma unroll
  for (int k = 0; k < kSpan; ++k) x[k] = fmax[r0 + k][c];
  float m[kSeg];
  window_max8(x, m);
  const int w = f >> 5;
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    const int t = t0 + r0 + j;
    const float p = tile[r0 + j + kRadius][c + kRadius];
    const bool hit = (m[j] == p) && (p >= threshold) && (f < shz::kBins) &&
                     (t < n_frames);
    const uint32_t word = __ballot_sync(0xffffffffu, hit);
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
