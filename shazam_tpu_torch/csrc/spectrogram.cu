// K1: samples -> one-sided PSD power spectrogram, a Stockham FFT in
// registers, 128 threads per frame.
//
// Replaces the Pallas kernel shazam_tpu/ops/pallas/spectrogram.py
// (_kernel + _compute_tile, called at :312). The TPU version runs the
// 4096-point DFT as two f32 matmul stages on the MXU and emits a twisted,
// freq-haloed layout. Here a group of 128 threads owns one 50%-overlap
// frame and computes, in float64:
//
//   z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1]   (real 4096 -> complex 2048)
//   Z    = FFT_2048(z)                        (Stockham, radix 16, 16, 8)
//   X[k] = E[k] + W_4096^k O[k],  X[2048-k] = conj(E[k] - W_4096^k O[k]),
//          E/O split from Z[k] and conj(Z[2048-k]), k = 0..1024
//
// then writes |X[k]|^2 times the mlab one-sided PSD scale for k in
// [0, 2048] into a dense (B, T, 2049) f32 array, the layout the peak
// kernel (peaks.cu) reads. Frames >= n_valid_frames[b] are written as
// exact zeros and skip the FFT.
//
// Precision: the window, FFT and PSD scale run in float64 (the
// reference's own mlab precision) and round to f32 once, at the store.
// An f32 FFT strays far from float64 on a frame's deepest bins: the
// earlier radix-2 kernel built in f32 was 19.6 dB off its float64 twin on
// one of 8 x 30 s synthetic songs (H100 80GB HBM3, 700 W), the f32
// torch.fft.rfft as far, while bins above -20 dB stayed within 0.007 dB.
// In float64 the kernel and its twin agree to f32 rounding, so CPU and
// CUDA fingerprints are identical. Never bf16/TF32 (bf16 DFT products
// reordered near-tied constellation peaks in the JAX package).
//
// Bound, counted from the shapes with each input byte read once and each
// output byte written once: at the ingest shape (8 x 1,572,864 samples,
// 767 frames a row) 50.3 MB of samples in and 50.3 MB of power out, 30 us
// at 3.35 TB/s; about 162 kflop per valid frame (window, a 5 N log2 N
// complex FFT of N = 2048, split, power and scale), about 1.0 GFLOP, 29 us
// at the H100's 34 TFLOP/s float64 vector rate. Bytes and operations bind
// about equally, so the design keeps both near one pass:
//
// - Three radix passes, in registers. The 2048-point FFT is a Stockham
//   autosort of 16 x 16 x 8: each thread holds one radix-16 butterfly (or
//   two radix-8 ones) as 16 double2 in registers and does it as 4 x 4
//   (4 x 2) with constant inner twiddles. Shared memory is touched only
//   at the two exchanges between passes and the final split, about
//   128 KB a frame against the radix-2 kernel's 704 KB over 11 passes,
//   and there is no bit-reversal scatter: the autosort leaves Z in order.
// - No bank conflicts. Real and imaginary parts live in separate double
//   arrays with one pad slot after every 16 (index i -> i + i/16), so
//   every exchange of a half-warp hits 16 distinct 8-byte banks, the
//   2-wavefront minimum for a warp of doubles (the split's descending
//   reads conflict 2-way in one bank).
// - Twiddles and window from small f64 tables (window 32 KB, twiddles
//   64 KB, L1/L2 resident), read with __ldg: pass 2 and pass 3 tables are
//   laid out [r][k], so a warp reads consecutive 16-byte entries. The
//   window is np.hanning's values, read once per sample as a double2.
// - Samples load as 8-byte float2 pairs, z[m] = (x[2m], x[2m+1]) with
//   m = j + 128 r: a warp reads 256 contiguous bytes per load, fully
//   coalesced (16-byte loads would need a transposed first pass).
// - Each frame's 128 threads meet at named barriers of their own
//   (bar.sync id, 128), 5 per frame; a block holds kFramesPerBlock frames
//   in 2 x 2176 doubles each of dynamic shared memory, so a finished or
//   zero frame never waits for its neighbour and the ragged last block
//   just drops its missing frames. The load -> barrier -> store exchange
//   reuses one buffer (69,632 bytes a block), so two blocks, 4 frames,
//   fit an SM, as many as 128 registers a thread allow; a ping-pong pair
//   (3 barriers) would fit 2. Capped at 80 registers for 3 blocks an SM,
//   ptxas spilled 128 bytes and the kernel ran 15 % slower (H100 80GB
//   HBM3, 700 W).
//
// No tensor cores: f32, TF32 and bf16 are excluded by the precision
// decision above, the f64 mma.sync (DMMA) runs at only twice the f64
// vector rate, and a DFT as matmuls (2048 = 32 x 64, four-step) needs
// about 14x the flops of the radix FFT, so it could not come out ahead.
#include "common.cuh"

namespace {

constexpr int kHalf = shz::kWindow / 2;           // complex FFT length, 2048
constexpr int kFrameThreads = 128;                // one radix-16 butterfly each
constexpr int kFramesPerBlock = 2;
constexpr int kThreads = kFrameThreads * kFramesPerBlock;
constexpr int kPadded = kHalf + kHalf / 16;       // 2176 doubles, see pad()
constexpr int kSmemBytes = 2 * kPadded * kFramesPerBlock * (int)sizeof(double);
// the packed twiddle table (double2 entries): W_4096^k for k = 0..2048,
// then pass 2's W_256^(k r) as [r - 1][k], k < 16, then pass 3's
// W_2048^(k r) as [r - 1][k], k < 256
constexpr int kTwPass2 = kHalf + 1;
constexpr int kTwPass3 = kTwPass2 + 15 * 16;

constexpr double kSqrtHalf = 0.70710678118654752440;
constexpr double kCos8 = 0.92387953251128675613;  // cos(pi / 8)
constexpr double kSin8 = 0.38268343236508977173;  // sin(pi / 8)

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ double2 mul_neg_i(double2 a) {  // -i a
  return make_double2(a.y, -a.x);
}

// forward DFT of 4 in place, outputs in natural order
__device__ __forceinline__ void dft4(double2& a0, double2& a1, double2& a2,
                                     double2& a3) {
  const double2 s02 = cadd(a0, a2), d02 = csub(a0, a2);
  const double2 s13 = cadd(a1, a3), d13 = mul_neg_i(csub(a1, a3));
  a0 = cadd(s02, s13);
  a1 = cadd(d02, d13);
  a2 = csub(s02, s13);
  a3 = csub(d02, d13);
}

// x * W_16^e for a compile-time e in [0, 9] (after unrolling)
__device__ __forceinline__ double2 mul_w16(double2 x, int e) {
  switch (e) {
    case 0: return x;
    case 1: return cmul(x, make_double2(kCos8, -kSin8));
    case 2: return cmul(x, make_double2(kSqrtHalf, -kSqrtHalf));
    case 3: return cmul(x, make_double2(kSin8, -kCos8));
    case 4: return mul_neg_i(x);
    case 6: return cmul(x, make_double2(-kSqrtHalf, -kSqrtHalf));
    default: return cmul(x, make_double2(-kCos8, kSin8));  // e = 9
  }
}

// forward DFT of 16 in registers as 4 x 4: n = n1 + 4 n2, k = k2 + 4 k1,
// X[k2 + 4 k1] = sum_n1 W_4^(n1 k1) W_16^(n1 k2) DFT4_n2(x[n1 + 4 n2])[k2]
__device__ __forceinline__ void dft16(double2 (&v)[16]) {
#pragma unroll
  for (int n1 = 0; n1 < 4; ++n1) dft4(v[n1], v[n1 + 4], v[n1 + 8], v[n1 + 12]);
#pragma unroll
  for (int n1 = 1; n1 < 4; ++n1)
#pragma unroll
    for (int k2 = 1; k2 < 4; ++k2) v[n1 + 4 * k2] = mul_w16(v[n1 + 4 * k2], n1 * k2);
#pragma unroll
  for (int k2 = 0; k2 < 4; ++k2)
    dft4(v[4 * k2], v[4 * k2 + 1], v[4 * k2 + 2], v[4 * k2 + 3]);
  double2 t[16];  // v[4 k2 + k1] holds X[k2 + 4 k1]: transpose
#pragma unroll
  for (int k = 0; k < 16; ++k) t[k] = v[4 * (k & 3) + (k >> 2)];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = t[k];
}

// forward DFT of 8 in registers as 2 x 4: n = n1 + 2 n2, k = k2 + 4 k1
__device__ __forceinline__ void dft8(double2 (&v)[8]) {
  dft4(v[0], v[2], v[4], v[6]);
  dft4(v[1], v[3], v[5], v[7]);
  v[3] = cmul(v[3], make_double2(kSqrtHalf, -kSqrtHalf));    // W_8^1
  v[5] = mul_neg_i(v[5]);                                    // W_8^2
  v[7] = cmul(v[7], make_double2(-kSqrtHalf, -kSqrtHalf));   // W_8^3
  double2 t[8];  // v[2 k2 + k1] holds X[k2 + 4 k1] after the radix-2s
#pragma unroll
  for (int k2 = 0; k2 < 4; ++k2) {
    t[k2] = cadd(v[2 * k2], v[2 * k2 + 1]);
    t[k2 + 4] = csub(v[2 * k2], v[2 * k2 + 1]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = t[k];
}

__device__ __forceinline__ void frame_sync(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(kFrameThreads)
               : "memory");
}

__device__ __forceinline__ double2 lds(const double* re, const double* im,
                                       int i) {
  return make_double2(re[pad(i)], im[pad(i)]);
}
__device__ __forceinline__ void sts(double* re, double* im, int i, double2 v) {
  re[pad(i)] = v.x;
  im[pad(i)] = v.y;
}

__global__ void __launch_bounds__(kThreads, 2) spectrogram_power_kernel(
    const float* __restrict__ samples, int64_t n_samples, bool pair_loads,
    const int32_t* __restrict__ n_valid_frames, int n_frames, int hop,
    const double2* __restrict__ window,   // (2048,) np.hanning(4096) pairs
    const double2* __restrict__ twiddle,  // packed, see kTwPass2/kTwPass3
    double scale_edge, double scale_mid,  // PSD scale at k in {0, 2048} / else
    float* __restrict__ out) {            // (B, T, 2049)
  extern __shared__ double smem[];
  const int group = threadIdx.x / kFrameThreads;
  const int j = threadIdx.x % kFrameThreads;
  const int t = blockIdx.x * kFramesPerBlock + group;
  const int b = blockIdx.y;
  if (t >= n_frames) return;  // ragged last block
  float* row = out + ((int64_t)b * n_frames + t) * shz::kBins;
  if (t >= n_valid_frames[b]) {  // pad-to-bucket frames are exact zeros
    for (int k = j; k < shz::kBins; k += kFrameThreads) row[k] = 0.f;
    return;
  }
  double* re = smem + group * 2 * kPadded;
  double* im = re + kPadded;
  const float* x = samples + (int64_t)b * n_samples + (int64_t)t * hop;

  // pass 1 (Ns = 1, radix 16): z[j + 128 r], windowed, straight from HBM
  double2 v[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int m = j + 128 * r;
    const float2 s = pair_loads
        ? __ldg(reinterpret_cast<const float2*>(x) + m)
        : make_float2(__ldg(x + 2 * m), __ldg(x + 2 * m + 1));
    const double2 w = __ldg(window + m);
    v[r] = make_double2((double)s.x * w.x, (double)s.y * w.y);
  }
  dft16(v);
#pragma unroll
  for (int r = 0; r < 16; ++r) sts(re, im, 16 * j + r, v[r]);
  frame_sync(group);

  // pass 2 (Ns = 16, radix 16)
#pragma unroll
  for (int r = 0; r < 16; ++r) v[r] = lds(re, im, j + 128 * r);
  frame_sync(group);  // every read is in before any write
  {
    const int k = j & 15;
#pragma unroll
    for (int r = 1; r < 16; ++r)
      v[r] = cmul(v[r], __ldg(twiddle + kTwPass2 + 16 * (r - 1) + k));
    dft16(v);
    const int base = (j >> 4) * 256 + k;
#pragma unroll
    for (int r = 0; r < 16; ++r) sts(re, im, base + 16 * r, v[r]);
  }
  frame_sync(group);

  // pass 3 (Ns = 256, radix 8): items j and j + 128
  double2 u[2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 8; ++r) u[h][r] = lds(re, im, j + 128 * h + 256 * r);
  frame_sync(group);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = j + 128 * h;
#pragma unroll
    for (int r = 1; r < 8; ++r)
      u[h][r] = cmul(u[h][r], __ldg(twiddle + kTwPass3 + 256 * (r - 1) + k));
    dft8(u[h]);
#pragma unroll
    for (int r = 0; r < 8; ++r) sts(re, im, k + 256 * r, u[h][r]);
  }
  frame_sync(group);

  // split: X[k] and X[2048 - k] from the pair Z[k], Z[2048 - k]
  for (int k = j; k <= kHalf / 2; k += kFrameThreads) {
    const double2 zk = lds(re, im, k);
    const double2 zc = lds(re, im, (kHalf - k) & (kHalf - 1));  // conj below
    // E = (Z[k] + conj Z[N/2-k]) / 2 ; O = (Z[k] - conj Z[N/2-k]) / 2i
    const double2 e = make_double2(0.5 * (zk.x + zc.x), 0.5 * (zk.y - zc.y));
    const double2 o = make_double2(0.5 * (zk.y + zc.y), -0.5 * (zk.x - zc.x));
    const double2 wo = cmul(__ldg(twiddle + k), o);
    const double2 lo = cadd(e, wo), hi = csub(e, wo);
    row[k] = (float)((lo.x * lo.x + lo.y * lo.y) *
                     (k == 0 ? scale_edge : scale_mid));
    if (k != kHalf / 2)
      row[kHalf - k] = (float)((hi.x * hi.x + hi.y * hi.y) *
                               (k == 0 ? scale_edge : scale_mid));
  }
}

}  // namespace

SHZ_EXPORT int shz_spectrogram_power(
    const float* samples, long long n_samples, const int* n_valid_frames,
    int batch, int n_frames, int hop, const double* window,
    const double* twiddle, double scale_edge, double scale_mid, float* out,
    void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static unsigned long long smem_set = 0;  // one bit per device
  if (dev < 64 && !((smem_set >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(spectrogram_power_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    smem_set |= 1ull << dev;
  }
  // float2 sample pairs need every frame start 8-byte aligned
  const bool pair_loads = ((uintptr_t)samples % 8 == 0) &&
                          n_samples % 2 == 0 && hop % 2 == 0;
  const dim3 grid((n_frames + kFramesPerBlock - 1) / kFramesPerBlock, batch);
  spectrogram_power_kernel<<<grid, kThreads, kSmemBytes,
                             (cudaStream_t)stream>>>(
      samples, n_samples, pair_loads, n_valid_frames, n_frames, hop,
      reinterpret_cast<const double2*>(window),
      reinterpret_cast<const double2*>(twiddle), scale_edge, scale_mid, out);
  return (int)cudaGetLastError();
}

SHZ_EXPORT const char* shz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
