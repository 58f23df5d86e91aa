// K1: samples -> one-sided PSD power spectrogram, one block per frame.
//
// Replaces the Pallas kernel shazam_tpu/ops/pallas/spectrogram.py
// (_kernel + _compute_tile). The TPU version runs the 4096-point DFT as
// two f32 matmul stages on the MXU and emits a twisted, freq-haloed
// layout; here each block loads one 50%-overlap frame, applies the Hann
// window, and runs an in-shared-memory radix-2 FFT:
//
//   z[n] = x[2n] + i x[2n+1]                (real 4096 -> complex 2048)
//   Z    = FFT_2048(z)                      (11 radix-2 DIT stages)
//   X[k] = E[k] + W_4096^k O[k],  E/O split from Z[k] and conj(Z[2048-k])
//
// then writes |X[k]|^2 times the mlab one-sided PSD scale for k in
// [0, 2048] into a dense (B, T, 2049) f32 array, the layout the peak
// kernel (peaks.cu) reads. Frames >= n_valid_frames[b] are written as
// exact zeros.
//
// Precision: the window, FFT and PSD scale run in float64 (the
// reference's own mlab precision) and round to f32 once, at the store.
// An f32 FFT strays far from float64 on a frame's deepest bins: this
// kernel built in f32 was 19.6 dB off its float64 twin on one of 8 x 30 s
// synthetic songs and 0.04 dB on a 5 s clip (H100 80GB HBM3, 700 W), the
// f32 torch.fft.rfft as far, while bins above -20 dB stayed within
// 0.007 dB. In float64 the kernel and its twin agree to f32 rounding,
// so CPU and CUDA fingerprints are identical. Never bf16/TF32 (bf16 DFT
// products reordered near-tied constellation peaks in the JAX package).
//
// Bound: each frame reads 16 KB of samples and writes 8 KB; the FFT is
// ~10 flops per sample per stage in shared memory (f64 runs at half the
// f32 rate), so the kernel is latency/shared-memory bound at these
// sizes rather than DRAM bound.
#include "common.cuh"

namespace {

constexpr int kHalf = shz::kWindow / 2;  // complex FFT length
constexpr int kLogHalf = 11;
constexpr int kThreads = 512;

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__global__ void __launch_bounds__(kThreads) spectrogram_power_kernel(
    const float* __restrict__ samples, int64_t n_samples,
    const int32_t* __restrict__ n_valid_frames, int n_frames, int hop,
    const double* __restrict__ window,    // (4096,)
    const double2* __restrict__ twiddle,  // (2049,) W_4096^k = (cos, -sin)
    double scale_edge, double scale_mid,  // PSD scale at k in {0, 2048} / else
    float* __restrict__ out) {            // (B, T, 2049)
  __shared__ double2 z[kHalf];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  float* row = out + ((int64_t)b * n_frames + t) * shz::kBins;
  if (t >= n_valid_frames[b]) {  // pad-to-bucket frames are exact zeros
    for (int k = threadIdx.x; k < shz::kBins; k += kThreads) row[k] = 0.f;
    return;
  }
  const float* x = samples + (int64_t)b * n_samples + (int64_t)t * hop;
  for (int n = threadIdx.x; n < kHalf; n += kThreads) {
    const double re = (double)x[2 * n] * window[2 * n];
    const double im = (double)x[2 * n + 1] * window[2 * n + 1];
    z[__brev(n) >> (32 - kLogHalf)] = make_double2(re, im);  // bit-reversed
  }
  __syncthreads();
  for (int s = 0; s < kLogHalf; ++s) {
    const int m = 1 << s;  // butterfly half-span
    for (int j = threadIdx.x; j < kHalf / 2; j += kThreads) {
      const int pos = j & (m - 1);
      const int i0 = ((j >> s) << (s + 1)) + pos;
      const int i1 = i0 + m;
      // W_{2m}^pos = W_4096^(pos * 4096 / 2m)
      const double2 w = twiddle[pos << (kLogHalf - s)];
      const double2 a = z[i0];
      const double2 c = cmul(w, z[i1]);
      z[i0] = make_double2(a.x + c.x, a.y + c.y);
      z[i1] = make_double2(a.x - c.x, a.y - c.y);
    }
    __syncthreads();
  }
  for (int k = threadIdx.x; k < shz::kBins; k += kThreads) {
    const double2 zk = z[k & (kHalf - 1)];
    const double2 zc = z[(kHalf - k) & (kHalf - 1)];  // conj taken below
    // E = (Z[k] + conj Z[N/2-k]) / 2 ; O = (Z[k] - conj Z[N/2-k]) / 2i
    const double2 e = make_double2(0.5 * (zk.x + zc.x), 0.5 * (zk.y - zc.y));
    const double2 o = make_double2(0.5 * (zk.y + zc.y), -0.5 * (zk.x - zc.x));
    const double2 wo = cmul(twiddle[k], o);
    const double xr = e.x + wo.x;
    const double xi = e.y + wo.y;
    const double scale = (k == 0 || k == kHalf) ? scale_edge : scale_mid;
    row[k] = (float)((xr * xr + xi * xi) * scale);
  }
}

}  // namespace

SHZ_EXPORT int shz_spectrogram_power(
    const float* samples, long long n_samples, const int* n_valid_frames,
    int batch, int n_frames, int hop, const double* window,
    const double* twiddle, double scale_edge, double scale_mid, float* out,
    void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  const dim3 grid(n_frames, batch);
  spectrogram_power_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      samples, n_samples, n_valid_frames, n_frames, hop, window,
      reinterpret_cast<const double2*>(twiddle), scale_edge, scale_mid, out);
  return (int)cudaGetLastError();
}

SHZ_EXPORT const char* shz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
