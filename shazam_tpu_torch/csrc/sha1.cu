// Fan-out pairing and SHA-1 of the "f1|f2|dt" messages, in one kernel.
//
// Replaces no Pallas kernel: the JAX package hashes with plain XLA
// (shazam_tpu/ops/hashes.py generate_hashes over shazam_tpu/ops/sha1.py
// sha1_fingerprint_keys), whose port as plain torch is the twin
// (ops/hashes.generate_hashes_plain). That chain is ~2,770 int64
// elementwise launches a pass, a few us of host each, which held a
// listener's clip on the host while the card sat idle.
//
// Lane (row, j, i), j = 1..fan-1 major, i < cap minor, as the twin lays
// them out: anchor i, target i + j. With n = min(n_peaks[row], cap),
//
//   pair_ok = i + j < n
//   t2, f2  = times/freqs[i + j], or 0 past cap
//   dt      = pair_ok ? t2 - t1 : 0
//   valid   = pair_ok && min_dt <= dt <= max_dt
//   key     = SHA-1("f1|f2|dt"): hi = a + H0, lo = b + H1,
//             ex = (c + H2) >> 16 (the reference's 20 hex chars)
//   t1      = times[i]
//
// Every lane is hashed, masked or not, so the keys equal the twin's bit
// for bit on every lane (the twin's digit rule, floor division included,
// is copied below: a field past 9999 keeps its last four digits, as the
// twin's do).
//
// Bound: the card's integer ALUs. The algorithm's ~1,300 two-input
// operations a lane (80 rounds of ~9, 64 schedule words of 4, the decimal
// digits, the index arithmetic) compile to 661 integer-pipe instructions
// (three-input LOP3 and IADD3, funnel shifts; 233 more IMAD/VIADD issue to
// the FMA pipe beside them), against 8 bytes in and 33 out. At the clip
// shape (1 x 4 x 8,192 lanes) that is ~1.3 us at 132 SMs x 64 int32 lanes
// x 1.98 GHz, and ~1.1 MB, ~0.33 us at 3.35 TB/s: latency and the launch
// set the time there (2.7 us on an H100). At the ingest shape (16 x 4 x
// 16,384) it is ~41 us; the kernel takes ~48.
//
// Design: one thread a lane, so that neighbouring threads read and write
// neighbouring addresses (lanes of one j are consecutive anchors). The
// message, at most 14 bytes plus the 0x80 pad byte, is assembled in two
// 64-bit registers from each field's packed ASCII digits, so the 512-bit
// block is four message words, ten zero words and the bit length; the 80
// rounds run unrolled in native uint32 with a 16-word schedule ring in
// registers (32 registers, no spills). kThreads = 128 was the fastest of
// 64-512 at both shapes, by up to 2.3 % but for 512 at the clip shape
// (+52 %). One thread an anchor, its fan-1 lanes sharing f1's digits, was
// 5 % faster at the ingest shape but 67 % slower at the clip shape, which
// it fills with a quarter of the threads; the clip is what a listener
// waits on (PERF.md §6).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kH0 = 0x67452301u, kH1 = 0xEFCDAB89u, kH2 = 0x98BADCFEu,
                   kH3 = 0x10325476u, kH4 = 0xC3D2E1F0u;

__device__ __forceinline__ unsigned rotl(unsigned x, int n) {
  return __funnelshift_l(x, x, n);
}

// floor(x / d) for d > 0, as torch's floor division rounds
__device__ __forceinline__ int floor_div(int x, int d) {
  const int q = x / d;
  return q - (q * d > x);
}

// (x // d) % 10 with floor semantics, as an ASCII digit
__device__ __forceinline__ unsigned digit_char(int x, int d) {
  const int q = floor_div(x, d);
  return 0x30u + (unsigned)(q - 10 * floor_div(q, 10));
}

// The twin's decimal string of x: 1 + (x >= 10) + (x >= 100) + (x >= 1000)
// digits, most significant first, the k-th the (x // 10^e) % 10 of its
// exponent e. Returns the characters right-aligned in one word (big-endian)
// and their count.
__device__ __forceinline__ unsigned decimal(int x, int& len) {
  len = 1 + (x >= 10) + (x >= 100) + (x >= 1000);
  const unsigned all = digit_char(x, 1000) << 24 | digit_char(x, 100) << 16 |
                       digit_char(x, 10) << 8 | digit_char(x, 1);
  return len == 4 ? all : all & ((1u << (8 * len)) - 1u);
}

// Appends len (1-4) bytes to the 128-bit big-endian string (hi, lo).
__device__ __forceinline__ void append(unsigned long long& hi,
                                       unsigned long long& lo, unsigned bytes,
                                       int len) {
  const int s = 8 * len;
  hi = hi << s | lo >> (64 - s);
  lo = lo << s | bytes;
}

struct Key {
  unsigned hi, lo, ex;
};

// The 80-bit key of the message "<s1>|f2|dt" (s1: f1's l1 characters).
__device__ __forceinline__ Key message_key(unsigned s1, int l1, int f2,
                                           int dt) {
  // the message, then 0x80, left-aligned in the block's first 16 bytes
  int l2, l3;
  const unsigned s2 = decimal(f2, l2), s3 = decimal(dt, l3);
  const int msg_len = l1 + l2 + l3 + 2;  // 5..14 bytes
  unsigned long long hi = 0, lo = 0;
  append(hi, lo, s1, l1);
  append(hi, lo, '|', 1);
  append(hi, lo, s2, l2);
  append(hi, lo, '|', 1);
  append(hi, lo, s3, l3);
  append(hi, lo, 0x80u, 1);
  const int pad = 8 * (15 - msg_len);  // 8..80 bits to the left edge
  if (pad >= 64) {
    hi = lo << (pad - 64);
    lo = 0;
  } else {
    hi = hi << pad | lo >> (64 - pad);
    lo <<= pad;
  }

  unsigned w[16];
  w[0] = (unsigned)(hi >> 32);
  w[1] = (unsigned)hi;
  w[2] = (unsigned)(lo >> 32);
  w[3] = (unsigned)lo;
#pragma unroll
  for (int k = 4; k < 15; ++k) w[k] = 0;
  w[15] = 8u * msg_len;  // the bit length; msg_len < 56 leaves word 14 zero

  unsigned a = kH0, b = kH1, c = kH2, d = kH3, e = kH4;
#pragma unroll
  for (int t = 0; t < 80; ++t) {
    const int k = t & 15;
    if (t >= 16)
      w[k] = rotl(w[(k + 13) & 15] ^ w[(k + 8) & 15] ^ w[(k + 2) & 15] ^ w[k],
                  1);
    unsigned f, kt;
    if (t < 20) {
      f = (b & c) | (~b & d);
      kt = 0x5A827999u;
    } else if (t < 40) {
      f = b ^ c ^ d;
      kt = 0x6ED9EBA1u;
    } else if (t < 60) {
      f = (b & c) | (b & d) | (c & d);
      kt = 0x8F1BBCDCu;
    } else {
      f = b ^ c ^ d;
      kt = 0xCA62C1D6u;
    }
    const unsigned tmp = rotl(a, 5) + f + e + kt + w[k];
    e = d;
    d = c;
    c = rotl(b, 30);
    b = a;
    a = tmp;
  }
  return Key{a + kH0, b + kH1, (c + kH2) >> 16};
}

__global__ void __launch_bounds__(kThreads)
    pair_sha1_kernel(const int* __restrict__ times,
                     const int* __restrict__ freqs,
                     const int* __restrict__ n_peaks, int cap, int fan_pairs,
                     int min_dt, int max_dt, unsigned lanes,
                     long long* __restrict__ out_hi,
                     long long* __restrict__ out_lo,
                     long long* __restrict__ out_ex,
                     long long* __restrict__ out_t1,
                     unsigned char* __restrict__ out_valid) {
  const unsigned g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= lanes) return;
  const unsigned row_lanes = (unsigned)fan_pairs * (unsigned)cap;
  const unsigned row = g / row_lanes;
  const unsigned r = g - row * row_lanes;
  const unsigned jm1 = r / (unsigned)cap;
  const int i = (int)(r - jm1 * (unsigned)cap);
  const int j = (int)jm1 + 1;
  const int* t_row = times + (size_t)row * cap;
  const int* f_row = freqs + (size_t)row * cap;

  const int n = min(n_peaks[row], cap);
  const int t1 = t_row[i], f1 = f_row[i];
  const bool in_cap = i + j < cap;
  const int t2 = in_cap ? t_row[i + j] : 0;
  const int f2 = in_cap ? f_row[i + j] : 0;
  const bool pair_ok = i + j < n;
  const int dt = pair_ok ? t2 - t1 : 0;

  int l1;
  const unsigned s1 = decimal(f1, l1);
  const Key key = message_key(s1, l1, f2, dt);
  out_hi[g] = (long long)key.hi;
  out_lo[g] = (long long)key.lo;
  out_ex[g] = (long long)key.ex;
  out_t1[g] = (long long)t1;
  out_valid[g] = pair_ok && dt >= min_dt && dt <= max_dt;
}

}  // namespace

// times, freqs: int32 (rows, cap); n_peaks: int32 (rows,); outputs
// (rows, (fan_value - 1) * cap), j-major: hi, lo, ex, t1 int64, valid bool.
// Returns cudaErrorInvalidValue for a lane count past 2^31 - 1 or
// fan_value < 2.
SHZ_EXPORT int shz_pair_sha1(const int* times, const int* freqs,
                             const int* n_peaks, int rows, int cap,
                             int fan_value, int min_dt, int max_dt,
                             long long* hi, long long* lo, long long* ex,
                             long long* t1, unsigned char* valid,
                             void* stream) {
  if (fan_value < 2 || rows < 0 || cap < 0) return (int)cudaErrorInvalidValue;
  const long long lanes = (long long)rows * (fan_value - 1) * cap;
  if (lanes == 0) return 0;
  if (lanes > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((lanes + kThreads - 1) / kThreads);
  pair_sha1_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      times, freqs, n_peaks, cap, fan_value - 1, min_dt, max_dt,
      (unsigned)lanes, hi, lo, ex, t1, valid);
  return (int)cudaGetLastError();
}
