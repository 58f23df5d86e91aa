// Shared definitions of the hand-written Hopper kernels.
//
// Every kernel is reached through a plain C entry point that takes raw
// device pointers and a cudaStream_t (passed from Python as void*), launches
// on that stream, never synchronises, allocates nothing, and returns the
// cudaError_t of the launch (0 = success) so the ctypes wrapper can raise.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace shz {

// Fingerprint geometry fixed by the reference configuration: 4096-sample
// Hann frames give 2049 one-sided bins; a frame's peak mask packs into
// ceil(2049 / 32) = 65 32-bit words (bit j of word w is bin 32 w + j).
constexpr int kWindow = 4096;
constexpr int kBins = kWindow / 2 + 1;               // 2049
constexpr int kMaskWords = (kBins + 31) / 32;        // 65

}  // namespace shz

#define SHZ_EXPORT extern "C" __attribute__((visibility("default")))
