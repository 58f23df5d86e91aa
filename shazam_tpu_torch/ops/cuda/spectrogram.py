"""K1 wrapper: framed Hann-windowed FFT -> PSD power (``csrc/spectrogram.cu``).

Replaces the Pallas kernel ``shazam_tpu/ops/pallas/spectrogram.py``
(``_kernel``/``_compute_tile``, behind ``spectrogram_power_fused``). CPU
tensors take the plain twin ``ops.spectrogram.spectrogram_power_plain``;
CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..._build import Kernel
from ..spectrogram import hann_window, num_frames, psd_scales, spectrogram_power_plain

WSIZE = 4096
N_BINS = WSIZE // 2 + 1

KERNEL = Kernel(
    "spectrogram_power", "shz_spectrogram_power",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_double, ctypes.c_double, ctypes.c_void_p])


def _roots(m: int, e: np.ndarray) -> np.ndarray:
    """W_m^e = exp(-2 pi i e / m) as (..., 2) float64 (cos, sin) pairs."""
    ang = -2.0 * np.pi * (e % m) / m
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1)


def twiddle_table() -> np.ndarray:
    """The kernel's packed float64 twiddles, (4081, 2): W_4096^k for
    k = 0..2048 (the real-to-complex split), then the Stockham passes'
    W_256^(k r) as [r - 1][k] for r < 16, k < 16, and W_2048^(k r) as
    [r - 1][k] for r < 8, k < 256 (a warp reads consecutive entries)."""
    r16, k16 = np.meshgrid(np.arange(1, 16), np.arange(16), indexing="ij")
    r8, k256 = np.meshgrid(np.arange(1, 8), np.arange(256), indexing="ij")
    return np.ascontiguousarray(np.concatenate([
        _roots(WSIZE, np.arange(N_BINS)),
        _roots(256, r16 * k16).reshape(-1, 2),
        _roots(2048, r8 * k256).reshape(-1, 2)]))


@functools.lru_cache(maxsize=8)
def _tables(device: torch.device):
    """float64 Hann window (np.hanning(4096), bit for bit) and the packed
    twiddles, uploaded once per device."""
    return (hann_window(WSIZE, device).contiguous(),
            torch.from_numpy(twiddle_table()).to(device))


def spectrogram_power(samples: torch.Tensor, n_valid_frames: torch.Tensor, *,
                      fs: int = 44100, wsize: int = 4096,
                      hop: int = 2048) -> torch.Tensor:
    """(B, N) f32 samples, (B,) int32 valid frames -> (B, T, 2049) f32.

    T = (N - wsize) // hop + 1; frames >= n_valid_frames are exact zeros.
    """
    if samples.device.type == "cpu":
        return spectrogram_power_plain(samples, n_valid_frames, fs=fs,
                                       wsize=wsize, hop=hop)
    if samples.device.type != "cuda":
        raise ValueError(f"unsupported device {samples.device}")
    if wsize != WSIZE or not 0 < hop <= wsize:
        raise ValueError(f"K1 supports wsize={WSIZE} and 0 < hop <= wsize, "
                         f"got wsize={wsize} hop={hop}")
    if samples.dtype != torch.float32 or samples.dim() != 2 \
            or not samples.is_contiguous():
        raise ValueError("samples must be a contiguous (B, N) float32 tensor")
    bsz, n = samples.shape
    if n_valid_frames.device != samples.device \
            or n_valid_frames.dtype != torch.int32 \
            or tuple(n_valid_frames.shape) != (bsz,) \
            or not n_valid_frames.is_contiguous():
        raise ValueError("n_valid_frames must be a contiguous (B,) int32 "
                         "tensor on the samples' device")
    t = num_frames(n, wsize, hop)
    out = torch.empty((bsz, t, N_BINS), dtype=torch.float32,
                      device=samples.device)
    if bsz == 0 or t == 0:
        return out
    window, twiddle = _tables(samples.device)
    edge, mid = psd_scales(wsize, fs)
    KERNEL(samples.data_ptr(), n, n_valid_frames.data_ptr(), bsz, t, hop,
           window.data_ptr(), twiddle.data_ptr(), edge, mid, out.data_ptr())
    return out
