"""K3 wrapper: peak-mask bits -> ordered peak list (``csrc/compact.cu``).

Replaces the Pallas kernel ``shazam_tpu/ops/pallas/compact.py``
(``_ff_kernel``/``_tile_segment``, behind ``compact_candidates``). CPU
tensors take the plain twin ``ops.peaks.compact_plain``; CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ..._build import Kernel
from ..peaks import MASK_WORDS, compact_plain

KERNEL = Kernel(
    "compact", "shz_compact",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])


def compact(bits: torch.Tensor, capacity: int):
    """int32 (B, T, 65) mask bits -> (times, freqs, n_peaks), all int32.

    times/freqs are (B, capacity) in (t, f) order, zeros past the count;
    n_peaks (B,) is the exact peak count (> capacity = overflow).
    """
    if capacity <= 0:
        raise ValueError("capacity must be positive")
    if bits.device.type == "cpu":
        return compact_plain(bits, capacity)
    if bits.device.type != "cuda":
        raise ValueError(f"unsupported device {bits.device}")
    if bits.dtype != torch.int32 or bits.dim() != 3 \
            or bits.shape[2] != MASK_WORDS or not bits.is_contiguous():
        raise ValueError("bits must be a contiguous (B, T, 65) int32 tensor")
    bsz, t, _ = bits.shape
    times = torch.empty((bsz, capacity), dtype=torch.int32, device=bits.device)
    freqs = torch.empty_like(times)
    n_peaks = torch.empty((bsz,), dtype=torch.int32, device=bits.device)
    if bsz == 0:
        return times, freqs, n_peaks
    KERNEL(bits.data_ptr(), bsz, t, capacity, times.data_ptr(),
           freqs.data_ptr(), n_peaks.data_ptr())
    return times, freqs, n_peaks
