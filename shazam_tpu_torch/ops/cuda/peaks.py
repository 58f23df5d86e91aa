"""K2 wrapper: power spectrogram -> bit-packed peak mask (``csrc/peaks.cu``).

Replaces the Pallas kernel ``shazam_tpu/ops/pallas/peaks.py`` (``_kernel``,
behind ``peak_candidates_fused``). CPU tensors take the plain twin
``ops.peaks.peak_mask_plain``; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ..._build import Kernel
from ..peaks import MASK_WORDS, peak_mask_plain, power_threshold

N_BINS = 2049
RADIUS = 10  # compiled into the kernel's shared-memory halo

KERNEL = Kernel(
    "peak_mask", "shz_peak_mask",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
     ctypes.c_void_p])


def peak_mask(power: torch.Tensor, amp_min: float = 10.0,
              radius: int = 10) -> torch.Tensor:
    """(B, T, 2049) f32 PSD power -> int32 (B, T, 65) constellation bits.

    Requires amp_min > 0: out-of-range cells read as zero power, which
    must stay below the gate.
    """
    if amp_min <= 0:
        raise ValueError("the power-domain peak mask requires amp_min > 0")
    if power.device.type == "cpu":
        return peak_mask_plain(power, amp_min, radius)
    if power.device.type != "cuda":
        raise ValueError(f"unsupported device {power.device}")
    if radius != RADIUS:
        raise ValueError(f"K2 is compiled for radius {RADIUS}, got {radius}")
    if power.dtype != torch.float32 or power.dim() != 3 \
            or power.shape[2] != N_BINS or not power.is_contiguous():
        raise ValueError("power must be a contiguous (B, T, 2049) float32 "
                         "tensor")
    bsz, t, _ = power.shape
    bits = torch.empty((bsz, t, MASK_WORDS), dtype=torch.int32,
                       device=power.device)
    if bsz == 0 or t == 0:
        return bits
    KERNEL(power.data_ptr(), bsz, t, power_threshold(amp_min),
           bits.data_ptr())
    return bits
