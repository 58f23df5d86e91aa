"""Pairing + SHA-1 wrapper: peak lists -> 80-bit hash keys (``csrc/sha1.cu``).

Replaces no Pallas kernel: the JAX package's pairing and SHA-1 are plain
XLA (``shazam_tpu/ops/hashes.py``, ``shazam_tpu/ops/sha1.py``). Its plain
twin is ``ops.hashes.generate_hashes_plain``; ``ops.hashes.generate_hashes``
sends CUDA tensors here and CPU tensors to the twin.

The launch allocates its outputs with ``torch.empty``, runs on the current
stream, reads nothing back and keeps no state, so it can be captured in a
CUDA graph.
"""

from __future__ import annotations

import ctypes

import torch

from ..._build import Kernel, raw_stream

MAX_FIELD = 9999  # a message field has at most 4 decimal digits

KERNEL = Kernel(
    "pair_sha1", "shz_pair_sha1",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p])

_WIDTHS = (torch.int32, torch.int64)


def pair_hashes(times: torch.Tensor, freqs: torch.Tensor,
                n_peaks: torch.Tensor, fan_value: int = 5, min_dt: int = 0,
                max_dt: int = 200):
    """CUDA (..., cap) peak lists -> (hi, lo, ex, t1, valid) over
    (..., (fan_value - 1) * cap) lanes, j-major, bit for bit
    ``generate_hashes_plain``'s.

    ``times`` and ``freqs`` are contiguous integer tensors of one shape,
    ``n_peaks`` one of their leading shape (0-dim for 1-D lists). int32,
    as K3 gives them, goes in as it is; int64 is cast (``n_peaks``
    clamped to ``[0, cap]`` first).
    """
    if fan_value < 2:
        raise ValueError(f"fan_value must be at least 2, got {fan_value}")
    if not 0 <= min_dt <= max_dt <= MAX_FIELD:
        raise ValueError(f"need 0 <= min_dt <= max_dt <= {MAX_FIELD}, got "
                         f"{min_dt}/{max_dt}")
    if any(x.dtype not in _WIDTHS for x in (times, freqs, n_peaks)):
        raise ValueError("times, freqs and n_peaks must be int32 or int64")
    if times.dim() < 1 or times.shape != freqs.shape \
            or n_peaks.shape != times.shape[:-1]:
        raise ValueError(
            f"times and freqs must share one (..., cap) shape and n_peaks "
            f"be (...): got {tuple(times.shape)}, {tuple(freqs.shape)}, "
            f"{tuple(n_peaks.shape)}")
    if not (times.is_contiguous() and freqs.is_contiguous()):
        raise ValueError("times and freqs must be contiguous")
    dev = times.device
    if dev.type != "cuda" or freqs.device != dev or n_peaks.device != dev:
        raise ValueError(f"pair_hashes takes CUDA tensors on one device, "
                         f"got {dev}, {freqs.device}, {n_peaks.device}")
    cap = times.shape[-1]
    times, freqs = (x if x.dtype == torch.int32 else x.to(torch.int32)
                    for x in (times, freqs))
    if n_peaks.dtype != torch.int32:
        n_peaks = torch.clamp(n_peaks, 0, cap).to(torch.int32)
    n_peaks = n_peaks.contiguous()
    rows = times.numel() // cap if cap else 0
    lanes = (fan_value - 1) * cap
    if rows * lanes >= 1 << 31:
        raise ValueError(f"{rows} x {lanes} lanes exceed the kernel's "
                         "32-bit lane index")
    shape = (*times.shape[:-1], lanes)
    hi, lo, ex, t1 = (torch.empty(shape, dtype=torch.int64, device=dev)
                      for _ in range(4))
    valid = torch.empty(shape, dtype=torch.bool, device=dev)
    if rows * lanes:
        KERNEL(times.data_ptr(), freqs.data_ptr(), n_peaks.data_ptr(), rows,
               cap, fan_value, min_dt, max_dt, hi.data_ptr(), lo.data_ptr(),
               ex.data_ptr(), t1.data_ptr(), valid.data_ptr(),
               stream=raw_stream(dev.index))
    return hi, lo, ex, t1, valid
