"""Constellation peak picking in plain PyTorch, and the bit-mask contract.

Matches reference ``get_2D_peaks`` (``__init__.py:116-177``): local maxima
under the (2r+1)x(2r+1) full-square footprint with scipy's plateau
semantics, XOR the eroded zero background (``border_value=1``), strict
``amp > amp_min``.

The peak list travels between the K2 and K3 kernels as a bit-packed mask:
int32 (B, T, 65), bit j of word w is bin 32 w + j (bins >= 2049 are 0).
Other window sizes (the plain path only) take ceil(bins / 32) words.
This module holds the plain twins of both kernels:

- ``peak_mask_plain`` (K2, ``ops/cuda/peaks.py``): the power-domain mask,
  separable max via ``max_pool2d`` and erosion via ``-max_pool2d(-x)``;
- ``compact_plain`` (K3, ``ops/cuda/compact.py``): the ordered compaction
  via a cumsum + masked scatter (no ``nonzero``, which syncs the host).

The power domain is the kernels' domain: ``power_threshold`` turns the dB
gate into the exact f32 power gate, and dB-zero background is power 0 or
power 1. It matches the dB path (``peak_mask_db``) except where two
distinct powers round to the same f32 dB (a dB plateau the power compare
does not see).
"""

from __future__ import annotations

import functools
import struct

import numpy as np
import torch
import torch.nn.functional as F

MASK_WORDS = 65  # ceil(2049 / 32): the kernels' words, window 4096 only


@functools.lru_cache(maxsize=8)
def power_threshold(amp_min: float) -> float:
    """Smallest f32 power whose kernel dB value exceeds ``amp_min``.

    Bisects the f32 bit lattice of the exact f32 expression the dB path of
    the fused JAX kernel computes (10 * ln(p) / ln(10)), so gating raw
    power with ``p >= power_threshold(amp_min)`` selects EXACTLY the cells
    the dB gate ``db(p) > amp_min`` selects.
    """
    def db(u: int) -> float:
        p = struct.unpack("<f", struct.pack("<I", u))[0]
        return float(
            np.float32(10.0)
            * (np.log(np.float32(p)) / np.float32(np.log(10.0)))
        )

    lo = struct.unpack("<I", struct.pack("<f", np.float32(1e-30)))[0]
    hi = struct.unpack("<I", struct.pack("<f", np.float32(3.0e38)))[0]
    if not db(hi) > amp_min:
        raise ValueError("amp_min beyond the f32 dB range")
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if db(mid) > amp_min:
            hi = mid
        else:
            lo = mid
    return struct.unpack("<f", struct.pack("<I", hi))[0]


def _square_max(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(B, T, F) -> max over the (2r+1)^2 window, out-of-range = -inf."""
    k = 2 * radius + 1
    y = F.max_pool2d(x[:, None], (k, 1), stride=1, padding=(radius, 0))
    return F.max_pool2d(y, (1, k), stride=1, padding=(0, radius))[:, 0]


def _constellation(x: torch.Tensor, background: torch.Tensor,
                   gate: torch.Tensor, radius: int) -> torch.Tensor:
    local_max = _square_max(x, radius) == x
    # AND-erosion as a min-pool; max_pool2d's -inf pad is +inf here, so
    # out-of-range cells count as background (scipy border_value=1)
    eroded = -_square_max(-background.to(torch.float32), radius) > 0.5
    return (local_max != eroded) & gate


def peak_mask_db(db: torch.Tensor, amp_min: float,
                 radius: int = 10) -> torch.Tensor:
    """dB-domain bool (B, T, F) constellation mask (reference semantics)."""
    return _constellation(db, db == 0, db > amp_min, radius)


def pack_mask_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool (B, T, F) -> int32 (B, T, ceil(F / 32)) bit words (65 at the
    reference's 2049 bins)."""
    bsz, t, f = mask.shape
    n_words = -(-f // 32)
    m = F.pad(mask.to(torch.int64), (0, n_words * 32 - f))
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=mask.device),
        torch.arange(32, device=mask.device))
    words = (m.view(bsz, t, n_words, 32) * weights).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def unpack_mask_bits(bits: torch.Tensor, n_bins: int = 2049) -> torch.Tensor:
    """int32 (B, T, ceil(n_bins / 32)) bit words -> bool (B, T, n_bins)."""
    bsz, t, w = bits.shape
    shifts = torch.arange(32, device=bits.device)
    b = (bits.to(torch.int64)[..., None] >> shifts) & 1
    return b.view(bsz, t, w * 32)[..., :n_bins].to(torch.bool)


def peak_mask_plain(power: torch.Tensor, amp_min: float,
                    radius: int = 10) -> torch.Tensor:
    """Plain twin of K2: power (B, T, 2049) -> int32 (B, T, 65) mask bits."""
    background = (power == 0) | (power == 1)  # dB 0 <=> power 0 or 1
    gate = power >= power_threshold(amp_min)
    return pack_mask_bits(_constellation(power, background, gate, radius))


def compact_plain(bits: torch.Tensor, capacity: int, n_bins: int = 2049):
    """Plain twin of K3: mask bits -> (times, freqs, n_peaks), all int32.

    times/freqs are (B, capacity) in (t, f) order with zeros past the
    count; n_peaks is the exact count (> capacity means overflow).
    """
    mask = unpack_mask_bits(bits, n_bins).flatten(1)      # (B, T * F)
    bsz = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), dim=1) - 1
    keep = mask & (pos < capacity)
    slot = torch.where(keep, pos, capacity)               # overflow -> dump
    flat = torch.arange(mask.shape[1], device=bits.device).expand(bsz, -1)
    out = torch.zeros((bsz, capacity + 1), dtype=torch.int64,
                      device=bits.device)
    out.scatter_(1, slot, torch.where(keep, flat, 0))
    out = out[:, :capacity]
    n_peaks = mask.sum(dim=1).to(torch.int32)
    return ((out // n_bins).to(torch.int32), (out % n_bins).to(torch.int32),
            n_peaks)
