"""Roofline bounds of the fingerprint kernels K1-K3 from their shapes.

Copied from ``chip_smoke.py`` (``kernel_bounds``, ``_bound``): each input
byte read once and each output byte written once; where the work depends
on the data, what these inputs need (K1 reads only the samples under
valid frames and transforms only valid frames). Peaks: NVIDIA's H100 SXM
data sheet at the 700 W limit.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_S = 3.35e12   # HBM3
F64_FLOP_S = 34e12      # float64 outside the tensor cores
F32_FLOP_S = 67e12      # float32 outside the tensor cores
HOP = 2048
N_BINS = 2049

# the device kernel of each bound, by the name the trace gives it
KERNEL_NAMES = {"spectrogram_power": "spectrogram_power_kernel",
                "peak_mask": "peak_mask_kernel",
                "compact": "compact_kernel"}


def _bound(nbytes: float, ops: float, op_rate: float) -> float:
    """The least milliseconds: the larger of bytes at HBM bandwidth and
    operations at ``op_rate``."""
    return max(1e3 * nbytes / HBM_BYTES_S, 1e3 * ops / op_rate)


def kernel_bounds(nvf, n_frames: int, cap: int) -> dict:
    """Each kernel's bound in ms at one launch shape: ``nvf`` the (B,)
    valid frames of the rows, ``n_frames`` the padded frames, ``cap`` the
    peak capacity of a row."""
    nvf = np.asarray(nvf, np.int64)
    bsz, cells = len(nvf), len(nvf) * n_frames * N_BINS
    live = nvf[nvf > 0]
    k1_in = 4 * int(((live - 1) * HOP + 4096).sum())
    # per valid frame: window 4096 products, a 2048-point complex FFT at
    # the radix-2 count 5 N log2 N, and 26 flops per split pair of bins
    # (E/O, twiddle product, two |X|^2 and two scales) over 1025 pairs
    k1_ops = int(live.sum()) * (4096 + 5 * 2048 * 11 + 26 * 1025)
    mask_bytes = 4 * bsz * n_frames * 65
    return {
        # samples in, power out; float64 ops
        "spectrogram_power": _bound(k1_in + 4 * cells, k1_ops, F64_FLOP_S),
        # power in, mask words out; two separable 21-wide max passes (40
        # compares), the equality and the gate per cell, in float32
        "peak_mask": _bound(4 * cells + mask_bytes, 43 * cells, F32_FLOP_S),
        # mask words in; times, freqs (B, cap) and n_peaks out
        "compact": _bound(mask_bytes + 8 * bsz * cap + 4 * bsz, 0,
                          F32_FLOP_S),
    }


def frames(n_samples: int, wsize: int = 4096, hop: int = HOP) -> int:
    """STFT frames of ``n_samples`` samples (0 below one window)."""
    return 0 if n_samples < wsize else (n_samples - wsize) // hop + 1


def share_percent(kernels: dict, shape: dict):
    """K1-K3's roofline share in % over a trace's kernel records (name ->
    [count, seconds]) at one launch ``shape`` (nvf, n_frames, cap): the
    bound of every recorded launch over their device time. None when the
    trace holds no record of them."""
    bounds = kernel_bounds(**shape)
    bound_s = busy_s = 0.0
    for kernel, name in KERNEL_NAMES.items():
        for rec, (count, secs) in kernels.items():
            if name in rec:
                bound_s += count * bounds[kernel] / 1e3
                busy_s += secs
    return 100.0 * bound_s / busy_s if busy_s > 0 else None
