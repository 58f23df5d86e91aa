"""Anchor/target hash generation with a static fan-out window.

Matches reference ``generate_hashes`` (``__init__.py:179-210``): peaks in
time order, anchor i pairs with peaks i+1..i+fan_value-1, keep pairs with
``min_dt <= t2 - t1 <= max_dt``, hash "f1|f2|dt" with SHA-1 truncated to
80 bits, emit with the anchor time.

The fan-out is a static set of shifted copies (j = 1..fan-1), so the pair
set is a dense ((fan-1) * capacity) grid of lanes: masked lanes still run
through SHA-1 and are flagged invalid, with no data-dependent shapes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .sha1 import sha1_fingerprint_keys


def generate_hashes(times: torch.Tensor, freqs: torch.Tensor,
                    n_peaks: torch.Tensor, fan_value: int = 5,
                    min_dt: int = 0, max_dt: int = 200):
    """Pair peaks and hash them.

    :param times/freqs: integer (..., capacity) peak coordinates in (t, f)
        order (``compact`` output); slots past the count are ignored.
    :param n_peaks: (...) peak counts, clamped to capacity here.
    :return: (hi, lo, ex16, t1, valid): int64/bool (..., (fan-1) *
        capacity), lanes j-major like the JAX package's. Masked lanes hold
        arbitrary key bits.
    """
    if not 0 <= min_dt <= max_dt <= 9999:
        raise ValueError(
            f"min_dt/max_dt ({min_dt}/{max_dt}) out of range: the lane "
            "SHA-1 formats each field with at most 4 decimal digits, so "
            "dt > 9999 would hash a truncated message and silently diverge "
            "from hashlib/the reference")
    cap = times.shape[-1]
    t1 = times.to(torch.int64)
    f1 = freqs.to(torch.int64)
    n = torch.clamp(n_peaks.to(torch.int64), max=cap)[..., None]
    idx = torch.arange(cap, device=times.device)
    f1s, f2s, dts, valids = [], [], [], []
    for j in range(1, fan_value):
        t2 = F.pad(t1[..., j:], (0, j))   # target = peak i+j, zero tail
        f2 = F.pad(f1[..., j:], (0, j))
        pair_ok = (idx + j) < n
        dt = torch.where(pair_ok, t2 - t1, 0)
        f1s.append(f1)
        f2s.append(f2)
        dts.append(dt)
        valids.append(pair_ok & (dt >= min_dt) & (dt <= max_dt))
    hi, lo, ex = sha1_fingerprint_keys(torch.cat(f1s, -1), torch.cat(f2s, -1),
                                       torch.cat(dts, -1))
    return hi, lo, ex, torch.cat([t1] * (fan_value - 1), -1), torch.cat(valids, -1)
