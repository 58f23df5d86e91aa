"""Exact lexicographic bounds of 80-bit query keys in the sorted index.

Replaces the JAX package's lane-parallel gather-and-compare descents
(``shazam_tpu/index/search.py``: interpolation seeds, the bucket-CDF head,
fence tiers). PyTorch's ``searchsorted`` is one binary search per lane in
one kernel, so the port searches twice per bound on the ``DeviceIndex``
columns (``index/store.py``):

1. ``key64`` (sign-flipped ``hi << 32 | lo``) brackets the run
   [lb64, ub64) of rows sharing the query's 64-bit prefix;
2. ``key_sub`` (``run_start << 16 | ex``) brackets the rows of that run
   whose ex equals the query's, with the query key ``lb64 << 16 | ex``.

Both bounds are exact for any key distribution (hyper-common hashes
included), with no host sync and no bucket head to build. On a
consolidated spanned store's view, whose columns are (n_spans,
span_rows), the same two searches run batched over the spans, each query
broadcast to every span, and the bounds are span-local rows.
"""

from __future__ import annotations

import torch

from .store import DeviceIndex


def query_key64(q_hi: torch.Tensor, q_lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) in [0, 2^32) -> int64 whose signed order is the unsigned
    order of hi << 32 | lo (the sign-flipped key, without overflow)."""
    return (q_hi.to(torch.int64) - (1 << 31)) * (1 << 32) + q_lo.to(torch.int64)


def lexi_bounds(index: DeviceIndex, q_hi: torch.Tensor, q_lo: torch.Tensor,
                q_ex: torch.Tensor, q_valid: torch.Tensor | None = None):
    """(lower, upper) row bounds of each query key, int64.

    Rows [lower, upper) hold exactly the query's 80-bit key. With
    ``q_valid``, padding lanes get zero-width (0, 0) spans. On a stacked
    (n_spans, span_rows) view, (Q,) queries give (n_spans, Q) bounds.
    """
    q64 = query_key64(q_hi, q_lo)
    q_ex = q_ex.to(torch.int64)
    if index.key64.dim() == 2:
        q64 = q64.expand(index.key64.shape[0], -1).contiguous()
    lb64 = torch.searchsorted(index.key64, q64, side="left")
    ub64 = torch.searchsorted(index.key64, q64, side="right")
    q_sub = lb64 * (1 << 16) + q_ex
    lb = torch.searchsorted(index.key_sub, q_sub, side="left")
    ub = torch.searchsorted(index.key_sub, q_sub, side="right")
    # no row with this 64-bit prefix: lb64 starts another key's run and
    # is the insertion point itself
    hit = lb64 < ub64
    lb = torch.where(hit, lb, lb64)
    ub = torch.where(hit, ub, lb64)
    if q_valid is not None:
        lb = torch.where(q_valid, lb, 0)
        ub = torch.where(q_valid, ub, 0)
    return lb, ub
