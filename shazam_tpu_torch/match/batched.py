"""Batched multi-query matching: many clips against the index in one dispatch.

The port of ``shazam_tpu/match/batched.py`` (``query_totals_batched``,
``match_queries_batched``; the spanned variant waits for the spanned
store). The JAX package vmaps the single-query matcher over a (Bq, Q)
query stack. The port's matcher has no fixed-shape form to vmap, so the
clip index travels in the data instead (``lookup.expand_stack``,
``lookup.dense_rank``, ``lookup.sort_rank``), and one dispatch launches
the same kernels whatever the batch size:

- one ``lexi_bounds`` over the flattened (Bq * Q) lanes;
- per clip, the shortest-first run inclusion as cumulative sums along
  the lane axis, clamped at the dispatch's ``match_capacity``;
- one batched ``torch.searchsorted`` (boundaries (Bq, Q), values (Bq,
  cap)) that maps each clip's stream slots to its runs;
- the dense rank: one masked ``index_add_`` into a flat (Bq * n_songs *
  delta_range) histogram; the sort rank: one sort of the vote keys with
  the clip in the bits above the key, then scatters with the clip in the
  index.

Every clip's row equals ``lookup.match_by_rank`` on that clip alone at the
same capacity and expansion, which runs the same code on a stack of one.
The batch ranks with ``"dense"`` or ``"sort"``; the scan and pruned ranks
give the same ``RawMatch`` and have no batched form.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.search import lexi_bounds
from ..index.store import DeviceIndex
from .lookup import (RawMatch, check_vote_key, dense_rank, expand_stack,
                     sort_rank)


def _batched_bounds(index: DeviceIndex, q_hi, q_lo, q_ex, q_valid):
    """``lexi_bounds`` of a (Bq, Q) query stack, as one flat search."""
    shape = q_hi.shape
    lb, ub = lexi_bounds(index, q_hi.reshape(-1), q_lo.reshape(-1),
                         q_ex.reshape(-1), q_valid.reshape(-1))
    return lb.view(shape), ub.view(shape)


def query_totals_batched(index: DeviceIndex, q_hi, q_lo, q_ex, q_valid):
    """Exact per-clip matched-row counts of a (Bq, Q) query stack, and the
    per-lane bounds for the batch's match to reuse: the batched
    bounds-first probe. Returns (totals (Bq,), lb, ub (Bq, Q))."""
    lb, ub = _batched_bounds(index, q_hi, q_lo, q_ex, q_valid)
    return torch.where(q_valid, ub - lb, 0).sum(1), lb, ub


def match_queries_batched(index: DeviceIndex, q_hi, q_lo, q_ex, q_t, q_valid,
                          q_first, *, rank: str, n_songs: int,
                          delta_min: int, delta_range: int,
                          match_capacity: int = 65536, topn: int = 2,
                          expand_block: int = 0, expand_runs: int = 0,
                          bounds=None) -> RawMatch:
    """Match a (Bq, Q) stack of padded queries in one dispatch; returns a
    RawMatch of (Bq, topn) and (Bq,) tensors.

    ``rank``: ``"dense"`` (the histogram, row-by-row expansion, as the JAX
    package's batch) or ``"sort"`` (the sparse sort rank; ``expand_block``
    takes the blocked expansion). ``bounds`` reuses a probe's (Bq, Q)
    ``(lb, ub)`` (``query_totals_batched``).
    """
    if rank not in ("dense", "sort"):
        raise ValueError(f"batched rank {rank!r} not in ('dense', 'sort')")
    check_vote_key(n_songs, delta_range)
    lb, ub = (bounds if bounds is not None
              else _batched_bounds(index, q_hi, q_lo, q_ex, q_valid))
    blk = expand_block if rank == "sort" else 0
    sid, delta, p, valid, total, n_dropped = expand_stack(
        index, lb, ub, q_t, q_valid, match_capacity=match_capacity,
        expand_block=blk, expand_runs=expand_runs)
    kw = dict(n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
              topn=topn)
    args = (sid, delta, q_first.gather(1, p), valid, total, n_dropped)
    if rank == "dense":
        return dense_rank(*args, **kw)
    return sort_rank(*args, prefix=match_capacity if blk else 0, **kw)


def batched_raw_to_host(raw: RawMatch) -> RawMatch:
    """One device->host copy of a batched RawMatch: numpy (Bq, topn)
    columns and (Bq,) scalars."""
    bq, topn = raw.top_songs.shape
    flat = torch.cat([
        torch.stack([a.to(torch.int64) for a in raw[:4]]).reshape(-1),
        torch.stack([a.to(torch.int64) for a in raw[4:]]).reshape(-1),
    ]).cpu().numpy()
    cols = flat[: 4 * bq * topn].reshape(4, bq, topn)
    scalars = flat[4 * bq * topn:].reshape(4, bq)
    return RawMatch(*(np.ascontiguousarray(c) for c in cols),
                    *(np.ascontiguousarray(s) for s in scalars))
