"""Batched multi-query matching: many clips against the index in one dispatch.

The port of ``shazam_tpu/match/batched.py`` (``match_queries_batched``,
``match_queries_batched_spanned``). The JAX package vmaps the
single-query matcher over a (Bq, Q) query stack. The port's matcher has
no fixed-shape form to vmap, so the clip index travels in the data
instead (``lookup.expand_stack``, ``lookup.dense_rank``,
``lookup.sort_rank``), and one dispatch launches the same kernels
whatever the batch size:

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
The batch ranks with ``"dense"`` or ``"sort"``; the scan rank gives the
same ``RawMatch`` and has no batched form. Against a spanned store,
``match_queries_batched_spanned`` expands every span's runs of the stack
at once (``lookup.expand_spans_stack``) and ranks them with the sort rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.search import lexi_bounds
from ..index.store import DeviceIndex
from ..profiling import spanned
from .lookup import (RawMatch, _is_stacked, check_vote_key, dense_rank,
                     expand_spans_stack, expand_stack, sort_rank)


def _batched_bounds(index: DeviceIndex, q_hi, q_lo, q_ex, q_valid):
    """``lexi_bounds`` of a (Bq, Q) query stack, as one flat search."""
    shape = q_hi.shape
    lb, ub = lexi_bounds(index, q_hi.reshape(-1), q_lo.reshape(-1),
                         q_ex.reshape(-1), q_valid.reshape(-1))
    return lb.view(shape), ub.view(shape)


@spanned("match.rank")
def match_queries_batched(index: DeviceIndex, q_hi, q_lo, q_ex, q_t, q_valid,
                          q_first, *, rank: str, n_songs: int,
                          delta_min: int, delta_range: int,
                          match_capacity: int = 65536, topn: int = 2,
                          expand_block: int = 0,
                          expand_runs: int = 0) -> RawMatch:
    """Match a (Bq, Q) stack of padded queries in one dispatch; returns a
    RawMatch of (Bq, topn) and (Bq,) tensors.

    ``rank``: ``"dense"`` (the histogram, row-by-row expansion, as the JAX
    package's batch) or ``"sort"`` (the sparse sort rank; ``expand_block``
    takes the blocked expansion).
    """
    if rank not in ("dense", "sort"):
        raise ValueError(f"batched rank {rank!r} not in ('dense', 'sort')")
    check_vote_key(n_songs, delta_range)
    lb, ub = _batched_bounds(index, q_hi, q_lo, q_ex, q_valid)
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


def match_queries_batched_spanned(span_arrays, q_hi, q_lo, q_ex, q_t,
                                  q_valid, q_first, *, n_songs: int,
                                  delta_min: int, delta_range: int,
                                  match_capacity: int = 65536, topn: int = 2,
                                  offset_stride: int = 0, heads=None,
                                  rank_candidates: int = 0, uviews=None,
                                  u_steps: int = 0, vote_rank: str = "sort",
                                  expand_block: int = 0,
                                  expand_runs: int = 0):
    """Match a (Bq, Q) stack against a spanned store's views in one
    dispatch, with the sort rank. Returns (RawMatch of (Bq, ...) tensors,
    (Bq,) span_max): each clip's clamp signal (its largest per-span count,
    or its total on the stacked layout's shared budget). ``offset_stride``,
    ``heads``, ``rank_candidates``, ``uviews``, ``u_steps`` and
    ``vote_rank`` are the JAX signature's and ignored: every rank gives
    the sort rank's ``RawMatch``."""
    check_vote_key(n_songs, delta_range)
    blk = expand_block if _is_stacked(span_arrays) else 0
    sid, delta, p, valid, total, span_max, n_dropped = expand_spans_stack(
        span_arrays, q_hi, q_lo, q_ex, q_t, q_valid,
        match_capacity=match_capacity, expand_block=blk,
        expand_runs=expand_runs)
    raw = sort_rank(sid, delta, q_first.gather(1, p), valid, total,
                    n_dropped, n_songs=n_songs, delta_min=delta_min,
                    delta_range=delta_range, topn=topn,
                    prefix=match_capacity if blk else 0)
    return raw, span_max


@spanned("sia.readback")
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
