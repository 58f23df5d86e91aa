"""Query matching: index lookup + offset-delta vote + rank.

Replaces the reference's batched ``WHERE hash IN`` round trips
(``recognizer.py:222-271``), per-row vote expansion and the groupby
vote/rank of ``align_matches`` (``recognizer.py:289-338``) with tensor
ops that never sync the host:

1. ``lexi_bounds`` gives each query (hash, offset) pair its row run
   [lb, ub) in the sorted index;
2. runs are included whole, shortest first, into a fixed-capacity vote
   list (a slot maps back to its run by a searchsorted over the included
   runs' cumulative lengths), row by row or, with ``expand_block``, as
   aligned blocks of the payload (``expand_stack``);
3. votes are counted and ranked with the reference's tie rules (per-song
   best delta = smallest delta among the maxima, ranking ties to the
   smallest song id) by one of the element-identical ranks:

   - dense: a (n_songs, delta_range) histogram (``dense_rank``);
   - sort: sort the packed (song, delta) keys, run-length count them and
     reduce per song with scatters (``sort_rank``);
   - scan: the same sort, then cumulative scans instead of scatters
     (``_scan_vote_rank``).

   (The JAX package's candidate-pruned rank is not ported: eager PyTorch
   cannot branch on its certificate without a host sync, so it would run
   the sort rank beside it and always return that rank's answer.)

The expansion and the dense and sort ranks take a (Bq, ...) stack of
queries, with the query index in the data, so that ``match/batched.py``
matches a batch in one dispatch; one query is a stack of one. The JAX
package switches from dense to the others past
``config.sparse_vote_threshold`` vote bins; so does the port, and every
caller picks one by name through ``match_by_rank``.

A spanned store (``index/devmerge.SpannedDeviceStore``) is matched by
``match_query_sparse_spanned``: every span's runs expand into one vote
stream (``expand_spans_stack``), ranked as one index's would be.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..index.search import lexi_bounds
from ..index.store import DeviceIndex
from ..profiling import spanned

_SENT = 0x7FFFFFFF     # int32 max: sorts after every packed vote key
_CLIP_SHIFT = 31       # vote keys are < 2^31 (check_vote_key)


def check_vote_key(n_songs: int, delta_range: int) -> None:
    """Reject catalogs whose flat (song, delta) vote key overflows int32
    (the JAX package's bound; both packages refuse the same configs)."""
    if n_songs * delta_range >= 1 << 31:
        raise ValueError(
            f"n_songs * delta_range = {n_songs * delta_range} overflows the "
            "int32 vote key (>= 2^31): votes would be attributed to wrong "
            "songs.")


class RawMatch(NamedTuple):
    """Match result: tensors on the device, or numpy/int after
    ``raw_to_host``.

    ``n_dropped``/``runner_votes`` power the provably-exact early accept:
    the expansion includes whole runs shortest-first, and each excluded
    run (one query hash's rows, all distinct (song, offset)) adds at most
    one vote to any (song, delta) bin, so when ``top_votes[0] -
    runner_votes > n_dropped`` the top-1 song and its best delta equal the
    uncapped answer."""

    top_songs: object     # (topn,) song ids
    top_deltas: object    # (topn,) best db_offset - q_offset per song
    top_votes: object     # (topn,) aligned vote count
    row_counts: object    # (topn,) dedup_hashes per top song
    total_rows: object    # true expanded match count
    n_ranked: object      # songs with >= 1 vote
    n_dropped: object     # runs excluded by the capacity budget
    runner_votes: object  # strongest challenger's count


def _scatter(size: int, idx, src, reduce: str, fill: int = 0):
    """``jnp.zeros(size).at[idx].<reduce>(src, mode="drop")``: indices
    outside [0, size) land in one extra dump slot that is cut off. ``idx``
    and ``src`` of any matching shape scatter element by element."""
    dev = src.device
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=dev)
    safe = torch.where((idx >= 0) & (idx < size), idx, size).reshape(-1)
    src = src.to(torch.int64).reshape(-1)
    if reduce == "sum":
        out.index_add_(0, safe, src)
    else:
        out.scatter_reduce_(0, safe, src, reduce=reduce, include_self=True)
    return out[:size]


def _desc(values):
    """(values, indices) in ``lax.top_k`` order: descending, ties to the
    smallest index."""
    return torch.sort(values, descending=True, stable=True)


def _at(x, i):
    """``x[i]`` for a 0-dim index tensor ``i`` without a host sync (a 0-dim
    tensor index is read back with ``.item()``; a 1-element one is not)."""
    return x[i.reshape(1)][0]


def _zero(like):
    """An int64 0 on ``like``'s device, filled there (a Python scalar
    turned into a CUDA tensor is a synchronous host-to-device copy)."""
    return torch.zeros((), dtype=torch.int64, device=like.device)


def _bounds(index: DeviceIndex, q_hi, q_lo, q_ex, q_valid, bounds):
    if bounds is not None:
        return bounds
    return lexi_bounds(index, q_hi, q_lo, q_ex, q_valid)


def _slots_to_runs(cum_inc, n_slots: int):
    """Per query, stream slot v -> (run p, v's place in run p, v) where run
    p holds slot v: p = #{i: cum_inc[i] <= v}, one batched searchsorted."""
    bq, n_runs = cum_inc.shape
    v = torch.arange(n_slots, device=cum_inc.device).expand(bq, n_slots)
    p = torch.searchsorted(cum_inc, v.contiguous(), right=True)
    p = torch.clamp(p, max=n_runs - 1)
    prev = torch.where(p > 0, cum_inc.gather(1, torch.clamp(p - 1, min=0)), 0)
    return p, v - prev, v


def _expand_rows(index: DeviceIndex, lb, ub, lens, q_t, *,
                 match_capacity: int):
    """Row-by-row expansion of a (Bq, Q) stack: per query, whole runs
    shortest-first (stable: equal lengths keep lane order) until the
    budget is spent."""
    order = torch.argsort(lens, dim=1, stable=True)
    lens_s = lens.gather(1, order)
    included = torch.cumsum(lens_s, 1) <= match_capacity
    n_dropped = ((lens_s > 0) & ~included).sum(1)
    cum_inc = torch.cumsum(torch.where(included, lens_s, 0), 1)
    p, within, v = _slots_to_runs(cum_inc, match_capacity)
    row = lb.gather(1, order).gather(1, p) + within
    valid = v < cum_inc[:, -1:]
    p = order.gather(1, p)
    packed = index.payload[torch.where(valid, row, 0)]
    sid = packed // index.stride
    delta = packed % index.stride - q_t.gather(1, p)
    return sid, delta, p, valid, n_dropped


def _expand_blocks(index: DeviceIndex, lb, ub, lens, q_t, *,
                   block_size: int, match_capacity: int, max_runs: int):
    """The expansion's contract, reading whole aligned ``block_size``-row
    blocks of the payload (its (N/B, B) view) instead of single rows.

    Runs are included whole, shortest-first in block units, while both
    the block budget ``match_capacity // B + 2 * R`` (alignment wastes at
    most two partial blocks per run) and the row budget
    ``match_capacity`` hold, where ``R = min(n_lanes, max_runs or
    n_lanes)``; nonempty runs past the shortest-first ``R`` are dropped
    too. Every excluded run counts in ``n_dropped``, so "total <=
    capacity and nonempty runs <= R => nothing dropped" holds, and
    included live rows never exceed ``match_capacity`` (the ranks sort
    and keep that prefix). Returns ``cap_blocks * B`` slots per query;
    ``p`` is constant within each block.
    """
    B = block_size
    payload = index.payload
    if payload.shape[0] % B:
        raise ValueError(
            f"payload rows {payload.shape[0]} not a multiple of the block "
            f"size {B}")
    bq, n_runs = lens.shape
    b0 = lb // B
    nblk = torch.where(lens > 0, (ub + B - 1) // B - b0, 0)
    order = torch.argsort(nblk, dim=1, stable=True)
    nblk_s = nblk.gather(1, order)
    runs_budget = min(n_runs, max_runs) if max_runs else n_runs
    cap_blocks = match_capacity // B + 2 * runs_budget
    nonempty = nblk_s > 0
    included = ((torch.cumsum(nblk_s, 1) <= cap_blocks)
                & (torch.cumsum(lens.gather(1, order), 1) <= match_capacity))
    if runs_budget < n_runs:
        included &= torch.cumsum(nonempty.long(), 1) <= runs_budget
    n_dropped = (nonempty & ~included).sum(1)
    cum_inc = torch.cumsum(torch.where(included, nblk_s, 0), 1)
    pb, within, v = _slots_to_runs(cum_inc, cap_blocks)
    blk = b0.gather(1, order).gather(1, pb) + within
    blk_valid = v < cum_inc[:, -1:]
    run = order.gather(1, pb)                  # owning run (= lane)

    safe_blk = torch.where(blk_valid, blk, 0)
    rows = payload.view(-1, B)[safe_blk]       # (Bq, cap_blocks, B)
    g = safe_blk[..., None] * B + torch.arange(B, device=lens.device)
    valid = (blk_valid[..., None] & (g >= lb.gather(1, run)[..., None])
             & (g < ub.gather(1, run)[..., None]))
    sid = torch.where(valid, rows // index.stride, 0)
    delta = torch.where(
        valid, rows % index.stride - q_t.gather(1, run)[..., None], 0)
    p = run[..., None].expand(bq, cap_blocks, B)
    return (sid.reshape(bq, -1), delta.reshape(bq, -1), p.reshape(bq, -1),
            valid.reshape(bq, -1), n_dropped)


def expand_stack(index: DeviceIndex, lb, ub, q_t, q_valid, *,
                 match_capacity: int, expand_block: int = 0,
                 expand_runs: int = 0):
    """Fixed-capacity expansion of a (Bq, Q) stack of searched queries.

    Returns (sid, delta, p, valid, total, n_dropped): per vote slot (Bq,
    slots) the song id, offset delta, owning query lane and validity; per
    query (Bq,) the exact total match count (even when the budget clamps)
    and the number of excluded runs. ``expand_block`` reads the rows as
    aligned blocks (``_expand_blocks``).
    """
    lens = torch.where(q_valid, ub - lb, 0)
    q_t = q_t.to(torch.int64)
    if expand_block:
        out = _expand_blocks(index, lb, ub, lens, q_t, block_size=expand_block,
                             match_capacity=match_capacity,
                             max_runs=expand_runs)
    else:
        out = _expand_rows(index, lb, ub, lens, q_t,
                           match_capacity=match_capacity)
    sid, delta, p, valid, n_dropped = out
    return sid, delta, p, valid, lens.sum(1), n_dropped


def _expand(index: DeviceIndex, q_hi, q_lo, q_ex, q_t, q_valid, *,
            match_capacity: int, expand_block: int = 0,
            expand_runs: int = 0, bounds=None):
    """Search + ``expand_stack`` of one query (a stack of one): flat
    (slots,) arrays and 0-dim total and n_dropped. ``bounds`` reuses an
    earlier search's per-lane (lb, ub)."""
    lb, ub = _bounds(index, q_hi, q_lo, q_ex, q_valid, bounds)
    out = expand_stack(index, lb[None], ub[None], q_t[None], q_valid[None],
                       match_capacity=match_capacity,
                       expand_block=expand_block, expand_runs=expand_runs)
    return tuple(a[0] for a in out)


def _take_first(q_first, p, expand_block: int):
    """``q_first[p]`` over the vote stream: one gather per block when the
    stream is blocked (``p`` is constant within a block)."""
    if expand_block and p.shape[0] % expand_block == 0:
        pair_blk = p.view(-1, expand_block)[:, 0]
        return q_first[pair_blk][:, None].expand(-1, expand_block).reshape(-1)
    return q_first[p]


def _pad_top(top_songs, top_votes, topn: int):
    """Catalogs smaller than topn: pad with song 0 and zero votes."""
    k = top_songs.shape[1]
    if k < topn:
        pad = top_songs.new_zeros((top_songs.shape[0], topn - k))
        top_songs = torch.cat([top_songs, pad], 1)
        top_votes = torch.cat([top_votes, pad.to(top_votes.dtype)], 1)
    return top_songs, top_votes


def dense_rank(sid, delta, first, valid, total, n_dropped, *, n_songs: int,
               delta_min: int, delta_range: int, topn: int) -> RawMatch:
    """The dense rank of a (Bq, slots) stack of vote streams: one flat
    (Bq * n_songs * delta_range) int32 histogram, read back only at the
    bins the streams touched. Only those bins are zeroed first: a pass
    over the whole buffer (a fill, a max) splits into more launches once
    it passes 2 GB, and its cost grows with the catalog rather than the
    stream. Untouched bins hold 0 votes, which the per-song maxima and
    the winner's second bin need not read (delta_range >= 2). Out-of-
    window deltas and ids past n_songs are dropped, like the JAX package's
    ``.at[].add(mode="drop")``."""
    bq = sid.shape[0]
    dev = sid.device
    clip = torch.arange(bq, device=dev)[:, None]
    dbin = delta - delta_min
    ok = valid & (dbin >= 0) & (dbin < delta_range) & (sid < n_songs)
    cells = n_songs * delta_range
    flat = torch.where(ok, clip * cells + sid * delta_range + dbin,
                       0).reshape(-1)
    hist = torch.empty(bq * cells, dtype=torch.int32, device=dev)
    hist.index_fill_(0, flat, 0)   # a scalar, not a host tensor: no sync
    hist.index_add_(0, flat, ok.reshape(-1).to(torch.int32))
    count = torch.where(ok, hist[flat].view(ok.shape), 0)
    first_ok = valid & first & (sid < n_songs)
    rows_hist = torch.zeros(bq * n_songs, dtype=torch.int32, device=dev)
    rows_hist.index_add_(
        0, torch.where(first_ok, clip * n_songs + sid, 0).reshape(-1),
        first_ok.reshape(-1).to(torch.int32))
    rows_hist = rows_hist.view(bq, n_songs)

    song_at = torch.where(ok, clip * n_songs + sid, -1)
    votes = _scatter(bq * n_songs, song_at, count, "amax").view(bq, n_songs)
    back = votes.gather(1, torch.where(ok, sid, 0))
    # first max: the smallest delta bin; a song without votes keeps bin 0
    best_bin = _scatter(bq * n_songs, song_at,
                        torch.where(ok & (count == back), dbin, _SENT),
                        "amin", fill=_SENT).view(bq, n_songs)
    best_bin = torch.where(best_bin == _SENT, 0, best_bin)
    # stable descending sort: equal votes keep ascending song order, the
    # smallest-index tie rule of lax.top_k
    vals, order = _desc(votes)
    k = min(topn, n_songs)
    top_songs, top_votes = _pad_top(order[:, :k], vals[:, :k], topn)
    top_deltas = best_bin.gather(1, top_songs) + delta_min
    row_counts = rows_hist.gather(1, top_songs)
    n_ranked = (votes > 0).sum(1)
    # strongest challenger: the 2nd-ranked song, and the winner's own 2nd-
    # best delta bin (a tie within the song makes the delta fragile)
    second_song = vals[:, 1] if n_songs > 1 else votes.new_zeros(bq)
    win = top_songs[:, :1]
    is_second = ok & (sid == win) & (dbin != best_bin.gather(1, win))
    second_bin = torch.where(is_second, count, 0).max(dim=1).values
    runner = torch.maximum(second_song, second_bin)
    return RawMatch(top_songs, top_deltas, top_votes, row_counts, total,
                    n_ranked, n_dropped, runner)


def sort_rank(sid, delta, first, valid, total, n_dropped, *, n_songs: int,
              delta_min: int, delta_range: int, topn: int,
              prefix: int = 0) -> RawMatch:
    """Sort + run-length vote count + rank of a (Bq, slots) stack of vote
    streams, with no (n_songs, delta_range) table: one sort of (query,
    vote key) composite keys, O(stream) work plus two O(Bq * n_songs)
    arrays. ``prefix``: every live key of a blocked stream sorts into its
    first ``prefix`` slots, so the passes after the sort run there."""
    bq, cap = sid.shape
    dev = sid.device
    clip = torch.arange(bq, device=dev)[:, None]
    dbin = delta - delta_min
    # ids past n_songs are non-votes, as in the scatters that follow
    vote_ok = (valid & (dbin >= 0) & (dbin < delta_range) & (sid >= 0)
               & (sid < n_songs))
    key = torch.where(vote_ok, sid * delta_range + dbin, _SENT)
    top = clip << _CLIP_SHIFT
    ks = (torch.sort((key + top).reshape(-1)).values.view(bq, cap) - top)
    if prefix and prefix < cap:
        ks = ks[:, :prefix]
        cap = prefix
    live = ks != _SENT
    change = torch.ones_like(live)
    change[:, 1:] = ks[:, 1:] != ks[:, :-1]
    seg_id = torch.cumsum((live & change).long(), 1) - 1
    seg = clip * cap + torch.where(live, seg_id, cap - 1)
    counts_seg = _scatter(bq * cap, seg, live, "sum").view(bq, cap)
    key_seg = _scatter(bq * cap, seg, torch.where(live, ks, _SENT), "amin",
                       fill=_SENT).view(bq, cap)

    seg_live = key_seg != _SENT
    song_seg = torch.where(seg_live, key_seg // delta_range, n_songs)
    dbin_seg = torch.where(seg_live, key_seg % delta_range, 0)
    song_at = torch.where(seg_live, clip * n_songs + song_seg, -1)
    votes = _scatter(bq * n_songs, song_at, counts_seg, "amax").view(
        bq, n_songs)
    back = votes.gather(1, torch.clamp(song_seg, max=n_songs - 1))
    is_best = seg_live & (counts_seg == back)
    best_bin = _scatter(bq * n_songs, song_at,
                        torch.where(is_best, dbin_seg, _SENT), "amin",
                        fill=_SENT).view(bq, n_songs)
    sid_at = torch.where((sid >= 0) & (sid < n_songs), clip * n_songs + sid,
                         -1)
    rows_hist = _scatter(bq * n_songs, sid_at, valid & first, "sum").view(
        bq, n_songs)

    k = min(topn, n_songs)
    vals, order = _desc(votes)
    top_songs, top_votes = _pad_top(order[:, :k], vals[:, :k], topn)
    bb = best_bin.gather(1, top_songs)
    # zero-vote songs (catalogs smaller than topn): the dense rank gives
    # bin 0 -> delta_min; mirror it
    top_deltas = torch.where(bb == _SENT, 0, bb) + delta_min
    row_counts = rows_hist.gather(1, top_songs)
    n_ranked = (votes > 0).sum(1)

    # strongest challenger (see dense_rank), from the segment arrays
    second_song = vals[:, 1] if n_songs >= 2 else votes.new_zeros(bq)
    win = top_songs[:, :1]
    is_second = (song_seg == win) & (dbin_seg != best_bin.gather(1, win))
    second_bin = torch.where(is_second, counts_seg, 0).max(dim=1).values
    runner = torch.maximum(second_song, second_bin)
    return RawMatch(top_songs, top_deltas, top_votes, row_counts, total,
                    n_ranked, n_dropped, runner)


def accumulate_votes(hist, rows_hist, sid, delta, first, valid, *,
                     delta_min: int, live=None) -> None:
    """Add one vote stream into a dense (n_songs, delta_range) int32 vote
    histogram and its (n_songs,) dedup row counts, in place: the JAX
    package's ``match_local`` summed into running totals. Out-of-window
    deltas and ids past n_songs are dropped (``mode="drop"``). ``live``, a
    0-dim bool on the device, gates the whole stream without a host sync:
    when False it adds nothing."""
    n_songs, delta_range = hist.shape
    dbin = delta - delta_min
    song_ok = valid & (sid >= 0) & (sid < n_songs)
    if live is not None:
        song_ok = song_ok & live
    ok = song_ok & (dbin >= 0) & (dbin < delta_range)
    hist.view(-1).index_add_(0, torch.where(ok, sid * delta_range + dbin, 0),
                             ok.to(torch.int32))
    row = song_ok & first
    rows_hist.index_add_(0, torch.where(row, sid, 0), row.to(torch.int32))


def match_local(index: DeviceIndex, q_hi, q_lo, q_ex, q_t, q_valid, q_first,
                *, n_songs: int, delta_min: int, delta_range: int,
                match_capacity: int):
    """The JAX package's ``match_local``: one (shard of the) index's dense
    votes before any ranking. Returns (hist, rows_hist, total, n_dropped):
    the (n_songs, delta_range) int32 vote histogram, the (n_songs,) int32
    dedup row counts, the exact expanded match count and the number of
    runs the capacity excluded, the last two 0-dim int64. The sharded
    matchers sum these over ranks before ranking (``n_dropped`` sums
    soundly: an excluded run anywhere adds at most one vote to any bin)."""
    check_vote_key(n_songs, delta_range)
    sid, delta, p, valid, total, n_dropped = _expand(
        index, q_hi, q_lo, q_ex, q_t, q_valid, match_capacity=match_capacity)
    dev = sid.device
    hist = torch.zeros((n_songs, delta_range), dtype=torch.int32, device=dev)
    rows_hist = torch.zeros(n_songs, dtype=torch.int32, device=dev)
    accumulate_votes(hist, rows_hist, sid, delta, q_first[p], valid,
                     delta_min=delta_min)
    return hist, rows_hist, total, n_dropped


def rank_votes(hist, rows_hist, total, *, delta_min: int, topn: int,
               n_dropped=None) -> RawMatch:
    """The JAX package's ``rank_votes``: per-song best delta (the first
    maximum, so the smallest delta) and the top-N with the reference's tie
    rules, over a dense (n_songs, delta_range) histogram, plus the
    strongest challenger of the early accept (see ``RawMatch``)."""
    n_songs = hist.shape[0]
    votes, best_bin = hist.max(1).values, hist.argmax(1)
    vals, order = _desc(votes)
    k = min(topn, n_songs)
    top_songs, top_votes = (a[0] for a in _pad_top(order[None, :k],
                                                   vals[None, :k], topn))
    top_deltas = best_bin[top_songs] + delta_min
    win = top_songs[:1]
    top_row = hist.index_select(0, win)[0]
    bins = torch.arange(hist.shape[1], device=hist.device)
    second_bin = torch.where(bins == best_bin[win], -1, top_row).max()
    second_song = vals[1] if n_songs > 1 else _zero(hist)
    if n_dropped is None:
        n_dropped = _zero(hist)
    return RawMatch(top_songs, top_deltas, top_votes, rows_hist[top_songs],
                    total, (votes > 0).sum(), n_dropped,
                    torch.maximum(second_song.to(torch.int64),
                                  second_bin.to(torch.int64)))


def _solo(rank, sid, delta, first, valid, total, n_dropped, **kw) -> RawMatch:
    """A stack rank on one flat vote stream: its (topn,) and 0-dim row."""
    if n_dropped is None:
        n_dropped = _zero(sid)
    raw = rank(*(torch.as_tensor(a)[None] for a in (sid, delta, first, valid,
                                                    total, n_dropped)), **kw)
    return RawMatch(*(a[0] for a in raw))


def match_query(index: DeviceIndex, q_hi, q_lo, q_ex, q_t, q_valid, q_first,
                *, n_songs: int, delta_min: int, delta_range: int,
                match_capacity: int = 65536, topn: int = 2) -> RawMatch:
    """Match padded query pairs against the sorted device index with the
    dense rank.

    :param q_*: query (hash, offset) pairs padded to a static length;
        ``q_valid`` masks real pairs; ``q_first`` marks the first pair of
        each distinct hash (for dedup row counting).
    :param delta_min: smallest representable delta (-max query offset).
    """
    check_vote_key(n_songs, delta_range)
    sid, delta, p, valid, total, n_dropped = _expand(
        index, q_hi, q_lo, q_ex, q_t, q_valid, match_capacity=match_capacity)
    return _solo(dense_rank, sid, delta, q_first[p], valid, total, n_dropped,
                 n_songs=n_songs, delta_min=delta_min,
                 delta_range=delta_range, topn=topn)


def _sparse_vote_rank(sid, delta, first, valid, total, n_dropped=None, *,
                      n_songs: int, delta_min: int, delta_range: int,
                      topn: int, prefix: int = 0) -> RawMatch:
    """``sort_rank`` of one flat vote stream."""
    return _solo(sort_rank, sid, delta, first, valid, total, n_dropped,
                 n_songs=n_songs, delta_min=delta_min,
                 delta_range=delta_range, topn=topn, prefix=prefix)


def _scan_vote_rank(sid, delta, first, valid, total, n_dropped=None, *,
                    n_songs: int, delta_min: int, delta_range: int,
                    topn: int, prefix: int = 0) -> RawMatch:
    """Scatter-free vote rank: one sort + cumulative scans, element-
    identical to ``_sparse_vote_rank``.

    1. sort the packed vote keys (``song * dr2 + dbin``, ``dr2`` the
       delta range rounded up to a power of two while the key fits
       int32: order-preserving, so every value is the same); invalid
       slots carry the sentinel and sort to the tail;
    2. a run's vote count is the distance to the next key boundary: a
       reverse cumulative minimum over (boundary ? index : cap);
    3. sorted order is the tie rule: the first position of the largest
       count is the smallest (song, dbin) holding it. Top-n repeats the
       argmax, masking each chosen song;
    4. dedup row counts, the challenger and the ranked-song count are
       masked reductions over the stream.
    """
    cap = sid.shape[0]
    dbin = delta - delta_min
    # song ids outside [0, n_songs) are non-votes: the scatter ranks drop
    # them, here they would form live runs
    vote_ok = (valid & (dbin >= 0) & (dbin < delta_range)
               & (sid >= 0) & (sid < n_songs))
    dr2 = 1 << max(int(delta_range) - 1, 0).bit_length()
    if n_songs * dr2 >= 1 << 31:
        dr2 = delta_range

    key = torch.where(vote_ok, sid * dr2 + dbin, _SENT)
    ks = torch.sort(key).values
    if prefix and prefix < cap:
        ks = ks[:prefix]
        cap = prefix
    live = ks != _SENT                      # a contiguous prefix
    idx = torch.arange(cap, device=ks.device)
    change = torch.ones_like(live)
    change[1:] = ks[1:] != ks[:-1]

    # next boundary strictly after i: reverse cummin of (change ? idx :
    # cap), shifted left one -- run [i, nxt[i]) for every run start i
    cand = torch.where(change, idx, cap)
    nxt_incl = torch.cummin(cand.flip(0), 0).values.flip(0)
    nxt = torch.cat([nxt_incl[1:], nxt_incl.new_full((1,), cap)])
    run_start = change & live
    count = torch.where(run_start, nxt - idx, 0)
    song = torch.where(live, ks // dr2, n_songs)
    db = ks % dr2

    k = min(topn, n_songs)
    zero = _zero(sid)
    tops, topd, topv = [], [], []
    masked = count
    for r in range(k):
        pos = torch.argmax(masked)          # first max: the tie rule
        v = _at(masked, pos)
        got = v > 0
        # zero-vote slots mirror top_k over an all-zero tail: the smallest
        # song id not chosen yet, at delta_min; each bump can collide with
        # an earlier winner, so re-scan until stable
        fallback = zero
        for _ in range(max(1, len(tops))):
            for prev in tops:
                fallback = torch.where(fallback == prev, fallback + 1,
                                       fallback)
        s_r = torch.where(got, _at(song, pos), fallback)
        tops.append(s_r)
        topd.append(torch.where(got, _at(db, pos), 0) + delta_min)
        topv.append(torch.clamp(v, min=0))
        if r + 1 < k:
            masked = torch.where(song == s_r, 0, masked)
    # dedup row counts of the reported songs (valid & first, not in-range:
    # mirrors rows_hist), over the unsorted stream
    vf = (valid & first).long()
    rcs = [torch.where(sid == s, vf, 0).sum() for s in tops]

    if k < topn:
        # catalogs smaller than topn: the sort rank pads with song 0 and
        # gathers song 0's best delta and row count for the padding
        pos0 = torch.argmax(torch.where(song == 0, count, -1))
        d0 = torch.where(_at(count, pos0) > 0, _at(db, pos0), 0) + delta_min
        rc0 = torch.where(sid == 0, vf, 0).sum()
        for _ in range(topn - k):
            tops.append(zero)
            topd.append(d0)
            topv.append(zero)
            rcs.append(rc0)
    top_songs = torch.stack(tops)
    top_deltas = torch.stack(topd)

    song_change = torch.ones_like(live)
    song_change[1:] = song[1:] != song[:-1]
    n_ranked = (run_start & song_change).sum()

    # strongest challenger (see dense_rank)
    win = top_songs[0]
    second_song = (torch.clamp(torch.where(song == win, 0, count).max(),
                               min=0) if n_songs >= 2 else zero)
    win_runs = run_start & (song == win) & (db != top_deltas[0] - delta_min)
    second_bin = torch.where(win_runs, count, 0).max()
    runner = torch.maximum(second_song, second_bin)
    if n_dropped is None:
        n_dropped = zero
    return RawMatch(top_songs, top_deltas, torch.stack(topv),
                    torch.stack(rcs), total, n_ranked, n_dropped, runner)


def _rank_by_name(vote_rank: str):
    """The element-identical sparse ranks by name: "sort" or "scan"."""
    if vote_rank == "sort":
        return _sparse_vote_rank
    if vote_rank == "scan":
        return _scan_vote_rank
    raise ValueError(f"unknown vote_rank {vote_rank!r} "
                     "(expected 'sort' or 'scan')")


def match_query_sparse(index: DeviceIndex, q_hi, q_lo, q_ex, q_t, q_valid,
                       q_first, *, n_songs: int, delta_min: int,
                       delta_range: int, match_capacity: int = 65536,
                       topn: int = 2, expand_block: int = 0,
                       expand_runs: int = 0, vote_rank: str = "sort",
                       bounds=None, with_bounds: bool = False):
    """``match_query`` without the dense histogram, for big catalogs:
    element-identical, with O(match_capacity) work.

    ``with_bounds=True`` also returns the per-lane search (lb, ub),
    computed once and shared with the expansion, so that a re-dispatch at
    a larger capacity can pass them back as ``bounds`` and skip the
    search.
    """
    check_vote_key(n_songs, delta_range)
    if with_bounds:
        bounds = _bounds(index, q_hi, q_lo, q_ex, q_valid, bounds)
    sid, delta, p, valid, total, n_dropped = _expand(
        index, q_hi, q_lo, q_ex, q_t, q_valid, match_capacity=match_capacity,
        expand_block=expand_block, expand_runs=expand_runs, bounds=bounds)
    first = _take_first(q_first, p, expand_block)
    raw = _rank_by_name(vote_rank)(
        sid, delta, first, valid, total, n_dropped, n_songs=n_songs,
        delta_min=delta_min, delta_range=delta_range, topn=topn,
        prefix=match_capacity if expand_block else 0)
    if with_bounds:
        return raw, bounds[0], bounds[1]
    return raw


@spanned("match.rank")
def match_by_rank(index: DeviceIndex, q_hi, q_lo, q_ex, q_t, q_valid,
                  q_first, *, rank: str, n_songs: int, delta_min: int,
                  delta_range: int, match_capacity: int = 65536,
                  topn: int = 2, expand_block: int = 0, expand_runs: int = 0,
                  bounds=None, with_bounds: bool = False):
    """One match dispatch by rank name, the choice every caller makes:
    "dense" (the histogram), "sort" or "scan". Returns a RawMatch,
    followed by the search (lb, ub) when ``with_bounds``."""
    q = (q_hi, q_lo, q_ex, q_t, q_valid, q_first)
    kw = dict(n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
              match_capacity=match_capacity, topn=topn)
    if rank == "dense":
        return match_query(index, *q, **kw)
    return match_query_sparse(
        index, *q, vote_rank=rank, expand_block=expand_block,
        expand_runs=expand_runs, bounds=bounds, with_bounds=with_bounds, **kw)


# ---- spanned stores (index/devmerge.SpannedDeviceStore) ------------------
def _is_stacked(spans) -> bool:
    """A consolidated store's one view of (n_spans, span_rows) columns,
    not a tuple of per-span views."""
    return isinstance(spans, DeviceIndex)


def span_bounds(stacked: DeviceIndex, q_hi, q_lo, q_ex, q_valid):
    """Span-local (lb, ub) of queries of any shape in every span of the
    stacked layout: (n_spans, *query shape), one batched search."""
    shape = q_hi.shape
    lb, ub = lexi_bounds(stacked, *(a.reshape(-1)
                                    for a in (q_hi, q_lo, q_ex, q_valid)))
    return lb.view(-1, *shape), ub.view(-1, *shape)


def expand_spans_stack(spans, q_hi, q_lo, q_ex, q_t, q_valid, *,
                       match_capacity: int, expand_block: int = 0,
                       expand_runs: int = 0, bounds=None):
    """``expand_stack`` of a (Bq, Q) query stack over a spanned store.

    Per-span views: each span is searched and expanded on its own, each
    clamped at ``match_capacity``, and the vote streams are concatenated
    to (Bq, n_spans * slots); ``span_max``, the largest per-span total, is
    the clamp signal. The stacked view: one batched search gives (n_spans,
    Bq, Q) span-local bounds, which become run bounds ``s * span_rows +
    row`` in the flat (n_spans * span_rows) payload, span-major (run ``s *
    Q + lane``), and every span's runs share ONE budget of
    ``match_capacity`` (blocked with ``expand_block``, under
    ``expand_runs * n_spans`` nonempty runs); the clamp signal is then the
    total. Returns (sid, delta, p, valid, total, span_max, n_dropped), ``p``
    the owning query lane."""
    if not _is_stacked(spans):
        if bounds is not None:
            raise ValueError("precomputed bounds need the stacked layout")
        shape = q_hi.shape
        parts = []
        for view in spans:
            lb, ub = lexi_bounds(view, *(a.reshape(-1) for a in
                                         (q_hi, q_lo, q_ex, q_valid)))
            parts.append(expand_stack(
                view, lb.view(shape), ub.view(shape), q_t, q_valid,
                match_capacity=match_capacity))
        sid, delta, p, valid = (torch.cat([x[i] for x in parts], 1)
                                for i in range(4))
        totals = torch.stack([x[4] for x in parts])
        n_dropped = torch.stack([x[5] for x in parts]).sum(0)
        return (sid, delta, p, valid, totals.sum(0), totals.max(0).values,
                n_dropped)
    n_spans, span_rows = spans.key64.shape
    if expand_block and span_rows % expand_block:
        raise ValueError(f"span_rows {span_rows} not a multiple of the block "
                         f"size {expand_block}")
    bq, n_q = q_hi.shape
    lb, ub = (bounds if bounds is not None
              else span_bounds(spans, q_hi, q_lo, q_ex, q_valid))
    base = (torch.arange(n_spans, device=lb.device) * span_rows)[:, None, None]
    lb, ub = ((x + base).permute(1, 0, 2).reshape(bq, n_spans * n_q)
              for x in (lb, ub))
    flat = DeviceIndex(None, None, spans.payload.reshape(-1), spans.n_rows,
                       spans.stride)
    sid, delta, p, valid, total, n_dropped = expand_stack(
        flat, lb, ub, q_t.repeat(1, n_spans), q_valid.repeat(1, n_spans),
        match_capacity=match_capacity, expand_block=expand_block,
        expand_runs=expand_runs * n_spans)
    return sid, delta, p % n_q, valid, total, total, n_dropped


def _expand_any_spans(spans, q_hi, q_lo, q_ex, q_t, q_valid, q_first, *,
                      match_capacity: int, expand_block: int = 0,
                      expand_runs: int = 0, bounds=None):
    """``expand_spans_stack`` of one query (a stack of one); the blocked
    expansion applies to the stacked layout only, as in the JAX package.
    Returns flat (sid, delta, first, valid) and 0-dim (total, span_max,
    n_dropped)."""
    blk = expand_block if _is_stacked(spans) else 0
    if bounds is not None:
        bounds = tuple(b[:, None] for b in bounds)
    out = expand_spans_stack(
        spans, *(a[None] for a in (q_hi, q_lo, q_ex, q_t, q_valid)),
        match_capacity=match_capacity, expand_block=blk,
        expand_runs=expand_runs, bounds=bounds)
    sid, delta, p, valid, total, span_max, n_dropped = (a[0] for a in out)
    return (sid, delta, _take_first(q_first, p, blk), valid, total, span_max,
            n_dropped)


def match_query_sparse_spanned(spans, q_hi, q_lo, q_ex, q_t, q_valid,
                               q_first, *, n_songs: int, delta_min: int,
                               delta_range: int, match_capacity: int = 65536,
                               topn: int = 2, offset_stride: int = 0,
                               heads=None, uviews=None, u_steps: int = 0,
                               vote_rank: str = "sort", expand_block: int = 0,
                               expand_runs: int = 0, bounds=None,
                               with_bounds: bool = False):
    """``match_query_sparse`` over a spanned store (``query_cols()`` of
    ``SpannedDeviceStore``: per-span views or the stacked one).

    A (song, delta) may have rows in any span, so every span is searched
    and their vote streams are ranked together: the rank sees the same
    multiset of votes as over one flat index, so the result is the flat
    match's whenever nothing was clamped. Returns (RawMatch, span_max):
    ``span_max`` is the clamp signal to hold against ``match_capacity``,
    the largest per-span count per span, the total when stacked (one
    shared budget, see ``expand_spans_stack``). ``with_bounds`` (stacked
    only) also returns the (n_spans, Q) bounds, for a re-dispatch to pass
    back as ``bounds``. ``offset_stride``, ``heads``, ``uviews`` and
    ``u_steps`` are accepted for the JAX signature and ignored: the views
    carry the stride, and the port's searches need no accelerator."""
    check_vote_key(n_songs, delta_range)
    stacked = _is_stacked(spans)
    if with_bounds and not stacked:
        raise ValueError("with_bounds needs the stacked layout")
    if with_bounds and bounds is None:
        bounds = span_bounds(spans, q_hi, q_lo, q_ex, q_valid)
    sid, delta, first, valid, total, span_max, n_dropped = _expand_any_spans(
        spans, q_hi, q_lo, q_ex, q_t, q_valid, q_first,
        match_capacity=match_capacity, expand_block=expand_block,
        expand_runs=expand_runs, bounds=bounds)
    raw = _rank_by_name(vote_rank)(
        sid, delta, first, valid, total, n_dropped, n_songs=n_songs,
        delta_min=delta_min, delta_range=delta_range, topn=topn,
        prefix=match_capacity if expand_block and stacked else 0)
    if with_bounds:
        return raw, span_max, bounds[0], bounds[1]
    return raw, span_max


@spanned("sia.readback")
def raw_to_host(raw: RawMatch, *extra: torch.Tensor):
    """One device->host copy of a RawMatch (and extra scalars).

    Returns (host RawMatch of numpy arrays / ints, [extra ints]).
    """
    topn = raw.top_songs.shape[0]
    flat = torch.cat([
        torch.stack([raw.top_songs, raw.top_deltas, raw.top_votes,
                     raw.row_counts]).to(torch.int64).reshape(-1),
        torch.stack([torch.as_tensor(s).to(torch.int64).reshape(())
                     for s in (*raw[4:], *extra)]),
    ]).cpu().numpy()
    cols = flat[: 4 * topn].reshape(4, topn)
    scalars = [int(s) for s in flat[4 * topn:]]
    host = RawMatch(*(np.ascontiguousarray(c) for c in cols), *scalars[:4])
    return host, scalars[4:]
