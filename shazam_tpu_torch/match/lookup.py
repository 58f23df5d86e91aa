"""Query matching: index lookup + dense offset-delta histogram voting.

Replaces the reference's batched ``WHERE hash IN`` round trips
(``recognizer.py:222-271``), per-row vote expansion and the groupby
vote/rank of ``align_matches`` (``recognizer.py:289-338``) with tensor
ops that never sync the host:

1. ``lexi_bounds`` gives each query (hash, offset) pair its row run
   [lb, ub) in the sorted index;
2. runs are included whole, shortest first, into a fixed-capacity vote
   list (a slot maps back to its run by a marks + prefix sum);
3. votes add into a dense (n_songs, delta_range) histogram; per-song best
   delta = first argmax (smallest delta), ranking = stable descending
   sort (ties to the smallest song id), the reference's tie rules.

The dense branch only: past ``sparse_vote_threshold`` vote bins the JAX
package switches to sparse matchers, which are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..index.search import lexi_bounds
from ..index.store import DeviceIndex


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


def _expand(index: DeviceIndex, q_hi, q_lo, q_ex, q_t, q_valid, *,
            match_capacity: int):
    """Search + fixed-capacity row expansion.

    Returns (sid, delta, p, valid, total, n_dropped) per vote slot: song
    id, offset delta, owning query lane, validity, the exact total match
    count (even when the budget clamps) and the number of excluded runs.
    Whole runs are included shortest-first (stable: equal lengths keep
    lane order) until the budget is spent.
    """
    lb, ub = lexi_bounds(index, q_hi, q_lo, q_ex, q_valid)
    lens = torch.where(q_valid, ub - lb, 0)
    total = lens.sum()
    n_lanes = lens.shape[0]

    order = torch.argsort(lens, stable=True)
    lens_s = lens[order]
    lb_s = lb[order]
    included = torch.cumsum(lens_s, 0) <= match_capacity
    n_dropped = ((lens_s > 0) & ~included).sum()
    cum_inc = torch.cumsum(torch.where(included, lens_s, 0), 0)
    total_inc = cum_inc[-1]

    # slot v -> run #{i: cum_inc[i] <= v}: ones at the run ends + a prefix
    # sum; ends at >= capacity fall off (masked, not scattered)
    dev = lens.device
    in_range = cum_inc < match_capacity
    marks = torch.zeros(match_capacity, dtype=torch.int64, device=dev)
    marks.index_add_(0, torch.where(in_range, cum_inc, 0), in_range.long())
    p = torch.clamp(torch.cumsum(marks, 0), max=n_lanes - 1)
    prev = torch.where(p > 0, cum_inc[torch.clamp(p - 1, min=0)], 0)
    v = torch.arange(match_capacity, device=dev)
    row = lb_s[p] + (v - prev)
    valid = v < total_inc
    p = order[p]

    packed = index.payload[torch.where(valid, row, 0)]
    sid = packed // index.stride
    delta = packed % index.stride - q_t.to(torch.int64)[p]
    return sid, delta, p, valid, total, n_dropped


def match_local(index: DeviceIndex, q_hi, q_lo, q_ex, q_t, q_valid, q_first,
                *, n_songs: int, delta_min: int, delta_range: int,
                match_capacity: int):
    """(hist, rows_hist, total, n_dropped): the dense (n_songs,
    delta_range) int32 vote histogram, per-song dedup row counts, the
    exact match count and the budget-excluded runs."""
    check_vote_key(n_songs, delta_range)
    sid, delta, p, valid, total, n_dropped = _expand(
        index, q_hi, q_lo, q_ex, q_t, q_valid, match_capacity=match_capacity)
    # out-of-window deltas (and ids past n_songs) are dropped, like the
    # JAX package's .at[].add(mode="drop"): mask, then add 0 at bin 0
    dbin = delta - delta_min
    ok = valid & (dbin >= 0) & (dbin < delta_range) & (sid < n_songs)
    flat = torch.where(ok, sid * delta_range + dbin, 0)
    hist = torch.zeros(n_songs * delta_range, dtype=torch.int32,
                       device=sid.device)
    hist.index_add_(0, flat, ok.to(torch.int32))

    first_ok = valid & q_first[p] & (sid < n_songs)
    rows_hist = torch.zeros(n_songs, dtype=torch.int32, device=sid.device)
    rows_hist.index_add_(0, torch.where(first_ok, sid, 0),
                         first_ok.to(torch.int32))
    return hist.view(n_songs, delta_range), rows_hist, total, n_dropped


def rank_votes(hist, rows_hist, total, *, delta_min: int, topn: int,
               n_dropped=None) -> RawMatch:
    """Per-song best delta + top-N ranking with the reference tie rules."""
    votes = hist.max(dim=1).values
    best_bin = torch.argmax(hist, dim=1)  # first max => smallest delta
    # stable descending sort: equal votes keep ascending song order,
    # the smallest-index tie rule of lax.top_k
    order = torch.sort(votes, descending=True, stable=True).indices
    k = min(topn, votes.shape[0])
    top_songs = order[:k]
    top_votes = votes[top_songs]
    if k < topn:
        pad = torch.zeros(topn - k, dtype=top_songs.dtype, device=votes.device)
        top_songs = torch.cat([top_songs, pad])
        top_votes = torch.cat([top_votes, pad.to(top_votes.dtype)])
    top_deltas = best_bin[top_songs] + delta_min
    row_counts = rows_hist[top_songs]
    n_ranked = (votes > 0).sum()

    # strongest challenger: the 2nd-ranked song, and the winner's own
    # 2nd-best delta bin (a tie within the song makes the delta fragile)
    second_song = votes[order[1]] if votes.shape[0] > 1 else votes.new_zeros(())
    top_row = hist[top_songs[0]]
    bins = torch.arange(top_row.shape[0], device=hist.device)
    second_bin = torch.where(bins == best_bin[top_songs[0]], -1,
                             top_row).max()
    runner = torch.maximum(second_song, second_bin)
    if n_dropped is None:
        n_dropped = torch.zeros((), dtype=torch.int64, device=hist.device)
    return RawMatch(top_songs, top_deltas, top_votes, row_counts, total,
                    n_ranked, n_dropped, runner)


def match_query(index: DeviceIndex, q_hi, q_lo, q_ex, q_t, q_valid, q_first,
                *, n_songs: int, delta_min: int, delta_range: int,
                match_capacity: int = 65536, topn: int = 2) -> RawMatch:
    """Match padded query pairs against the sorted device index.

    :param q_*: query (hash, offset) pairs padded to a static length;
        ``q_valid`` masks real pairs; ``q_first`` marks the first pair of
        each distinct hash (for dedup row counting).
    :param delta_min: smallest representable delta (-max query offset).
    """
    hist, rows_hist, total, n_dropped = match_local(
        index, q_hi, q_lo, q_ex, q_t, q_valid, q_first, n_songs=n_songs,
        delta_min=delta_min, delta_range=delta_range,
        match_capacity=match_capacity)
    return rank_votes(hist, rows_hist, total, delta_min=delta_min, topn=topn,
                      n_dropped=n_dropped)


def query_total(index: DeviceIndex, q_hi, q_lo, q_ex, q_valid) -> torch.Tensor:
    """Exact total matched-row count of a query: one search, no expansion."""
    lb, ub = lexi_bounds(index, q_hi, q_lo, q_ex, q_valid)
    return torch.where(q_valid, ub - lb, 0).sum()


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
