"""Single-pass recognition: samples -> ranked songs without a host sync.

The two-dispatch path (fingerprint, host dedup via numpy, match) pays two
host<->device round trips plus host set arithmetic. This path keeps
everything on the device and reads back once:

1. fingerprint: fused (K1 -> K2 -> K3 on CUDA) where ``use_fused``, the
   plain dB pipeline otherwise (configurations the kernels do not take),
   one row a channel (a stereo clip is one B = 2 call),
2. query dedup on the device: sort the hash lanes of every row by (hash,
   offset) with invalid lanes forced to the max key, then
   first-occurrence masks for unique (hash, offset) pairs and unique
   hashes (the reference's Python-set + mapper,
   ``recognizer.py:237-242,378-382``),
3. match + vote + rank against the device index with the rank the caller
   names (``match/tiers.rank_for``): the dense histogram, or past
   ``sparse_vote_threshold`` vote bins the sort or the scan rank.

``recognize_on_device`` also hands back the query, so that a clip whose
answer is not final goes on from it (``SIA._rematch``);
``recognize_on_device_spanned`` runs the three steps against a spanned
store.
"""

from __future__ import annotations

import torch

from ..index.search import query_key64
from ..index.store import DeviceIndex
from ..ops.fingerprint import (Fingerprints, fingerprint_batch,
                               fingerprint_batch_fused)
from ..profiling import span
from . import tiers
from .lookup import (_expand_any_spans, _is_stacked, _rank_by_name,
                     check_vote_key, match_by_rank)

_M32 = 0xFFFFFFFF


def _fingerprint_dedup(fp: Fingerprints, query_capacity: int):
    """One clip's fingerprint lanes, of its C channel rows -> sorted,
    deduped query lanes: the set union of the rows' (hash, offset) pairs
    (``recognizer.py:377-382``).

    Returns (sort_hi, lo, ex, t1, q_valid, q_first, n_pairs,
    n_hashes_total): the first ``query_capacity`` valid lanes (in
    row-major lane order; every lane where ``query_capacity`` holds the
    fingerprint's), sorted by (hash, offset) with invalid lanes last;
    ``n_hashes_total`` counts the valid lanes of every row.
    """
    with span("match.dedup", rows=fp.hi.shape[0],
              query_capacity=query_capacity):
        return _dedup_lanes(*(a.reshape(-1) for a in fp[:5]),
                            query_capacity)


def _dedup_lanes(hi, lo, ex, t1, valid, query_capacity: int):
    n_hashes_total = valid.sum()

    # order-preserving compaction of the valid lanes to query_capacity;
    # a capacity that holds every lane keeps them all, so the sort below
    # orders the valid ones alike without it
    n_lanes = hi.shape[0]
    cap = min(query_capacity, n_lanes)
    if cap < n_lanes:
        pos = torch.cumsum(valid.to(torch.int64), 0) - 1
        take = valid & (pos < cap)
        lane = torch.zeros(cap + 1, dtype=torch.int64, device=hi.device)
        lane.scatter_(0, torch.where(take, pos, cap),
                      torch.where(take, torch.arange(n_lanes,
                                                     device=hi.device), 0))
        lane = lane[:cap]
        valid = (torch.arange(cap, device=hi.device)
                 < torch.clamp(n_hashes_total, max=cap))
        hi, lo, ex, t1 = hi[lane], lo[lane], ex[lane], t1[lane]

    # sort by (hash, offset), invalid last: ex and the 16-bit frame offset
    # pack into one minor key (the caller bounds clips to 2^16 frames);
    # two stable sorts give the three-key order
    sort_hi = torch.where(valid, hi, _M32)
    ex_t1 = (ex << 16) | (t1 & 0xFFFF)
    perm = torch.argsort(ex_t1, stable=True)
    perm = perm[torch.argsort(query_key64(sort_hi, lo)[perm], stable=True)]
    sort_hi, lo, ex_t1, valid = sort_hi[perm], lo[perm], ex_t1[perm], valid[perm]
    ex = ex_t1 >> 16
    t1 = ex_t1 & 0xFFFF
    false = torch.zeros(1, dtype=torch.bool, device=hi.device)
    same_hash = torch.cat([false, (sort_hi[1:] == sort_hi[:-1])
                           & (lo[1:] == lo[:-1]) & (ex[1:] == ex[:-1])])
    same_pair = same_hash & torch.cat([false, t1[1:] == t1[:-1]])
    q_valid = valid & ~same_pair           # unique (hash, offset) pairs
    q_first = q_valid & ~same_hash         # first pair of each unique hash
    return (sort_hi, lo, ex, t1, q_valid, q_first, q_valid.sum(),
            n_hashes_total)


def recognize_fingerprints(fp: Fingerprints, index: DeviceIndex, *,
                           n_songs: int, delta_min: int, delta_range: int,
                           match_capacity: int = 16384, topn: int = 2,
                           query_capacity: int = 4096,
                           rank_candidates: int = 0,
                           sparse_threshold: int = 16_000_000,
                           vote_rank: str = "sort", expand_block: int = 0,
                           expand_runs: int = 0):
    """Dedup + match of one clip's fingerprints (one row a channel).

    Past ``sparse_threshold`` vote bins, ``vote_rank`` picks the sparse
    rank: "sort" or "scan". ``rank_candidates`` is the JAX signature's
    (its pruned rank's) and ignored. Returns (RawMatch, n_pairs, n_peaks,
    n_hashes_total), all tensors on the device, ``n_peaks`` the largest
    of the rows'. The caller checks n_hashes_total against
    query_capacity and n_peaks against the peak capacity.
    """
    sparse = tiers.is_sparse(n_songs, delta_range, sparse_threshold)
    return _match_fingerprints(
        fp, index, n_songs=n_songs, delta_min=delta_min,
        delta_range=delta_range, match_capacity=match_capacity, topn=topn,
        query_capacity=query_capacity,
        rank=vote_rank if sparse else "dense", expand_block=expand_block,
        expand_runs=expand_runs)[:4]


def _match_fingerprints(fp: Fingerprints, index: DeviceIndex, *,
                        n_songs: int, delta_min: int, delta_range: int,
                        match_capacity: int, topn: int, query_capacity: int,
                        rank: str, expand_block: int, expand_runs: int,
                        with_bounds: bool = False):
    """``recognize_fingerprints`` by rank name, also returning the deduped
    query ``q = (sort_hi, lo, ex, t1, q_valid, q_first)`` and,
    ``with_bounds`` (a sparse rank), the match's search (lb, ub), else
    None."""
    (sort_hi, lo, ex, t1, q_valid, q_first, n_pairs,
     n_hashes_total) = _fingerprint_dedup(fp, query_capacity)
    q = (sort_hi, lo, ex, t1, q_valid, q_first)
    out = match_by_rank(
        index, *q, rank=rank, n_songs=n_songs, delta_min=delta_min,
        delta_range=delta_range, match_capacity=match_capacity, topn=topn,
        expand_block=expand_block, expand_runs=expand_runs,
        with_bounds=with_bounds)
    raw, bounds = (out[0], out[1:]) if with_bounds else (out, None)
    return raw, n_pairs, fp.n_peaks.max(), n_hashes_total, q, bounds


def _fingerprint_clip(samples: torch.Tensor, n_valid: torch.Tensor, *,
                      fs: int, wsize: int, hop: int, amp_min: float,
                      radius: int, fan_value: int, min_dt: int, max_dt: int,
                      peak_capacity: int, use_fused: bool) -> Fingerprints:
    """The fingerprint of a (C, N) clip, one row a channel, fused or
    plain, refusing clips whose frame offsets do not fit the dedup's
    16-bit packing."""
    n_frames_max = (samples.shape[1] - wsize) // hop + 1
    if n_frames_max > 1 << 16:
        raise ValueError(
            f"clip spans {n_frames_max} frames > 2^16: the packed (ex, t1) "
            "dedup sort key would alias offsets. Use recognize_samples for "
            "clips longer than ~51 minutes.")
    fp_fn = fingerprint_batch_fused if use_fused else fingerprint_batch
    return fp_fn(
        samples, n_valid, fs=fs, wsize=wsize, hop=hop, amp_min=amp_min,
        radius=radius, fan_value=fan_value, min_dt=min_dt, max_dt=max_dt,
        peak_capacity=peak_capacity)


def recognize_on_device(samples: torch.Tensor, n_valid: torch.Tensor,
                        index: DeviceIndex, *, fs: int = 44100,
                        wsize: int = 4096, hop: int = 2048,
                        amp_min: float = 10.0, radius: int = 10,
                        fan_value: int = 5, min_dt: int = 0,
                        max_dt: int = 200, peak_capacity: int = 4096,
                        use_fused: bool = True, n_songs: int,
                        delta_min: int, delta_range: int,
                        match_capacity: int = 16384, topn: int = 2,
                        query_capacity: int = 4096, rank: str = "dense",
                        expand_block: int = 0, expand_runs: int = 0,
                        with_bounds: bool = False):
    """(C, N) f32 clip, (C,) valid lengths -> (RawMatch, n_pairs, n_peaks,
    n_hashes_total, q, bounds) on the device, matched with the rank named
    ``rank`` ("dense", "sort" or "scan"); nothing is read back here.
    Beside the answer it returns what the pass built, for a caller that
    goes on from it: the deduped query ``q = (sort_hi, lo, ex, t1,
    q_valid, q_first)`` and, ``with_bounds`` (a sparse rank), the match's
    search (lb, ub), else None.
    ``use_fused=False`` fingerprints with the plain ``fingerprint_batch``,
    for configurations outside the kernels' contract."""
    fp = _fingerprint_clip(
        samples, n_valid, fs=fs, wsize=wsize, hop=hop, amp_min=amp_min,
        radius=radius, fan_value=fan_value, min_dt=min_dt, max_dt=max_dt,
        peak_capacity=peak_capacity, use_fused=use_fused)
    return _match_fingerprints(
        fp, index, n_songs=n_songs, delta_min=delta_min,
        delta_range=delta_range, match_capacity=match_capacity, topn=topn,
        query_capacity=query_capacity, rank=rank, expand_block=expand_block,
        expand_runs=expand_runs, with_bounds=with_bounds)


def recognize_on_device_spanned(samples: torch.Tensor, n_valid: torch.Tensor,
                                span_arrays, *, fs: int = 44100,
                                wsize: int = 4096, hop: int = 2048,
                                amp_min: float = 10.0, radius: int = 10,
                                fan_value: int = 5, min_dt: int = 0,
                                max_dt: int = 200, peak_capacity: int = 4096,
                                n_songs: int, delta_min: int,
                                delta_range: int, match_capacity: int = 16384,
                                topn: int = 2, offset_stride: int = 0,
                                use_fused: bool = True,
                                query_capacity: int = 4096, heads=None,
                                rank_candidates: int = 0, uviews=None,
                                u_steps: int = 0, vote_rank: str = "sort",
                                expand_block: int = 0, expand_runs: int = 0):
    """``recognize_on_device`` against a spanned store's views
    (``SpannedDeviceStore.query_cols()``): fingerprint and dedup as there,
    then every span's expansion and one sparse rank, "sort" or "scan"
    (``lookup.match_query_sparse_spanned``'s). Returns (RawMatch,
    span_max, n_pairs, n_peaks, n_hashes_total) on the device; the caller
    holds ``span_max`` against ``match_capacity``. ``offset_stride``,
    ``heads``, ``rank_candidates``, ``uviews`` and ``u_steps`` are the JAX
    signature's and ignored."""
    # the ranks below take no guard of their own
    check_vote_key(n_songs, delta_range)
    fp = _fingerprint_clip(
        samples, n_valid, fs=fs, wsize=wsize, hop=hop, amp_min=amp_min,
        radius=radius, fan_value=fan_value, min_dt=min_dt, max_dt=max_dt,
        peak_capacity=peak_capacity, use_fused=use_fused)
    (sort_hi, lo, ex, t1, q_valid, q_first, n_pairs,
     n_hashes_total) = _fingerprint_dedup(fp, query_capacity)
    sid, delta, first, valid, total, span_max, n_dropped = _expand_any_spans(
        span_arrays, sort_hi, lo, ex, t1, q_valid, q_first,
        match_capacity=match_capacity, expand_block=expand_block,
        expand_runs=expand_runs)
    blocked = expand_block and _is_stacked(span_arrays)
    raw = _rank_by_name(vote_rank)(
        sid, delta, first, valid, total, n_dropped, n_songs=n_songs,
        delta_min=delta_min, delta_range=delta_range, topn=topn,
        prefix=match_capacity if blocked else 0)
    return raw, span_max, n_pairs, fp.n_peaks.max(), n_hashes_total
