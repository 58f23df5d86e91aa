"""Single-pass recognition: samples -> ranked songs without a host sync.

The two-dispatch path (fingerprint, host dedup via numpy, match) pays two
host<->device round trips plus host set arithmetic. This path keeps
everything on the device and reads back once:

1. fused fingerprint (K1 -> K2 -> K3 on CUDA),
2. query dedup on the device: sort the hash lanes by (hash, offset) with
   invalid lanes forced to the max key, then first-occurrence masks for
   unique (hash, offset) pairs and unique hashes (the reference's
   Python-set + mapper, ``recognizer.py:237-242,378-382``),
3. match + vote + rank against the device index (dense branch).
"""

from __future__ import annotations

import torch

from ..index.search import query_key64
from ..index.store import DeviceIndex
from ..ops.fingerprint import Fingerprints, fingerprint_batch_fused
from .lookup import match_query

_M32 = 0xFFFFFFFF


def _fingerprint_dedup(fp: Fingerprints, query_capacity: int):
    """One clip's fingerprint lanes -> sorted, deduped query lanes.

    Returns (sort_hi, lo, ex, t1, q_valid, q_first, n_pairs,
    n_hashes_total): the first ``query_capacity`` valid lanes (in lane
    order), sorted by (hash, offset) with invalid lanes last.
    """
    hi, lo, ex, t1, valid = (a[0] for a in fp[:5])
    n_hashes_total = valid.sum()

    # order-preserving compaction of the valid lanes to query_capacity
    n_lanes = hi.shape[0]
    cap = min(query_capacity, n_lanes)
    pos = torch.cumsum(valid.to(torch.int64), 0) - 1
    take = valid & (pos < cap)
    lane = torch.zeros(cap + 1, dtype=torch.int64, device=hi.device)
    lane.scatter_(0, torch.where(take, pos, cap),
                  torch.where(take, torch.arange(n_lanes, device=hi.device), 0))
    lane = lane[:cap]
    valid = torch.arange(cap, device=hi.device) < torch.clamp(n_hashes_total, max=cap)
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
                           sparse_threshold: int = 16_000_000):
    """Dedup + dense match of one clip's fingerprints (batch of 1).

    Returns (RawMatch, n_pairs, n_peaks, n_hashes_total), all tensors on
    the device. The caller checks n_hashes_total against query_capacity
    and n_peaks against the peak capacity.
    """
    if n_songs * delta_range > sparse_threshold:
        raise NotImplementedError(
            f"n_songs * delta_range = {n_songs * delta_range} exceeds "
            f"sparse_vote_threshold {sparse_threshold}: the sparse vote "
            "matchers are not ported yet")
    (sort_hi, lo, ex, t1, q_valid, q_first, n_pairs,
     n_hashes_total) = _fingerprint_dedup(fp, query_capacity)
    raw = match_query(index, sort_hi, lo, ex, t1, q_valid, q_first,
                      n_songs=n_songs, delta_min=delta_min,
                      delta_range=delta_range, match_capacity=match_capacity,
                      topn=topn)
    return raw, n_pairs, fp.n_peaks[0], n_hashes_total


def recognize_on_device(samples: torch.Tensor, n_valid: torch.Tensor,
                        index: DeviceIndex, *, fs: int = 44100,
                        wsize: int = 4096, hop: int = 2048,
                        amp_min: float = 10.0, radius: int = 10,
                        fan_value: int = 5, min_dt: int = 0,
                        max_dt: int = 200, peak_capacity: int = 4096,
                        n_songs: int, delta_min: int, delta_range: int,
                        match_capacity: int = 16384, topn: int = 2,
                        query_capacity: int = 4096,
                        sparse_threshold: int = 16_000_000):
    """(1, N) f32 clip, (1,) valid length -> (RawMatch, n_pairs, n_peaks,
    n_hashes_total) on the device; nothing is read back here."""
    n_frames_max = (samples.shape[1] - wsize) // hop + 1
    if n_frames_max > 1 << 16:
        raise ValueError(
            f"clip spans {n_frames_max} frames > 2^16: the packed (ex, t1) "
            "dedup sort key would alias offsets. Use recognize_samples for "
            "clips longer than ~51 minutes.")
    fp = fingerprint_batch_fused(
        samples, n_valid, fs=fs, wsize=wsize, hop=hop, amp_min=amp_min,
        radius=radius, fan_value=fan_value, min_dt=min_dt, max_dt=max_dt,
        peak_capacity=peak_capacity)
    return recognize_fingerprints(
        fp, index, n_songs=n_songs, delta_min=delta_min,
        delta_range=delta_range, match_capacity=match_capacity, topn=topn,
        query_capacity=query_capacity, sparse_threshold=sparse_threshold)
