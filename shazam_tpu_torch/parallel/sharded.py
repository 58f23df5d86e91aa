"""Key-range sharded matching and data-parallel ingest over a process group.

The port of ``shazam_tpu/parallel/sharded.py``. One rank holds one shard:

- **Index sharding**: the sorted index splits into contiguous key ranges,
  one per rank (``mesh.shard_index_arrays``); every rank owns a disjoint
  slice of hash space on its own device.
- **Query routing**: queries are replicated: every rank runs the search
  against its own range (a key that lives elsewhere yields an empty run).
- **Vote combine**: each rank's dense (n_songs, delta_range) vote
  histogram, dedup row counts, total, drop count and overflow flag are
  summed over the group (``dist.all_reduce``, the JAX package's
  ``lax.psum``), then every rank ranks identically (``rank_votes``).
- **Ingest**: data parallelism over songs: each rank fingerprints its
  contiguous block of rows with no communication, then the blocks are
  gathered so that every rank holds the batch's result.

Every function here is a collective: every rank of the mesh calls it
with the same arguments, and every decision that a later collective
depends on is taken from summed values only, so the ranks stay in
lockstep. A rank that would raise does so before its first collective.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..match.lookup import (RawMatch, _desc, match_local, rank_votes,
                            raw_to_host)
from ..ops.fingerprint import (Fingerprints, fingerprint_batch,
                               fingerprint_batch_fused, fused_takes)
from .mesh import Mesh, local_shard


def all_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the mesh's ranks, in place (``lax.psum``). It runs
    at a world size of 1 too, so a one-card run makes the same calls."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_gather_cat(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` concatenated in rank order along dim 0
    (``lax.all_gather`` then a reshape)."""
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts)


def query_tensors(device, q_hi, q_lo, q_ex, q_t, q_valid, q_first):
    """Query columns (numpy or tensors) on ``device``: keys and offsets as
    int64, the masks as bool."""
    def up(a, dtype):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=dtype)
        return torch.from_numpy(np.asarray(a).astype(
            np.int64 if dtype == torch.int64 else bool)).to(device)

    return ([up(a, torch.int64) for a in (q_hi, q_lo, q_ex, q_t)]
            + [up(a, torch.bool) for a in (q_valid, q_first)])


def _summed_votes(mesh: Mesh, local, q, *, n_songs: int, delta_min: int,
                  delta_range: int, per_shard_cap: int):
    """One shard's ``match_local`` summed over the mesh: (hist, rows_hist,
    total, n_dropped, ranks whose expansion passed ``per_shard_cap``)."""
    hist, rows_hist, total, n_dropped = match_local(
        local, *q, n_songs=n_songs, delta_min=delta_min,
        delta_range=delta_range, match_capacity=per_shard_cap)
    over = (total > per_shard_cap).to(torch.int64)
    all_sum(mesh, hist)
    small = all_sum(mesh, torch.cat([
        rows_hist.to(torch.int64), torch.stack([total, n_dropped, over])]))
    total, n_dropped, any_over = small[n_songs:]
    return hist, small[:n_songs], total, n_dropped, any_over


def effective_match_capacity(match_capacity: int, n_dev: int) -> int:
    """Key-range regime's exactness bound: the sum of per-shard caps
    (the 1024 floor makes it exceed ``match_capacity`` past
    match_capacity/1024 ranks)."""
    return min(max(match_capacity // n_dev, 1024) * n_dev, 2 ** 31 - 2)


def sharded_match_query(
    mesh: Mesh,
    sharded_index,          # this rank's DeviceIndex, or (n_shards, rows) arrays
    q_hi, q_lo, q_ex, q_t, q_valid, q_first,
    *,
    n_songs: int,
    delta_min: int,
    delta_range: int,
    match_capacity: int = 65536,
    topn: int = 2,
    offset_stride: int = 0,
    sharded_head=None,
) -> RawMatch:
    """Match a replicated query against a key-range-sharded index.

    ``sharded_index`` is this rank's shard (``mesh.shard_device_index``) or
    the JAX package's stacked arrays, of which the rank takes its row
    (``offset_stride`` decodes their payload). ``sharded_head`` is accepted
    for the JAX signature and unused: the port's search bounds are exact
    without a bucket head. Returns a RawMatch of tensors on the mesh's
    device, equal on every rank.

    Judge overflow/escalation against ``effective_match_capacity`` (the
    sum of per-shard caps), not ``match_capacity``: the per-shard floor
    means an exact result's summed total can exceed the nominal capacity
    on wide meshes. A hot shard that passes its own cap clamps the
    reported total above that bound."""
    per_shard_cap = max(match_capacity // mesh.size, 1024)
    local = local_shard(mesh, sharded_index, offset_stride)
    q = query_tensors(mesh.device, q_hi, q_lo, q_ex, q_t, q_valid, q_first)
    hist, rows_hist, total, n_dropped, any_over = _summed_votes(
        mesh, local, q, n_songs=n_songs, delta_min=delta_min,
        delta_range=delta_range, per_shard_cap=per_shard_cap)
    eff_cap = min(per_shard_cap * mesh.size, 2 ** 31 - 2)
    total = torch.where(any_over > 0, torch.clamp(total, min=eff_cap + 1),
                        total)
    return rank_votes(hist, rows_hist, total, delta_min=delta_min, topn=topn,
                      n_dropped=n_dropped)


def sharded_ingest_step(
    mesh: Mesh,
    batch,                       # (n_songs_batch, padded_len) int16/float32
    n_valid,                     # (n_songs_batch,) int32
    *,
    fs: int = 44100,
    wsize: int = 4096,
    hop: int = 2048,
    amp_min: float = 10.0,
    radius: int = 10,
    fan_value: int = 5,
    min_dt: int = 0,
    max_dt: int = 200,
    peak_capacity: int = 4096,
) -> Fingerprints:
    """Data-parallel fingerprinting: rank r takes the r-th contiguous block
    of rows (the batch must divide by the mesh's size), then the blocks are
    gathered, so every rank returns the whole batch's Fingerprints on its
    device.

    On the card the block goes through ``fingerprint_batch_fused`` (K1-K3)
    where the kernels take the configuration, as ``SIA`` does; on the CPU,
    and for other configurations, through the plain ``fingerprint_batch``,
    the JAX package's pipeline here. Pass ``batch`` as int16 for long
    ingests: it uploads at half the bytes and is cast on the device.
    """
    n_rows = len(batch)
    if n_rows % mesh.size:
        raise ValueError(f"batch of {n_rows} rows does not divide over "
                         f"{mesh.size} ranks")
    per = n_rows // mesh.size
    mine = slice(mesh.rank * per, (mesh.rank + 1) * per)

    def up(a):
        a = a[mine]
        return (a if isinstance(a, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(a))).to(mesh.device)

    x = up(batch).to(torch.float32)
    nv = up(n_valid)
    fp_fn = (fingerprint_batch_fused
             if mesh.device.type == "cuda" and fused_takes(wsize, hop, radius,
                                                           amp_min)
             else fingerprint_batch)
    fp = fp_fn(x, nv, fs=fs, wsize=wsize, hop=hop, amp_min=amp_min,
               radius=radius, fan_value=fan_value, min_dt=min_dt,
               max_dt=max_dt, peak_capacity=peak_capacity)
    lanes = torch.stack([fp.hi, fp.lo, fp.ex, fp.t1,
                         fp.valid.to(torch.int64)], dim=1)   # (per, 5, H)
    lanes = all_gather_cat(mesh, lanes)
    n_peaks = all_gather_cat(mesh, fp.n_peaks.to(torch.int64))
    return Fingerprints(lanes[:, 0], lanes[:, 1], lanes[:, 2], lanes[:, 3],
                        lanes[:, 4].bool(), n_peaks.to(torch.int32))


def _apriori_step(mesh: Mesh, local, q_batch, acc, *, n_songs: int,
                  delta_min: int, delta_range: int, per_shard_cap: int):
    """One apriori round on the key-range group: the batch's summed votes
    added into ``acc`` = [hist, rows, (total, n_dropped, overflows)], then
    the reference's margin signal, the top-2 vote-ranked songs' dedup row
    counts (``recognizer_apriori.py:296-310``), as two host ints."""
    hist, rows, scal = acc
    h, r, total, n_dropped, any_over = _summed_votes(
        mesh, local, q_batch, n_songs=n_songs, delta_min=delta_min,
        delta_range=delta_range, per_shard_cap=per_shard_cap)
    hist += h
    rows += r
    scal += torch.stack([total, n_dropped, any_over])
    top = _desc(hist.max(1).values)[1][:2]
    top2 = rows[top].tolist()
    return top2 + [0] * (2 - len(top2))


def sharded_match_apriori(
    mesh: Mesh,
    sharded_index,
    q,                       # QueryPairs (host)
    *,
    n_songs: int,
    delta_min: int,
    delta_range: int,
    match_capacity: int = 65536,
    topn: int = 2,
    batch_size: int = 1024,
    offset_stride: int = 0,
    sharded_head=None,
):
    """Key-range sharded match with the reference's 2x-leader early exit.

    Query pairs run in ``batch_size`` rounds; each round is a local search
    and expansion on every rank and one sum of the histogram over the
    group, and every rank applies the reference margin rule to the summed
    result between rounds, so all leave the loop at the same round. An
    exit skips the remaining rounds' searches and their sums.

    Cost model: a full sharded match pays one sum of the dense histogram;
    an apriori run pays one per round, so it wins when the exit fires
    early enough that the skipped search and expansion outweigh the extra
    sums. For never-matching clips it degrades to the full match plus
    (rounds - 1) sums.

    Returns (host RawMatch, rounds_used, clamped), the contract of
    ``match.apriori.match_query_apriori``: ``total_rows`` accumulates over
    the rounds; ``clamped`` is True iff a round passed a shard's
    expansion cap.
    """
    per_shard_cap = max(match_capacity // mesh.size, 1024)
    local = local_shard(mesh, sharded_index, offset_stride)
    dev = mesh.device
    acc = [torch.zeros((n_songs, delta_range), dtype=torch.int32, device=dev),
           torch.zeros(n_songs, dtype=torch.int64, device=dev),
           torch.zeros(3, dtype=torch.int64, device=dev)]

    n = max(int(q.n_pairs), 1)
    n_batches = max(1, -(-n // batch_size))
    used = 0
    for b in range(n_batches):
        sl = slice(b * batch_size, (b + 1) * batch_size)

        def pad(a):
            chunk = np.asarray(a)[sl]
            return np.pad(chunk, (0, batch_size - len(chunk)))

        q_batch = query_tensors(dev, *(pad(getattr(q, c)) for c in (
            "hi", "lo", "ex", "t", "valid", "first")))
        top2 = _apriori_step(mesh, local, q_batch, acc, n_songs=n_songs,
                             delta_min=delta_min, delta_range=delta_range,
                             per_shard_cap=per_shard_cap)
        used += 1
        if top2[0] / 2.0 > top2[1] and used < n_batches:
            break

    hist, rows, scal = acc
    raw = rank_votes(hist, rows, scal[0], delta_min=delta_min, topn=topn,
                     n_dropped=scal[1])
    host, (over,) = raw_to_host(raw, scal[2])
    return host, used, over > 0
