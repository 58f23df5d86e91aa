"""Million-track catalogs: song-sharded index + exact distributed ranking.

The port of ``shazam_tpu/parallel/bigcatalog.py``. Two sharding regimes
cover the catalog scale spectrum:

- **Key-range shards** (``mesh.shard_index_arrays`` + ``sharded.
  sharded_match_query``): balanced searches, votes combined with a
  dense-histogram sum over the group. The histogram is (n_songs x
  delta_range), so this tops out around 10^5 songs per card.
- **Song shards** (this module): every song's rows live entirely on one
  rank, sorted by key locally. Voting is then local: each rank builds a
  dense histogram over its own songs only and ranks its local top-N; one
  small ``dist.all_gather`` of (topn x n_shards) candidates and a
  replicated merge give the exact global ranking with the reference's
  tie rules.

Global song s lives on shard ``s % n_shards`` as local song
``s // n_shards`` (round-robin keeps the shards balanced as the catalog
grows).
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.devmerge import packed_stride_for
from ..match.lookup import RawMatch, _desc, match_local
from .mesh import Mesh, local_shard
from .sharded import all_gather_cat, all_sum, query_tensors


def effective_match_capacity(match_capacity: int, n_dev: int) -> int:
    """The by-song regime's true exactness bound: every shard expands
    with the full ``match_capacity``, so up to ``n_dev * match_capacity``
    rows vote exactly. Callers must align/escalate against THIS (a summed
    total above ``match_capacity`` alone does not mean rows dropped)."""
    return min(n_dev * match_capacity, 2 ** 31 - 2)


def pack_shard_rows(hi, lo, ex, sid, off, *, rows_per: int, stride: int,
                    n_local_songs: int):
    """One shard's sorted, padded uint32 column tuple: THE payload encoding
    of the JAX package's by-song layout and shard files (key pads are
    0xFFFFFFFF sentinels; payload is packed ``sid * stride + off`` with an
    out-of-range pad, or split sid/off columns when unpackable).
    """
    order = np.lexsort((ex, lo, hi))
    hi, lo, ex, sid, off = (a[order] for a in (hi, lo, ex, sid, off))

    def pad(a, fill):
        out = np.full(rows_per, fill, np.uint32)
        out[: len(a)] = a
        return out

    keys = (pad(hi, 0xFFFFFFFF), pad(lo, 0xFFFFFFFF), pad(ex, 0xFFFFFFFF))
    if stride:
        packed = sid.astype(np.uint32) * np.uint32(stride) \
            + off.astype(np.uint32)
        return keys + (pad(packed, np.uint32(
            min(n_local_songs * stride, 2 ** 32 - 1))),)
    return keys + (pad(sid.astype(np.uint32), n_local_songs), pad(off, 0))


def shard_index_by_song(index, n_shards: int):
    """Partition an index into per-shard sub-indices by song_id % n_shards.

    Returns (stacked_arrays, local_song_counts, stride): stacked arrays
    are (n_shards, rows) uint32 for (hi, lo, ex, payload-or-sid/off) with
    each shard's rows sorted by key, as the JAX package lays them out.
    """
    shard_of = index.song_id % n_shards
    local_sid = index.song_id // n_shards
    rows_per = max(
        int(np.max(np.bincount(shard_of, minlength=n_shards)))
        if index.n_hashes else 1,
        1,
    )
    stride = packed_stride_for(index.max_offset, index.n_songs)

    n_local_songs = -(-max(index.n_songs, 1) // n_shards)
    arrays = []
    for d in range(n_shards):
        sel = shard_of == d
        arrays.append(pack_shard_rows(
            index.key_hi[sel], index.key_lo[sel], index.key_ex[sel],
            local_sid[sel], index.offset[sel],
            rows_per=rows_per, stride=stride, n_local_songs=n_local_songs,
        ))

    stacked = tuple(
        np.stack([arrays[d][i] for d in range(n_shards)])
        for i in range(len(arrays[0]))
    )
    return stacked, n_local_songs, stride


def sharded_match_by_song(
    mesh: Mesh,
    stacked_index,            # this rank's DeviceIndex, or shard_index_by_song's
    n_local_songs: int,
    offset_stride: int,
    q_hi, q_lo, q_ex, q_t, q_valid, q_first,
    *,
    delta_min: int,
    delta_range: int,
    match_capacity: int = 65536,
    topn: int = 2,
    sharded_head=None,
) -> RawMatch:
    """Exact global top-N over a song-sharded catalog (replicated queries).

    Each rank votes over its own songs with the full ``match_capacity``,
    ranks its local top candidates (votes descending, ties to the smaller
    local id, as ``lax.top_k``), names them by global id ``local * n +
    rank``, and one gather of every rank's candidates is merged the same
    way on all ranks: sorted by song id (stable), then the top ``topn`` by
    votes. ``runner_votes`` is the winner's own votes: the winner's
    second-best delta bin lives only on its rank and is not gathered, so
    the margin is 0 and callers always escalate. ``sharded_head`` is
    accepted for the JAX signature and unused.
    """
    local = local_shard(mesh, stacked_index, offset_stride)
    q = query_tensors(mesh.device, q_hi, q_lo, q_ex, q_t, q_valid, q_first)
    hist, rows_hist, total, n_dropped = match_local(
        local, *q, n_songs=n_local_songs, delta_min=delta_min,
        delta_range=delta_range, match_capacity=match_capacity)
    n_dev = mesh.size
    cand = max(topn, 2)
    votes = hist.max(1).values.to(torch.int64)
    best_bin = hist.argmax(1)            # first max: the smallest delta
    k = min(cand, n_local_songs)         # tiny catalogs: fewer songs than topn
    top_v, top_s = (a[:k] for a in _desc(votes))
    if k < cand:
        top_v = torch.cat([top_v, top_v.new_zeros(cand - k)])
        top_s = torch.cat([top_s, top_s.new_zeros(cand - k)])
    local_rows = torch.stack([
        top_v, top_s * n_dev + mesh.rank, best_bin[top_s] + delta_min,
        rows_hist[top_s].to(torch.int64)], dim=1)          # (cand, 4)
    g_v, g_s, g_d, g_r = all_gather_cat(mesh, local_rows).T

    over = (total > match_capacity).to(torch.int64)
    n_ranked = (votes > 0).sum()
    total, any_over, n_ranked, n_dropped = all_sum(
        mesh, torch.stack([total, over, n_ranked, n_dropped]))
    eff_cap = effective_match_capacity(match_capacity, n_dev)
    total = torch.where(any_over > 0, torch.clamp(total, min=eff_cap + 1),
                        total)

    # reference tie rule: votes desc, song id asc: order the candidates by
    # song id (stable) before the stable descending vote sort
    order = torch.argsort(g_s, stable=True)
    g_v, g_s, g_d, g_r = (a[order] for a in (g_v, g_s, g_d, g_r))
    sel_v, sel_i = (a[:topn] for a in _desc(g_v))
    return RawMatch(g_s[sel_i], g_d[sel_i], sel_v, g_r[sel_i], total,
                    n_ranked, n_dropped, sel_v[0])
