"""Multi-process catalog spanning: song shards across processes.

The port of ``shazam_tpu/parallel/multihost.py``. A catalog larger than
one card spans processes, one rank per card:

- ``init_multihost`` starts the ``torch.distributed`` group (NCCL on the
  card, gloo on the CPU) at the coordinator's address; ``global_mesh`` is
  the mesh of every rank.
- ``SpannedCatalog`` holds the by-song regime (``bigcatalog.py``): each
  rank materializes only its own shard; the one collective per query is
  the small candidate gather (the histograms and searches are local).
- ``distributed_ingest_arrays`` spans the fingerprinting work itself:
  each rank decodes and fingerprints only its own songs (K1-K3 on the
  card), and the meta is agreed by one gather.

Deterministic layout contract: global song s lives on shard
``s % n_shards`` as local id ``s // n_shards``, and shard d is rank d.
Shard files are the JAX package's: ``shards_p{rank:03d}.npz`` with
``meta`` = [n_songs, max_offset, stride, n_shards, n_cols], ``shard_ids``
and uint32 ``col{c}`` of shape (shards held, rows).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..index.store import atomic_savez
from ..match.align import MatchResult, align_results
from ..match.lookup import raw_to_host
from ..match.prepare import QueryPairs, q_frames_for_max_offset
from .bigcatalog import (effective_match_capacity, pack_shard_rows,
                         shard_index_by_song, sharded_match_by_song)
from .mesh import backend_for, make_mesh, shard_device_index
from .sharded import all_gather_cat


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, *, backend: Optional[str] = None,
                   device="cuda") -> None:
    """Start the process group for catalog spanning.

    :param coordinator_address: "host:port" of process 0 (a TCP
        rendezvous; ``tcp://`` is prepended).
    :param backend: defaults to the device's one (NCCL for ``cuda``, gloo
        for ``cpu``); any other pairing raises.
    :param device: where this process's shard will live, as ``make_mesh``
        takes it.
    """
    want = backend_for(torch.device(device))
    if backend not in (None, want):
        raise ValueError(f"a {device} group runs {want}, not {backend}")
    dist.init_process_group(want, init_method="tcp://" + coordinator_address,
                            world_size=num_processes, rank=process_id)


def global_mesh(device="cuda"):
    """The one-axis mesh over every rank of every process."""
    return make_mesh(None, "shard", device=device)


class SpannedCatalog:
    """A by-song sharded catalog whose shards span processes."""

    def __init__(self, index_meta, mesh=None):
        """index_meta: (n_songs, max_offset, offset_stride), identical on
        every process (derived from the same catalog metadata)."""
        self.mesh = mesh or global_mesh()
        self.n_songs, self.max_offset, self._stride = index_meta
        self.n_shards = self.mesh.size
        self.n_local_songs = -(-max(self.n_songs, 1) // self.n_shards)
        self._cols = None     # this rank's (1, rows) uint32 columns
        self._shard = None    # and their search view on its device

    @classmethod
    def from_full_index(cls, index, mesh=None):
        """Every process holds the full index (small catalogs / tests):
        each keeps only the rows of its own shard."""
        cat = cls((index.n_songs, index.max_offset, 0), mesh=mesh)
        stacked, n_local, stride = shard_index_by_song(index, cat.n_shards)
        assert n_local == cat.n_local_songs
        cat._stride = stride
        cat._place_local(tuple(a[cat._my_shard_ids()] for a in stacked))
        return cat

    def _my_shard_ids(self) -> Sequence[int]:
        return [self.mesh.rank]

    def _place_local(self, local_stacked) -> None:
        """This rank's shard rows, (1, rows) uint32 arrays: kept for
        ``save_local_shards`` and uploaded as the search view."""
        self._cols = tuple(np.ascontiguousarray(a, np.uint32)
                           for a in local_stacked)
        self._shard = shard_device_index([c[0] for c in self._cols],
                                         self._stride, self.mesh.device)

    # ---- persistence: per-process shard files -------------------------
    def _path(self, dir_path: str) -> str:
        return os.path.join(dir_path, f"shards_p{self.mesh.rank:03d}.npz")

    def save_local_shards(self, dir_path: str) -> str:
        """Write THIS process's shard rows + meta to one npz, the JAX
        package's file: a spanned catalog restarts from these files (same
        process topology) without fingerprinting anything."""
        os.makedirs(dir_path, exist_ok=True)
        path = self._path(dir_path)
        atomic_savez(
            path,
            meta=np.array([self.n_songs, self.max_offset, self._stride,
                           self.n_shards, len(self._cols)], np.int64),
            # which global shard ids these rows belong to: a restart whose
            # process -> shard assignment differs would otherwise serve
            # every song under the wrong global id with no error
            shard_ids=np.asarray(self._my_shard_ids(), np.int64),
            **{f"col{c}": a for c, a in enumerate(self._cols)},
        )
        return path

    @classmethod
    def load_local_shards(cls, dir_path: str, mesh=None) -> "SpannedCatalog":
        mesh = mesh or global_mesh()
        path = os.path.join(dir_path, f"shards_p{mesh.rank:03d}.npz")
        with np.load(path) as z:
            meta = z["meta"]
            n_cols = int(meta[4])
            local = tuple(z[f"col{c}"] for c in range(n_cols))
            saved_ids = (z["shard_ids"].tolist()
                         if "shard_ids" in z.files else None)
        cat = cls((int(meta[0]), int(meta[1]), int(meta[2])), mesh=mesh)
        if cat.n_shards != int(meta[3]):
            raise ValueError(
                f"shard file was written for {int(meta[3])} shards, "
                f"mesh has {cat.n_shards}"
            )
        mine = sorted(cat._my_shard_ids())
        if saved_ids is not None and saved_ids != mine:
            # same shard count, another process -> shard assignment: these
            # rows would serve every song under the wrong global id
            raise ValueError(
                f"shard file holds global shards {saved_ids} but this "
                f"process owns {mine}: restart with the same process/"
                "device topology the catalog was saved under"
            )
        cat._place_local(local)
        return cat

    def match(self, q: QueryPairs, *, topn: int = 2,
              match_capacity: int = 65536, q_frames: Optional[int] = None,
              catalog=None, config=None) -> MatchResult:
        """Match prepared query pairs across every process's shard: a
        collective, every rank calls it with the same query.

        ``q_frames`` defaults to the smallest power-of-two window covering
        the query's max frame offset (>= 1024); pass it only to pin a
        window. The capacity escalates x4 against the by-song bound
        ``n_shards * cap`` (the total is summed, so every process takes
        the same branch).
        """
        from ..config import DEFAULT_CONFIG

        if q_frames is None:
            max_t = int(np.max(q.t[: q.n_pairs])) if q.n_pairs else 0
            q_frames = q_frames_for_max_offset(max_t)
        delta_min = -q_frames
        delta_range = self.max_offset + 2 * q_frames
        args = [q.hi, q.lo, q.ex, q.t, q.valid, q.first]
        cfg = config or DEFAULT_CONFIG
        cap, cap_max = match_capacity, cfg.match_capacity_max
        while True:
            raw = raw_to_host(sharded_match_by_song(
                self.mesh, self._shard, self.n_local_songs, self._stride,
                *args, delta_min=delta_min, delta_range=delta_range,
                match_capacity=cap, topn=topn))[0]
            total = int(raw.total_rows)
            if total <= effective_match_capacity(cap, self.n_shards) \
                    or cap >= cap_max:
                break
            while effective_match_capacity(cap, self.n_shards) < total \
                    and cap < cap_max:
                cap *= 4
            cap = min(cap, cap_max)
        return align_results(raw, q.n_pairs, catalog=catalog, config=cfg,
                             match_capacity=effective_match_capacity(
                                 cap, self.n_shards))


def distributed_ingest_arrays(
    song_names: Sequence[str],
    load_fn: Callable[[int], np.ndarray],
    config=None,
    mesh=None,
    batch_size: int = 8,
    song_peak_capacity: Optional[int] = None,
    chunk_songs: int = 32,
) -> Tuple["SpannedCatalog", "object"]:
    """Shard the fingerprinting work itself across processes.

    Every process receives the same ``song_names`` (global song id = list
    position); it decodes and fingerprints ONLY the songs of its own
    shard (``s % n_shards == rank``), through a local ``SIA`` on the
    mesh's device (K1-K3 on the card), in O(chunk) host memory, then
    places its shard rows on its device. One gather agrees the meta.

    Byte-identical duplicate audio is deduped per process only (the
    SHA-1 resume dedup sees one process's songs); dedupe the list
    globally first if that matters.
    :param load_fn: global song id -> mono samples (int16/float32);
        called only for songs this process owns.
    :returns: (SpannedCatalog ready to ``match``, local SIA whose catalog
        holds THIS process's songs).
    """
    from ..api import SIA
    from ..config import DEFAULT_CONFIG

    if len(set(song_names)) != len(song_names):
        raise ValueError("song names must be unique (they key the id remap)")

    mesh = mesh or global_mesh()
    n_shards = mesh.size
    n_songs = len(song_names)
    cat = SpannedCatalog((n_songs, 0, 0), mesh=mesh)  # meta fixed below
    mine = set(cat._my_shard_ids())
    owned = [s for s in range(n_songs) if s % n_shards in mine]

    # ---- local fingerprint pass (streaming, O(chunk) host audio) ----
    local = SIA(config or DEFAULT_CONFIG, device=mesh.device)
    for base in range(0, len(owned), chunk_songs):
        part = [(song_names[s], load_fn(s))
                for s in owned[base:base + chunk_songs]]
        local.ingest_arrays(part, batch_size=batch_size,
                            song_peak_capacity=song_peak_capacity)
    ix = local.index
    sid_of_name = {d["song_name"]: d["song_id"]
                   for d in local.catalog.get_songs()}
    remap = np.zeros(max(sid_of_name.values(), default=0) + 1, np.uint32)
    for s in owned:
        sid = sid_of_name.get(song_names[s])
        if sid is None:
            # byte-identical duplicate: ingest_arrays dedups by sample
            # SHA-1, so this name owns no rows
            continue
        remap[sid] = s
    gsid = remap[ix.song_id] if ix.n_hashes else ix.song_id

    # ---- agree on global meta (one small gather at ingest) ----
    shard_of = gsid % n_shards if ix.n_hashes else gsid
    counts = np.bincount(shard_of, minlength=n_shards) if ix.n_hashes \
        else np.zeros(n_shards, np.int64)
    g = all_gather_cat(mesh, torch.tensor(
        [[int(ix.max_offset), int(counts.max() if len(counts) else 0)]],
        dtype=torch.int64, device=mesh.device)).cpu().numpy()
    gmax_off = int(g[:, 0].max())
    rows_per = max(int(g[:, 1].max()), 1)
    stride = 1
    while stride <= gmax_off:
        stride <<= 1
    if max(n_songs, 1) * stride > (1 << 32):
        stride = 0

    # ---- build MY shard's padded sorted rows (bigcatalog layout) ----
    local_sid = (gsid // n_shards).astype(np.uint32)
    per_shard = []
    for d in sorted(mine):
        sel = shard_of == d
        per_shard.append(pack_shard_rows(
            ix.key_hi[sel], ix.key_lo[sel], ix.key_ex[sel],
            local_sid[sel], ix.offset[sel],
            rows_per=rows_per, stride=stride,
            n_local_songs=cat.n_local_songs,
        ))
    local_stacked = tuple(
        np.stack([per_shard[i][c] for i in range(len(per_shard))])
        for c in range(len(per_shard[0]))
    )
    cat.n_songs, cat.max_offset, cat._stride = n_songs, gmax_off, stride
    cat._place_local(local_stacked)
    return cat, local
