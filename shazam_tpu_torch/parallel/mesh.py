"""Process groups for sharded catalogs: one rank per card, one shard per rank.

The JAX package shards the catalog across a ``jax.sharding.Mesh`` that one
controller drives with ``shard_map``. PyTorch's idiom is one process per
card in a ``torch.distributed`` group, so a ``Mesh`` here is that group as
one rank sees it: its rank, the group's size and the device its shard
lives on. Every sharded match is a collective that each rank of the group
enters with the same query; only the vote histograms (key-range shards)
or a few candidate rows (by-song shards) cross the group.

Backends: NCCL for ``cuda`` devices and gloo for ``cpu``, nothing else. A
mesh asked for on the card never runs a CPU group instead.

``shard_index_arrays`` is the JAX package's numpy split, kept equal to it;
``shard_device_index`` turns one rank's rows of that layout (or of the
by-song layout, or of a shard file) into the port's search view.
"""

from __future__ import annotations

import atexit
import dataclasses
import os
import shutil
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..index.devmerge import SENTINEL, packed_stride_for, search_view_key_sub
from ..index.search import query_key64
from ..index.store import CAPACITY_MULTIPLE, DeviceIndex, offset_stride_for

SHARD_AXIS = "shards"
PAD_KEY = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the group that holds a sharded catalog."""

    group: object          # the torch.distributed process group
    rank: int              # this process's rank in ``group``
    size: int              # ranks (= shards) in ``group``
    device: torch.device   # where this rank's shard and collectives live
    axis_name: str = SHARD_AXIS

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def backend_for(device: torch.device) -> str:
    """The one backend each device type takes: NCCL on the card, gloo on
    the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def _start_one_rank_group(backend: str) -> None:
    """A group of this process alone, through a ``file://`` rendezvous in a
    temporary directory removed at exit (no port to pick or collide)."""
    tmp = tempfile.mkdtemp(prefix="shz_mesh_")
    atexit.register(shutil.rmtree, tmp, True)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rdv",
                            world_size=1, rank=0)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = SHARD_AXIS,
              *, device="cuda", group=None) -> Mesh:
    """The mesh of ``group`` (default: the default group) on ``device``.

    With no group initialized, a one-rank group of this process is started:
    the JAX default of "every local device", which is one card here (one
    rank per card). ``device="cuda"`` means ``cuda:LOCAL_RANK`` (else the
    global rank modulo the visible cards) and raises without a card;
    ``n_devices``, when given, must be the group's size.
    """
    dev = resolve_device(device)
    backend = backend_for(dev)
    if not dist.is_initialized():
        if group is not None:
            raise ValueError("a group was passed but torch.distributed is "
                             "not initialized")
        if n_devices not in (None, 1):
            raise ValueError(
                f"requested {n_devices} ranks, have 1: start the group "
                "first (init_multihost), one process per card")
        _start_one_rank_group(backend)
    g = group if group is not None else dist.group.WORLD
    if dist.get_backend(g) != backend:
        raise ValueError(f"a {dev.type} mesh needs the {backend} backend; "
                         f"the group runs {dist.get_backend(g)}")
    rank, size = dist.get_rank(g), dist.get_world_size(g)
    if rank < 0:
        raise ValueError("this process is not a member of the group")
    if n_devices is not None and n_devices != size:
        raise ValueError(f"requested {n_devices} ranks, the group has {size}")
    if dev.type == "cuda":
        if torch.device(device).index is None:
            local = int(os.environ.get(
                "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    return Mesh(g, rank, size, dev, axis_name)


def shard_index_arrays(index, n_shards: int) -> Tuple[np.ndarray, ...]:
    """Split the sorted index into n equal contiguous chunks (padded): the
    JAX package's layout, array for array.

    Returns stacked (n_shards, rows_per_shard) uint32 arrays for the keys
    plus the payload (one packed array when the JAX packing rule admits the
    catalog, else separate song_id/offset). Padding rows carry the maximal
    key, so they sort after every real key and never match a query (query
    ex values are 16-bit); padded payloads decode to song_id >= n_songs.
    """
    n = index.n_hashes
    per = -(-max(n, 1) // n_shards)  # ceil
    total = per * n_shards

    def pad(arr, fill):
        out = np.full(total, fill, np.uint32)
        out[:n] = arr
        return out.reshape(n_shards, per)

    keys = (pad(index.key_hi, PAD_KEY), pad(index.key_lo, PAD_KEY),
            pad(index.key_ex, PAD_KEY))
    stride = packed_stride_for(index.max_offset, index.n_songs)
    if stride:
        packed = (index.song_id.astype(np.uint32) * np.uint32(stride)
                  + index.offset.astype(np.uint32))
        return keys + (pad(packed, min(index.n_songs * stride, 2 ** 32 - 1)),)
    return keys + (pad(index.song_id, index.n_songs), pad(index.offset, 0))


def rows_device_index(hi, lo, ex, sid, off, device) -> DeviceIndex:
    """Sorted (hi, lo, ex) rows with their song ids and offsets as the
    port's search view on ``device`` (sentinel rows to a multiple of 512;
    an empty shard is all sentinels)."""
    n = len(hi)
    stride = offset_stride_for(int(np.max(off)) if n else 0)
    cap = max(-(-n // CAPACITY_MULTIPLE), 1) * CAPACITY_MULTIPLE

    def up(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    key64 = torch.full((cap,), SENTINEL, dtype=torch.int64, device=device)
    ex_t = torch.zeros(cap, dtype=torch.int64, device=device)
    payload = torch.zeros(cap, dtype=torch.int64, device=device)
    if n:
        key64[:n] = query_key64(up(hi), up(lo))
        ex_t[:n] = up(ex)
        payload[:n] = up(sid) * stride + up(off)
    return DeviceIndex(key64, search_view_key_sub(key64, ex_t, n, cap),
                       payload, n, stride)


def shard_device_index(cols, stride: int, device) -> DeviceIndex:
    """One shard of the JAX layout, ``(hi, lo, ex, packed)`` with
    ``stride`` > 0 or ``(hi, lo, ex, song_id, offset)`` with 0, as the
    port's search view: the real rows keep their order and the padding
    rows (ex 0xFFFFFFFF, always the tail) become its sentinel rows."""
    cols = [np.asarray(c, np.uint32).reshape(-1) for c in cols]
    n = int(np.count_nonzero(cols[2] != PAD_KEY))
    hi, lo, ex = (c[:n] for c in cols[:3])
    if stride:
        sid, off = cols[3][:n] // np.uint32(stride), cols[3][:n] % np.uint32(stride)
    else:
        sid, off = cols[3][:n], cols[4][:n]
    return rows_device_index(hi, lo, ex, sid, off, device)


def local_shard(mesh: Mesh, sharded_index, stride: int) -> DeviceIndex:
    """This rank's shard: a ``DeviceIndex`` as it is, or row ``mesh.rank``
    of stacked (n_shards, rows) arrays in the JAX layout."""
    if isinstance(sharded_index, DeviceIndex):
        return sharded_index
    if len(sharded_index[0]) != mesh.size:
        raise ValueError(f"{len(sharded_index[0])} shards for a mesh of "
                         f"{mesh.size} ranks")
    return shard_device_index([np.asarray(a)[mesh.rank] for a in sharded_index],
                              stride, mesh.device)
