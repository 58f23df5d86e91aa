"""The port's multi-process catalog spanning (``parallel/multihost.py``).

One spawn of 2 gloo ranks (``test_torch_sharding.spawn_ranks``) mirrors
``tests/test_multihost.py`` (2 processes of 4 virtual devices there, 2
ranks of one shard each here): the spanned query of a planted song in a
4,000-song index, against the JAX package's ``SpannedCatalog`` on a
2-device mesh; and the distributed ingest, each rank fingerprinting only
its own songs, then ``save_local_shards`` / ``load_local_shards`` and an
equal answer. Shard files cross packages both ways (a one-shard file
written by the JAX package loads in a one-rank port and answers alike,
and back), and the two load refusals hold.
"""

import os
import shutil

import numpy as np
import pytest

from tests.test_torch_sharding import cpu_meshes, spawn_ranks

N_SONGS, DUR = 8, 2.5


def _planted_index():
    """``tests/multihost_worker.py``'s deterministic index: 4,000 songs of
    unique bit-mixed keys and a planted song 3,777 of 60 known rows."""
    n_songs, rows_per = 4000, 10
    n = n_songs * rows_per
    z = (np.arange(n, dtype=np.uint64) + np.uint64(11)) * np.uint64(
        0xBF58476D1CE4E5B9)
    z ^= z >> np.uint64(27)
    hi = (z >> np.uint64(32)).astype(np.uint32) | np.uint32(0x80000000)
    lo = z.astype(np.uint32)
    ex = (z & np.uint64(0x7FFF)).astype(np.uint32)
    sid = np.repeat(np.arange(n_songs, dtype=np.uint32), rows_per)
    off = (z % np.uint64(3000)).astype(np.uint32)
    n_plant = 60
    p_hi = np.arange(n_plant, dtype=np.uint32)
    p_lo = p_hi * np.uint32(77)
    p_ex = p_hi & np.uint32(0xFF)
    p_off = np.uint32(500) + np.arange(n_plant, dtype=np.uint32)
    cols = [np.concatenate(a) for a in (
        (hi, p_hi), (lo, p_lo), (ex, p_ex),
        (sid, np.full(n_plant, 3777, np.uint32)), (off, p_off))]
    order = np.lexsort(cols[::-1])
    cols = tuple(c[order] for c in cols)

    t = (p_off - np.uint32(13)).astype(np.uint32)
    q_order = np.lexsort((t, p_ex, p_lo, p_hi))
    pad = 128 - n_plant
    q = tuple(np.pad(a[q_order], (0, pad)) for a in (p_hi, p_lo, p_ex, t)) \
        + (np.pad(np.ones(n_plant, bool), (0, pad)),) * 2 + (n_plant,)
    return cols, n_songs, 3000, q


def _res(m):
    return ([(r["song_id"], r["offset"], r["hashes_matched_in_input"])
             for r in m.results], m.total_matches, m.overflowed)


def _ingest_query():
    """A clip of song 5 (0.4 to 1.9 s) as the port's prepared query."""
    import torch

    from shazam_tpu_torch.audio import synth_song
    from shazam_tpu_torch.match.prepare import prepare_query
    from shazam_tpu_torch.ops.fingerprint import fingerprint_samples

    clip = np.asarray(synth_song(5, DUR))[int(0.4 * 44100): int(1.9 * 44100)]
    pad = np.zeros(1 << 18, np.float32)
    pad[: len(clip)] = clip
    return prepare_query([fingerprint_samples(torch.from_numpy(pad),
                                              len(clip))])


def _ranks_work(rank, world, d, planted):
    from shazam_tpu_torch.audio import synth_song
    from shazam_tpu_torch.index.store import from_numpy
    from shazam_tpu_torch.match.prepare import QueryPairs
    from shazam_tpu_torch.parallel.multihost import (
        SpannedCatalog, distributed_ingest_arrays)

    cols, n_songs, max_off, q = planted
    q = QueryPairs(*q)
    index = from_numpy(*cols, n_songs=n_songs, max_offset=max_off)
    meshes = cpu_meshes(rank, (1, 2))
    mesh = meshes[2]
    out = {}
    cat = SpannedCatalog.from_full_index(index, mesh=mesh)
    out["planted"] = _res(cat.match(q, topn=3, q_frames=1024))

    names = [f"track{s:03d}" for s in range(N_SONGS)]
    loads = []

    def load(s):
        loads.append(s)
        # song 6 is a byte-identical copy of song 2 in a later chunk of
        # rank 0: the SHA-1 resume dedup skips it and the remap tolerates
        # the name (the JAX test's copy of song 4 shares a chunk with it
        # on 2 ranks)
        return synth_song(2 if s == 6 else s, duration_s=DUR)

    cat, local = distributed_ingest_arrays(names, load, mesh=mesh,
                                           batch_size=4, chunk_songs=2)
    qi = _ingest_query()
    first = _res(cat.match(qi, topn=2, q_frames=1024))
    cat.save_local_shards(os.path.join(d, "ingest"))
    cat2 = SpannedCatalog.load_local_shards(os.path.join(d, "ingest"),
                                            mesh=mesh)
    out["ingest"] = (sorted(loads), first,
                     _res(cat2.match(qi, topn=2, q_frames=1024)),
                     sorted(x["song_name"] for x in local.catalog.get_songs()))

    # files whose global shard ids this rank does not own
    swapped = os.path.join(d, "swapped")
    if rank == 0:
        os.makedirs(swapped)
        for a, b in ((0, 1), (1, 0)):
            shutil.copy(os.path.join(d, "ingest", f"shards_p{a:03d}.npz"),
                        os.path.join(swapped, f"shards_p{b:03d}.npz"))
    import torch.distributed as dist

    dist.barrier()
    try:
        SpannedCatalog.load_local_shards(swapped, mesh=mesh)
    except ValueError as e:
        out["swapped"] = str(e)

    if meshes[1] is not None:
        one = meshes[1]
        jax_cat = SpannedCatalog.load_local_shards(os.path.join(d, "jax"),
                                                   mesh=one)
        out["jax_file"] = _res(jax_cat.match(q, topn=3, q_frames=1024))
        SpannedCatalog.from_full_index(index, mesh=one).save_local_shards(
            os.path.join(d, "port"))
        try:
            SpannedCatalog.load_local_shards(os.path.join(d, "ingest"),
                                             mesh=one)
        except ValueError as e:
            out["count"] = str(e)
    return out


def _jax_spanned(n_devices):
    import jax
    from jax.sharding import Mesh

    from shazam_tpu.index.store import FingerprintIndex
    from shazam_tpu.parallel.multihost import SpannedCatalog

    cols, n_songs, max_off, _q = _planted_index()
    mesh = Mesh(np.array(jax.devices()[:n_devices]), ("shard",))
    return SpannedCatalog.from_full_index(
        FingerprintIndex(*cols, n_songs=n_songs, max_offset=max_off),
        mesh=mesh), mesh


def _planted_query():
    from shazam_tpu.match.prepare import QueryPairs

    return QueryPairs(*_planted_index()[3])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    jcat, _ = _jax_spanned(1)
    jcat.save_local_shards(str(d / "jax"))
    port = spawn_ranks(_ranks_work, 2, tmp_path_factory.mktemp("ranks"),
                       str(d), _planted_index())
    return d, port


def test_two_rank_spanned_query(ranks):
    """The planted song wins on both ranks with every row at delta 13,
    as the JAX package's SpannedCatalog answers on a 2-device mesh."""
    _, port = ranks
    jcat, _ = _jax_spanned(2)
    want = _res(jcat.match(_planted_query(), topn=3, q_frames=1024))
    for r in range(2):
        got = port[r]["planted"]
        assert got == want
        assert got[0][0] == (3777, 13, 60) and got[1] == 60


def test_two_rank_distributed_ingest(ranks):
    """Each rank fingerprinted only its own songs (disjoint, complete),
    song 5's clip wins, and the catalog saved per rank and loaded back
    answers the same."""
    _, port = ranks
    owned = []
    for r in range(2):
        loads, first, loaded, names = port[r]["ingest"]
        assert loads == [s for s in range(N_SONGS) if s % 2 == r]
        assert names == [f"track{s:03d}" for s in loads if s != 6]
        assert first[0][0][0] == 5 and first[0][0][2] > 10
        assert loaded == first
        owned.append(set(loads))
    assert owned[0] & owned[1] == set()
    assert owned[0] | owned[1] == set(range(N_SONGS))
    assert port[0]["ingest"][1] == port[1]["ingest"][1]


def test_shard_files_cross_packages(ranks):
    """A one-shard file the JAX package wrote (a 1-device mesh, axis
    "shard") loads in a one-rank port and answers as JAX does; the file
    the port wrote loads in the JAX package and answers the same."""
    from shazam_tpu.parallel.multihost import SpannedCatalog

    d, port = ranks
    jcat, mesh = _jax_spanned(1)
    q = _planted_query()
    want = _res(jcat.match(q, topn=3, q_frames=1024))
    assert port[0]["jax_file"] == want
    back = SpannedCatalog.load_local_shards(str(d / "port"), mesh=mesh)
    assert _res(back.match(q, topn=3, q_frames=1024)) == want
    with np.load(d / "port" / "shards_p000.npz") as a, \
            np.load(d / "jax" / "shards_p000.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_load_refuses_other_topologies(ranks):
    _, port = ranks
    assert "written for 2 shards, mesh has 1" in port[0]["count"]
    for r in range(2):
        assert f"this process owns [{r}]" in port[r]["swapped"]
