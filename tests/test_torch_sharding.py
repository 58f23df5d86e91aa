"""The port's key-range sharding (``parallel/mesh.py``, ``parallel/sharded.py``)
against the JAX package's, at the same shard count.

The port runs one rank per shard: its cases run in gloo ranks spawned
with ``torch.multiprocessing`` (one spawn of 4 ranks per module, a
``file://`` rendezvous under the test's temporary directory), at world
sizes 1, 2 and 4 (subgroups of the 4 ranks). The parent computes the JAX
package's answer on ``make_mesh(n)`` over the conftest's virtual CPU
devices for the same ``n`` and hands every input to the ranks as numpy
arrays. This module imports no JAX at its top level, because the spawned
ranks import it to find their work; ``spawn_ranks`` is shared by the
other ``tests/test_torch_*`` files that spawn ranks.

Mirrors ``tests/test_sharding.py``: seeds 0 and 3 (every RawMatch field
equal), the ingest step (row 3 exact against the port's single-device
pipeline), and the hot-shard clamp.
"""

import os
import pickle
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

WORLDS = (1, 2, 4)
RAW_FIELDS = ("top_songs", "top_deltas", "top_votes", "row_counts",
              "total_rows", "n_ranked", "n_dropped", "runner_votes")


# ---- spawned ranks (shared with the other spawning test files) ---------

def _rank_main(rank, world, rdv, out_dir, fn, args, backend):
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{rdv}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=100))
    try:
        out = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


def spawn_ranks(fn, world, tmp_path, *args, timeout=120.0, backend="gloo"):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned ranks (gloo on
    the CPU; ``backend="nccl"``: rank r on card r) and return their
    results in rank order. A rank that raises fails the test with its
    traceback; ranks still running after ``timeout`` seconds are killed
    and the test fails."""
    out_dir = str(tmp_path)
    os.makedirs(out_dir, exist_ok=True)
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(world, os.path.join(out_dir, "rdv"), out_dir, fn,
                          args, backend),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"ranks still running after {timeout} s")
    assert not any(p.is_alive() for p in ctx.processes)
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as fh:
            results.append(pickle.load(fh))
    return results


def cpu_meshes(rank, worlds):
    """{n: this rank's CPU mesh of the first n ranks, or None}: one
    subgroup per world size, made by every rank in the same order."""
    from shazam_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for n in worlds:
        g = (dist.group.WORLD if n == dist.get_world_size()
             else dist.new_group(list(range(n))))
        out[n] = make_mesh(n, device="cpu", group=g) if rank < n else None
    return out


def host_raw(raw):
    """A RawMatch (port tensors or JAX arrays) as a dict of numpy arrays."""
    return {f: np.asarray(getattr(raw, f)).astype(np.int64)
            for f in RAW_FIELDS}


def assert_raw_equal(port, jax_raw, where=""):
    want = host_raw(jax_raw)
    for f in RAW_FIELDS:
        assert np.array_equal(port[f], want[f]), (where, f, port[f], want[f])


# ---- the ranks' work --------------------------------------------------------

def _index(cols, n_songs, max_offset):
    from shazam_tpu_torch.index.store import from_numpy

    return from_numpy(*cols, n_songs=n_songs, max_offset=max_offset)


def _ranks_work(rank, world, match_cases, ingest_case):
    from shazam_tpu_torch.match.lookup import raw_to_host
    from shazam_tpu_torch.ops.fingerprint import fingerprint_samples
    from shazam_tpu_torch.parallel.mesh import shard_index_arrays
    from shazam_tpu_torch.parallel.sharded import (sharded_ingest_step,
                                                   sharded_match_query)

    meshes = cpu_meshes(rank, WORLDS)
    out = {}
    for key, (cols, n_songs, max_off, q, kw) in match_cases.items():
        ix = _index(cols, n_songs, max_off)
        for n, mesh in meshes.items():
            if mesh is None:
                continue
            raw = sharded_match_query(mesh, shard_index_arrays(ix, n), *q,
                                      offset_stride=ix.offset_stride, **kw)
            out[(key, n)] = host_raw(raw_to_host(raw)[0])
    batch, n_valid = ingest_case
    ref = fingerprint_samples(torch.from_numpy(batch[3]), int(n_valid[3]),
                              peak_capacity=2048)
    for n, mesh in meshes.items():
        if mesh is None:
            continue
        fp = sharded_ingest_step(mesh, batch, n_valid, peak_capacity=2048)
        out[("ingest", n)] = (
            len(fp.hi) == len(batch)
            and all(torch.equal(a[3], b) for a, b in zip(fp, ref)),
            fp.hi[3][fp.valid[3]].numpy(), fp.lo[3][fp.valid[3]].numpy(),
            fp.t1[3][fp.valid[3]].numpy())
    return out


# ---- the parent: inputs, JAX answers, comparisons --------------------------

def _cols(index):
    return tuple(np.asarray(getattr(index, c)) for c in (
        "key_hi", "key_lo", "key_ex", "song_id", "offset"))


def _match_kw(index, topn=4, match_capacity=65536):
    return dict(n_songs=index.n_songs,
                delta_min=-(index.max_offset + 100),
                delta_range=2 * (index.max_offset + 100),
                match_capacity=match_capacity, topn=topn)


def _q(q):
    return tuple(np.asarray(a) for a in (q.hi, q.lo, q.ex, q.t, q.valid,
                                         q.first))


def _inputs():
    from tests.test_match import (_build_db, _index_from_rows,
                                  _query_from_pairs, _random_hex)

    cases = {}
    for seed in (0, 3):
        rng = np.random.default_rng(seed)
        rows = _build_db(rng, n_songs=8, rows_per_song=400)
        index = _index_from_rows(rows)
        song_rows = [r for r in rows if r[1] == 5]
        q_pairs = sorted(
            {(h, max(off - 21, 0)) for h, _s, off in song_rows[:120]}
            | {(h, int(rng.integers(0, 300))) for h in _random_hex(rng, 40)})
        cases[("seed", seed)] = (index, _query_from_pairs(q_pairs),
                                 _match_kw(index))
    rng = np.random.default_rng(11)
    rows = _build_db(rng, n_songs=4, rows_per_song=1000)
    hot = _random_hex(rng, 1)[0]
    rows += [(hot, 2, int(off)) for off in range(5000)]
    index = _index_from_rows(sorted(set(rows)))
    cases[("hot", 0)] = (index, _query_from_pairs([(hot, 3)], pad_to=256),
                         _match_kw(index, match_capacity=8192))
    return cases


def _ingest_batch():
    from shazam_tpu_torch.audio import synth_song

    batch = np.zeros((8, 1 << 17), np.float32)
    n_valid = np.zeros(8, np.int32)
    for i in range(8):
        song = synth_song(i, 2.0, seed=31)
        batch[i, : len(song)] = song
        n_valid[i] = len(song)
    return batch, n_valid


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = _inputs()
    match_cases = {key: (_cols(ix), ix.n_songs, ix.max_offset, _q(q), kw)
                   for key, (ix, q, kw) in cases.items()}
    ingest = _ingest_batch()
    port = spawn_ranks(_ranks_work, 4, tmp_path_factory.mktemp("ranks"),
                       match_cases, ingest)
    return cases, ingest, port


def _jax_sharded(index, q, kw, n):
    import jax.numpy as jnp
    from shazam_tpu.parallel.mesh import make_mesh, shard_index_arrays
    from shazam_tpu.parallel.sharded import sharded_match_query

    shards = tuple(jnp.asarray(a) for a in shard_index_arrays(index, n))
    return sharded_match_query(make_mesh(n), shards,
                               *(jnp.asarray(a) for a in _q(q)),
                               offset_stride=index.offset_stride, **kw)


@pytest.mark.parametrize("n", WORLDS)
def test_shard_index_arrays_equal_jax(ranks, n):
    from shazam_tpu.parallel.mesh import shard_index_arrays as jax_split
    from shazam_tpu_torch.parallel.mesh import shard_index_arrays

    cases, _, _ = ranks
    for index, _q_, _kw in cases.values():
        ours = shard_index_arrays(_index(_cols(index), index.n_songs,
                                         index.max_offset), n)
        theirs = jax_split(index, n)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_matches_jax(ranks, seed, n):
    """Every RawMatch field equal to the JAX package's sharded match on a
    mesh of the same size, on every rank."""
    cases, _, port = ranks
    index, q, kw = cases[("seed", seed)]
    want = _jax_sharded(index, q, kw, n)
    for r in range(n):
        assert_raw_equal(port[r][(("seed", seed), n)], want, (seed, n, r))
    assert int(want.top_songs[0]) == 5


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_ingest_step(ranks, n):
    """Row 3 of the gathered batch equals the port's single-device
    pipeline exactly on every rank, and the JAX package's by jaccard."""
    from shazam_tpu.ops.fingerprint import fingerprint_samples as jax_fp

    _, (batch, n_valid), port = ranks
    ref = jax_fp(batch[3], np.int32(n_valid[3]), peak_capacity=2048)
    rv = np.asarray(ref.valid)
    theirs = set(zip(np.asarray(ref.hi)[rv].tolist(),
                     np.asarray(ref.lo)[rv].tolist(),
                     np.asarray(ref.t1)[rv].tolist()))
    for r in range(n):
        exact, hi, lo, t1 = port[r][("ingest", n)]
        assert exact, (n, r)
        ours = set(zip(hi.tolist(), lo.tolist(), t1.tolist()))
        assert len(ours) > 100
        assert len(ours & theirs) / len(ours | theirs) > 0.98


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_hot_shard_overflow_detected(ranks, n):
    """A popular hash concentrates its rows on one key-range shard: a
    shard past its own cap clamps the total above the summed caps, as in
    the JAX package; at 4 shards the hot shards pass 2,048 rows."""
    cases, _, port = ranks
    index, q, kw = cases[("hot", 0)]
    want = _jax_sharded(index, q, kw, n)
    got = port[0][(("hot", 0), n)]
    assert_raw_equal(got, want, n)
    if n == 4:
        assert int(got["total_rows"]) > 8192
