"""The port's song-sharded catalog (``parallel/bigcatalog.py``) against the
JAX package's, at the same shard count.

One spawn of 4 gloo ranks (``test_torch_sharding.spawn_ranks``) runs every
case at world sizes 1, 2 and 4; the parent computes the JAX package's
answer on ``make_mesh(n)``. Mirrors ``tests/test_bigcatalog.py``: seeds 1
and 4 (every RawMatch field equal), 10^5 songs at the uint32 stride edge
(at 1, 2 and 4 shards; the JAX test runs 8), heads (the JAX package with
its per-shard bucket heads against the port, which has none), the summed
total over the nominal cap that is exact, and the hot-shard clamp. Also
shards with no real rows, in both regimes.
"""

import numpy as np
import pytest

from tests.test_torch_sharding import (WORLDS, assert_raw_equal, cpu_meshes,
                                       host_raw, spawn_ranks)


def _ranks_work(rank, world, jobs):
    from shazam_tpu_torch.index.store import from_numpy
    from shazam_tpu_torch.match.lookup import raw_to_host
    from shazam_tpu_torch.parallel.bigcatalog import (shard_index_by_song,
                                                      sharded_match_by_song)
    from shazam_tpu_torch.parallel.mesh import shard_index_arrays
    from shazam_tpu_torch.parallel.sharded import sharded_match_query

    meshes = cpu_meshes(rank, WORLDS)
    out = {}
    for key, (regime, cols, n_songs, max_off, queries, kw) in jobs.items():
        ix = from_numpy(*cols, n_songs=n_songs, max_offset=max_off)
        for n, mesh in meshes.items():
            if mesh is None:
                continue
            if regime == "by_song":
                stacked, n_local, stride = shard_index_by_song(ix, n)
            else:
                stacked = shard_index_arrays(ix, n)
            for i, q in enumerate(queries):
                if regime == "by_song":
                    raw = sharded_match_by_song(mesh, stacked, n_local,
                                                stride, *q, **kw)
                else:
                    raw = sharded_match_query(
                        mesh, stacked, *q, n_songs=n_songs,
                        offset_stride=ix.offset_stride, **kw)
                out[(key, n, i)] = host_raw(raw_to_host(raw)[0])
    return out


def _cols(index):
    return tuple(np.asarray(getattr(index, c)) for c in (
        "key_hi", "key_lo", "key_ex", "song_id", "offset"))


def _q(q):
    return tuple(np.asarray(a) for a in (q.hi, q.lo, q.ex, q.t, q.valid,
                                         q.first))


def _window(index, **kw):
    return dict(delta_min=-(index.max_offset + 100),
                delta_range=2 * (index.max_offset + 100), **kw)


def _scale_queries(hit_rows, low_rows):
    """``test_bigcatalog.py``'s planted queries (``run_query``)."""
    out = []
    for rows, shift in ((hit_rows, 7), (low_rows, 3)):
        hi = np.array([np.uint32(s) & np.uint32(0x7FFFFFFF) for s, _ in rows],
                      np.uint32)
        lo = np.array([np.uint32(~np.uint32(s)) for s, _ in rows], np.uint32)
        ex = np.array([np.uint32(s) & np.uint32(0x7FFF) for s, _ in rows],
                      np.uint32)
        t = np.array([off - shift for _s, off in rows], np.uint32)
        pad = 256 - len(rows)
        order = np.lexsort((t, ex, lo, hi))
        cols = [np.pad(a[order], (0, pad)) for a in (hi, lo, ex, t)]
        valid = np.pad(np.ones(len(rows), bool), (0, pad))
        out.append(tuple(cols) + (valid, valid.copy()))
    return out


def _inputs():
    """{key: (regime, JAX index, [query columns], match kwargs)}."""
    from tests.test_bigcatalog import _synth_big_index
    from tests.test_match import (_build_db, _index_from_rows,
                                  _query_from_pairs, _random_hex)

    cases = {}
    for seed in (1, 4):
        rng = np.random.default_rng(seed)
        rows = _build_db(rng, n_songs=24, rows_per_song=200)
        index = _index_from_rows(rows)
        song_rows = [r for r in rows if r[1] == 13]
        q_pairs = sorted(
            {(h, max(off - 9, 0)) for h, _s, off in song_rows[:100]}
            | {(h, int(rng.integers(0, 200))) for h in _random_hex(rng, 30)})
        cases[("seed", seed)] = ("by_song", index,
                                 [_q(_query_from_pairs(q_pairs))],
                                 _window(index, match_capacity=65536, topn=4))

    rng = np.random.default_rng(9)
    hit_rows = [(1000 + i, 16303 + i) for i in range(80)]
    low_rows = [(500_000 + i, 10 + i) for i in range(40)]
    index = _synth_big_index(100_000, rows_per_song=3, rng=rng,
                             planted={99_999: hit_rows, 0: low_rows})
    cases[("scale", 0)] = ("by_song", index,
                           _scale_queries(hit_rows, low_rows),
                           dict(delta_min=-128, delta_range=256,
                                match_capacity=4096, topn=4))

    rng = np.random.default_rng(9)
    rows = _build_db(rng, n_songs=40, rows_per_song=1700)
    index = _index_from_rows(rows)
    song_rows = [r for r in rows if r[1] == 7]
    q_pairs = sorted(
        {(h, max(off - 4, 0)) for h, _s, off in song_rows[:200]}
        | {(h, int(rng.integers(0, 200))) for h in _random_hex(rng, 50)})
    q = [_q(_query_from_pairs(q_pairs))]
    for regime in ("key_range", "by_song"):
        cases[("heads", regime)] = (regime, index, q,
                                    _window(index, match_capacity=65536,
                                            topn=4))

    rng = np.random.default_rng(23)
    rows = sorted(set(_build_db(rng, n_songs=24, rows_per_song=200)))
    index = _index_from_rows(rows)
    q_pairs = sorted({(h, 0) for h, _s, _o in rows})[:4096]
    q = [_q(_query_from_pairs(q_pairs, pad_to=4096))]
    for cap in (1024, 2048):
        cases[("nominal", cap)] = ("by_song", index, q,
                                   _window(index, match_capacity=cap, topn=4))
    cases[("nominal", "hashes")] = {h for h, _t in q_pairs}
    cases[("nominal", "rows")] = rows

    rng = np.random.default_rng(29)
    rows = sorted(set(_build_db(rng, n_songs=8, rows_per_song=100)))
    hot = _random_hex(rng, 1)[0]
    rows += [(hot, 2, int(off)) for off in range(3000)]
    index = _index_from_rows(sorted(set(rows)))
    cases[("hot", 0)] = ("by_song", index,
                         [_q(_query_from_pairs([(hot, 3)], pad_to=256))],
                         _window(index, match_capacity=1024, topn=4))

    # one song of 3 rows: at 4 shards, key-range shard 3 and by-song
    # shards 1-3 hold no real row
    rng = np.random.default_rng(31)
    rows = [(h, 0, 10 + i) for i, h in enumerate(_random_hex(rng, 3))]
    index = _index_from_rows(rows)
    q = [_q(_query_from_pairs([(h, max(o - 2, 0)) for h, _s, o in rows]))]
    for regime in ("key_range", "by_song"):
        cases[("empty", regime)] = (regime, index, q,
                                    _window(index, match_capacity=1024,
                                            topn=2))
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = _inputs()
    jobs = {key: (regime, _cols(ix), ix.n_songs, ix.max_offset, qs, kw)
            for key, case in cases.items() if isinstance(case, tuple)
            for regime, ix, qs, kw in [case]}
    port = spawn_ranks(_ranks_work, 4, tmp_path_factory.mktemp("ranks"), jobs)
    return cases, port


def _jax_match(case, n, i=0, heads=False):
    import jax
    import jax.numpy as jnp
    from shazam_tpu.index.search import build_head, head_bits_for
    from shazam_tpu.parallel.bigcatalog import (shard_index_by_song,
                                                sharded_match_by_song)
    from shazam_tpu.parallel.mesh import make_mesh, shard_index_arrays
    from shazam_tpu.parallel.sharded import sharded_match_query

    regime, index, queries, kw = case
    q = tuple(jnp.asarray(a) for a in queries[i])
    mesh = make_mesh(n)
    if regime == "by_song":
        stacked, n_local, stride = shard_index_by_song(index, n)
        stacked = tuple(jnp.asarray(a) for a in stacked)
    else:
        stacked = tuple(jnp.asarray(a) for a in shard_index_arrays(index, n))
    head = None
    if heads:
        bits = head_bits_for(stacked[0].shape[1])
        head = jax.vmap(lambda h: build_head(h, bits=bits))(stacked[0])
    if regime == "by_song":
        return sharded_match_by_song(mesh, stacked, n_local, stride, *q,
                                     sharded_head=head, **kw)
    return sharded_match_query(mesh, stacked, *q, n_songs=index.n_songs,
                               offset_stride=index.offset_stride,
                               sharded_head=head, **kw)


def _check(cases, port, key, n, i=0, heads=False):
    want = _jax_match(cases[key], n, i, heads)
    for r in range(n):
        assert_raw_equal(port[r][(key, n, i)], want, (key, n, i, r))
    return port[0][(key, n, i)]


@pytest.mark.parametrize("n", WORLDS)
def test_shard_index_by_song_equals_jax(ranks, n):
    from shazam_tpu.parallel.bigcatalog import shard_index_by_song as jax_split
    from shazam_tpu_torch.index.store import from_numpy
    from shazam_tpu_torch.parallel.bigcatalog import shard_index_by_song

    cases, _ = ranks
    for key in (("seed", 1), ("scale", 0), ("empty", "by_song")):
        index = cases[key][1]
        ours = shard_index_by_song(from_numpy(
            *_cols(index), n_songs=index.n_songs,
            max_offset=index.max_offset), n)
        theirs = jax_split(index, n)
        assert ours[1:] == theirs[1:]
        for a, b in zip(ours[0], theirs[0]):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed", [1, 4])
@pytest.mark.parametrize("n", WORLDS)
def test_song_sharded_matches_jax(ranks, seed, n):
    cases, port = ranks
    got = _check(cases, port, ("seed", seed), n)
    assert int(got["top_songs"][0]) == 13


@pytest.mark.parametrize("n", WORLDS)
def test_song_sharded_at_catalog_scale(ranks, n):
    """10^5 songs, the uint32 packing at the stride edge (16,384), the
    round-robin boundary ids 0 and 99,999: exact by construction."""
    cases, port = ranks
    hit = _check(cases, port, ("scale", 0), n, 0)
    assert (int(hit["top_songs"][0]), int(hit["top_votes"][0]),
            int(hit["top_deltas"][0]), int(hit["row_counts"][0]),
            int(hit["total_rows"])) == (99_999, 80, 7, 80, 80)
    low = _check(cases, port, ("scale", 0), n, 1)
    assert (int(low["top_songs"][0]), int(low["top_votes"][0]),
            int(low["top_deltas"][0]), int(low["total_rows"])) == (0, 40, 3, 40)


@pytest.mark.parametrize("regime", ["key_range", "by_song"])
@pytest.mark.parametrize("n", WORLDS)
def test_port_without_heads_matches_jax_with_heads(ranks, regime, n):
    """The JAX package with its per-shard bucket-CDF heads (8K rows a
    shard at 8 shards, more here) against the port, which has no head:
    its searchsorted bounds are exact without one."""
    cases, port = ranks
    _check(cases, port, ("heads", regime), n, heads=True)


@pytest.mark.parametrize("n", WORLDS)
def test_by_song_sum_over_nominal_cap_is_exact_not_overflow(ranks, n):
    """Every by-song shard expands with the full match_capacity, so a
    summed total above the nominal cap with every shard under its own cap
    is exact. At 4 shards and cap 2,048 each shard holds about 1,200 rows
    (the JAX test's 8 shards at 1,024: about 600)."""
    from shazam_tpu_torch.parallel.bigcatalog import effective_match_capacity

    cases, port = ranks
    for cap in (1024, 2048):
        got = _check(cases, port, ("nominal", cap), n)
    hashes, rows = cases[("nominal", "hashes")], cases[("nominal", "rows")]
    if n == 4:
        total = int(got["total_rows"])
        assert 2048 < total <= effective_match_capacity(2048, 4)
        assert total == sum(1 for h, _s, _o in rows if h in hashes)


@pytest.mark.parametrize("n", WORLDS)
def test_by_song_hot_shard_overflow_clamps_total(ranks, n):
    from shazam_tpu_torch.parallel.bigcatalog import effective_match_capacity

    cases, port = ranks
    got = _check(cases, port, ("hot", 0), n)
    assert int(got["total_rows"]) > effective_match_capacity(1024, n)


@pytest.mark.parametrize("regime", ["key_range", "by_song"])
@pytest.mark.parametrize("n", WORLDS)
def test_shards_without_rows_match_jax(ranks, regime, n):
    cases, port = ranks
    got = _check(cases, port, ("empty", regime), n)
    assert int(got["top_votes"][0]) == 3 and int(got["total_rows"]) == 3
