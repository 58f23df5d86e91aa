"""Port parity, big-catalog matchers: sort and scan ranks, blocked
expansion, search-bound reuse.

The same seeded numpy index and queries go through ``shazam_tpu`` (JAX on
the CPU) and ``shazam_tpu_torch`` (PyTorch on the CPU); every RawMatch
field must be equal, and so must the expansion's vote stream. The JAX
package's candidate-pruned rank, which the port does not have, gives the
answer of the port's sort rank wherever its certificate holds (and its
fallback, the sort rank, everywhere else).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shazam_tpu.index import store as jstore
from shazam_tpu.match import lookup as jl
from shazam_tpu_torch.index import store
from shazam_tpu_torch.match import lookup as tl

N_SONGS, STRIDE, Q = 4000, 1024, 512
KW = dict(n_songs=N_SONGS, delta_min=-256, delta_range=1536, topn=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs files in parallel worker processes: torch's CPU ops
    here use one thread so that the workers do not oversubscribe cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a if a.dtype == bool else a.astype(np.int64))


def _indexes(hi, lo, ex, sid, off, n_songs):
    """The same sorted rows as a JAX and a port device index."""
    order = np.lexsort((off, sid, ex, lo, hi))
    cols = [a[order] for a in (hi, lo, ex, sid, off)]
    jix = jstore.FingerprintIndex(*cols, n_songs=n_songs,
                                  max_offset=int(off.max()))
    tix = store.from_numpy(*cols, n_songs, int(off.max()))
    return jix, tix


def _assert_same(got, want, *why):
    for field, g, w in zip(tl.RawMatch._fields, got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w)), (field, *why)


@pytest.fixture(scope="module")
def planted():
    """200,000 random rows over dense keys (many multi-row runs), a song
    planted at one delta (1234, 400 rows) and a runner-up (777, 120 rows
    at offset 500); 400 query lanes of 512 hit the planted rows."""
    rng = np.random.default_rng(12)
    n = 200_000
    hi = rng.integers(0, 1 << 12, n, dtype=np.uint32)
    lo = rng.integers(0, 1 << 4, n, dtype=np.uint32)
    ex = rng.integers(0, 1 << 2, n, dtype=np.uint32)
    sid = rng.integers(0, N_SONGS, n, dtype=np.uint32)
    off = rng.integers(0, 1000, n, dtype=np.uint32)
    plant = rng.choice(n, 400, replace=False)
    sid[plant] = 1234
    off[plant] = np.sort(rng.integers(60, 900, 400)).astype(np.uint32)
    plant2 = rng.choice(np.setdiff1d(np.arange(n), plant), 120, replace=False)
    sid[plant2] = 777
    off[plant2] = 500
    jix, tix = _indexes(hi, lo, ex, sid, off, N_SONGS)

    def padq(a):
        out = np.zeros(Q, a.dtype)
        out[:400] = a
        return out

    valid = np.arange(Q) < 400
    q = (padq(hi[plant]), padq(lo[plant]), padq(ex[plant]),
         padq((off[plant].astype(np.int64) - 40).astype(np.uint32)),
         valid, valid)
    miss = (np.full(Q, 0xFFFFFFF0, np.uint32),) + q[1:]
    assert jix.offset_stride == tix.offset_stride == STRIDE
    return jix.device_arrays(), tix.device_arrays("cpu"), q, miss


def _run_both(planted, q, jfn, tfn, **kw):
    jdev, tdev, _, _ = planted
    want = jfn(jdev, *(jnp.asarray(a) for a in q), offset_stride=STRIDE,
               **kw)
    got = tfn(tdev, *(_t(a) for a in q), **kw)
    return got, want


@pytest.mark.parametrize("blk", [0, 512])
@pytest.mark.parametrize("cap", [65536, 256])       # fits; clamps
@pytest.mark.parametrize("rank", ["sort", "scan"])
def test_sparse_matcher_matches_jax(planted, rank, cap, blk):
    got, want = _run_both(planted, planted[2], jl.match_query_sparse,
                          tl.match_query_sparse, match_capacity=cap,
                          expand_block=blk, vote_rank=rank, **KW)
    _assert_same(got, want, rank, cap, blk)
    if cap == 65536:
        assert int(got.top_songs[0]) == 1234 and int(got.n_dropped) == 0
        # and the dense histogram's answer
        dense = tl.match_query(planted[1], *(_t(a) for a in planted[2]),
                               match_capacity=cap, **KW)
        _assert_same(got, dense, "dense")
    else:
        assert int(got.n_dropped) > 0 and int(got.total_rows) > cap


@pytest.mark.parametrize("n_cand,cap,topn,query", [
    (1, 65536, 2, "hit"),        # one candidate: the certificate fails
    (2, 65536, 2, "hit"),
    (256, 65536, 2, "hit"),
    (N_SONGS, 65536, 2, "hit"),  # every song a candidate: always exact
    (256, 256, 2, "hit"),        # clamped stream
    (2, 256, 2, "hit"),
    (256, 65536, 1, "hit"),      # topn 1: the runner bound decides
    (64, 65536, 2, "miss"),      # no votes: excluded_max == 0
])
def test_pruned_matcher_matches_jax(planted, n_cand, cap, topn, query):
    """The JAX package's pruned matcher, certificate and fallback, gives
    the port's sort rank field for field."""
    q = planted[2] if query == "hit" else planted[3]
    kw = dict(KW, topn=topn, match_capacity=cap)
    got, (want, jok) = _run_both(
        planted, q,
        lambda *a, **k: jl.match_query_pruned(*a, n_candidates=n_cand, **k),
        tl.match_query_sparse, **kw)
    _assert_same(got, want, n_cand, cap, topn, query)
    if n_cand == 1:
        assert not bool(jok)
    if n_cand == N_SONGS or query == "miss":
        assert bool(jok)


@pytest.mark.parametrize("rank,n_cand", [("dense", 0), ("sort", 0),
                                         ("scan", 0), ("pruned", 256),
                                         ("pruned", 0)])   # the sort rank
def test_match_by_rank_matches_jax(planted, rank, n_cand):
    """The one rank dispatcher gives the named JAX matcher's RawMatch on a
    clamped stream. The JAX package's pruned rank (and, with no
    candidates, its sort rank) gives the port's sort rank, and the port
    refuses the name."""
    kw = dict(KW, match_capacity=256)
    if rank == "dense":
        jfn = jl.match_query
    elif rank == "pruned" and n_cand:
        def jfn(*a, **k):
            return jl.match_query_pruned(*a, n_candidates=n_cand, **k)[0]
    else:
        def jfn(*a, **k):
            return jl.match_query_sparse(
                *a, vote_rank="sort" if rank == "pruned" else rank, **k)

    def tfn(*a, **k):
        return tl.match_by_rank(*a, rank="sort" if rank == "pruned" else rank,
                                **k)

    got, want = _run_both(planted, planted[2], jfn, tfn, **kw)
    _assert_same(got, want, rank, n_cand)
    if rank == "pruned":
        with pytest.raises(ValueError, match="unknown vote_rank"):
            tl.match_by_rank(planted[1], *(_t(a) for a in planted[2]),
                             rank=rank, **kw)


def _stream(seed):
    """An adversarial vote stream: heavy (song, delta) ties, out-of-range
    deltas, song ids past n_songs, sparse or empty validity."""
    rng = np.random.default_rng(200 + seed)
    cap = 4096
    n_songs = int(rng.choice([1, 2, 3, 64, 500]))
    delta_range = int(rng.choice([64, 1280]))
    sid = rng.integers(0, n_songs + int(rng.choice([0, 1, 3])), cap)
    delta = rng.integers(-64, delta_range, cap) - 32
    valid = rng.random(cap) < rng.choice([0.0, 0.05, 0.9])
    first = rng.random(cap) < 0.6
    kw = dict(n_songs=n_songs, delta_min=-32, delta_range=delta_range,
              topn=int(rng.choice([1, 2, 3, 5])))
    return (sid, delta, first, valid), kw


def _ranks_both(jrank, trank, stream, **kw):
    sid, delta, first, valid = stream
    n = int(valid.sum())
    want = jrank(jnp.asarray(sid, jnp.int32), jnp.asarray(delta, jnp.int32),
                 jnp.asarray(first), jnp.asarray(valid), jnp.int32(n),
                 jnp.int32(3), **kw)
    got = trank(*(_t(a) for a in stream), _t(n), _t(3), **kw)
    return got, want


@pytest.mark.parametrize("seed", range(8))
def test_vote_ranks_match_jax_randomized(seed):
    stream, kw = _stream(seed)
    sort_raw, want = _ranks_both(jl._sparse_vote_rank, tl._sparse_vote_rank,
                                 stream, **kw)
    _assert_same(sort_raw, want, "sort", seed, kw)
    scan_raw, want = _ranks_both(jl._scan_vote_rank, tl._scan_vote_rank,
                                 stream, **kw)
    _assert_same(scan_raw, want, "scan", seed, kw)
    _assert_same(scan_raw, sort_raw, "scan == sort", seed, kw)
    # the JAX package's pruned rank, where its certificate holds, gives
    # the sort rank's answer. It takes song ids under n_songs only (no
    # matcher makes others): the ids past it, non-votes to the sort rank,
    # are invalid lanes for it
    sid, delta, first, valid = stream
    in_catalog = valid & (sid < kw["n_songs"])
    for c in (1, 2, 16):
        want, jok = jl._pruned_vote_rank(
            jnp.asarray(sid, jnp.int32), jnp.asarray(delta, jnp.int32),
            jnp.asarray(first), jnp.asarray(in_catalog),
            jnp.int32(int(valid.sum())), jnp.int32(3), n_candidates=c, **kw)
        if bool(jok):
            _assert_same(sort_raw, want, "pruned", c, seed, kw)


@pytest.mark.parametrize("sid,delta", [
    ([0] * 64, [0] * 64),                            # one bin
    ([5, 5, 2, 2] * 8, [7, 7, 9, 9] * 8),           # two songs tie: id 2
    ([3] * 64, [10] * 32 + [4] * 32),                # delta tie: delta 4
])
@pytest.mark.parametrize("valid", [False, True])
def test_vote_rank_tie_rules_match_jax(sid, delta, valid):
    n = len(sid)
    stream = (np.array(sid), np.array(delta), np.ones(n, bool),
              np.full(n, valid))
    kw = dict(n_songs=8, delta_min=0, delta_range=64, topn=2)
    for jrank, trank in ((jl._sparse_vote_rank, tl._sparse_vote_rank),
                         (jl._scan_vote_rank, tl._scan_vote_rank)):
        got, want = _ranks_both(jrank, trank, stream, **kw)
        _assert_same(got, want, trank.__name__)


@pytest.fixture(scope="module")
def runs():
    """50,000 rows over few keys (long runs), (song, offset) distinct
    within a key; 100 valid query lanes of 128."""
    rng = np.random.default_rng(17)
    n, n_songs = 50000, 40
    hi = rng.integers(0, 200, n, dtype=np.uint32)
    lo = rng.integers(0, 4, n, dtype=np.uint32)
    ex = np.zeros(n, np.uint32)
    sid = rng.integers(0, n_songs, n, dtype=np.uint32)
    off = rng.integers(0, 3000, n, dtype=np.uint32)
    key = (hi.astype(np.uint64) << 40) | (lo.astype(np.uint64) << 32) \
        | (sid.astype(np.uint64) << 12) | off
    _, keep = np.unique(key, return_index=True)
    jix, tix = _indexes(*(a[keep] for a in (hi, lo, ex, sid, off)), n_songs)
    pick = rng.integers(0, jix.n_hashes, 128)
    valid = np.arange(128) < 100
    q_hi = np.where(valid, jix.key_hi[pick], 0xFFFFFFFF).astype(np.uint32)
    q = (q_hi, jix.key_lo[pick], jix.key_ex[pick],
         rng.integers(0, 50, 128).astype(np.uint32), valid, valid)
    kw = dict(n_songs=n_songs, delta_min=-64, delta_range=4096 + 128,
              topn=4)
    return jix, tix, q, kw


@pytest.mark.parametrize("blk,rank", [(128, "sort"), (512, "sort"),
                                      (512, "scan"), (512, "pruned")])
def test_blocked_expansion_matches_scalar_and_jax(runs, blk, rank):
    jix, tix, q, kw = runs
    tdev = tix.device_arrays("cpu")
    tq = [_t(a) for a in q]
    ref = tl.match_query_sparse(tdev, *tq, match_capacity=1 << 16, **kw)
    assert int(ref.n_dropped) == 0
    if rank == "pruned":
        # the JAX package's pruned rank against the port's sort rank
        got = tl.match_query_sparse(tdev, *tq, match_capacity=1 << 16,
                                    expand_block=blk, **kw)
        want, _ = jl.match_query_pruned(
            jix.device_arrays(), *(jnp.asarray(a) for a in q),
            match_capacity=1 << 16, expand_block=blk, n_candidates=8,
            offset_stride=jix.offset_stride, **kw)
    else:
        got = tl.match_query_sparse(tdev, *tq, match_capacity=1 << 16,
                                    expand_block=blk, vote_rank=rank, **kw)
        want = jl.match_query_sparse(
            jix.device_arrays(), *(jnp.asarray(a) for a in q),
            match_capacity=1 << 16, expand_block=blk, vote_rank=rank,
            offset_stride=jix.offset_stride, **kw)
    _assert_same(got, ref, "scalar", blk, rank)
    _assert_same(got, want, "jax", blk, rank)


@pytest.fixture(scope="module")
def hot_runs():
    """8 hot keys (~5,120 rows each) and 64 query lanes, 8 of them valid,
    or 16 valid lanes hitting each key twice."""
    rng = np.random.default_rng(23)
    n = 40960
    hi = np.sort(rng.integers(0, 8, n).astype(np.uint32))
    z = np.zeros(n, np.uint32)
    sid = rng.integers(0, 20, n, dtype=np.uint32)
    off = rng.integers(0, 3000, n, dtype=np.uint32)
    jix, tix = _indexes(hi, z, z, sid, off, 20)
    true_len = np.bincount(hi, minlength=8)
    return jix, tix, true_len


@pytest.mark.parametrize("lanes,cap,runs_budget,dropped", [
    (16, 8192, 0, None),     # 2 x 40,960 rows into 8,192: clamps
    (8, 65536, 8, 0),        # run budget = nonempty runs: no-op
    (8, 65536, 5, 3),        # 3 runs over the budget, dropped
])
def test_blocked_expansion_budgets_match_jax(hot_runs, lanes, cap,
                                             runs_budget, dropped):
    jix, tix, true_len = hot_runs
    q_n = 64 if lanes == 8 else 16
    q_hi = np.full(q_n, 0xFFFFFFFF, np.uint32)
    q_hi[:lanes] = np.arange(lanes) % 8
    valid = np.arange(q_n) < lanes
    zq = np.zeros(q_n, np.uint32)
    q = (q_hi, zq, zq, np.arange(q_n, dtype=np.uint32), valid)
    kw = dict(match_capacity=cap, expand_block=512, expand_runs=runs_budget)
    got = tl._expand(tix.device_arrays("cpu"), *(_t(a) for a in q), **kw)
    want = jl._expand(jix.device_arrays(), *(jnp.asarray(a) for a in q),
                      offset_stride=jix.offset_stride, **kw)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    _sid, _delta, p, ok, total, n_dropped = got
    assert int(total) == true_len[q_hi[:lanes]].sum()
    if runs_budget:
        assert p.shape[0] == (cap // 512 + 2 * runs_budget) * 512
    # included runs are whole; each excluded one counts in n_dropped
    kept = np.bincount(p[ok].numpy(), minlength=q_n)[:lanes]
    want_len = true_len[q_hi[:lanes]]
    assert all(k in (0, w) for k, w in zip(kept, want_len))
    assert int((kept == 0).sum()) == int(n_dropped)
    assert dropped is None or int(n_dropped) == dropped
    if dropped is None:
        assert int(n_dropped) > 0


def test_search_bounds_are_reused(planted):
    """with_bounds returns the search's (lb, ub) (equal to the JAX
    package's, from its match and from its exact-total probe, whose total
    is the clamped match's ``total_rows``); a match given them back as
    ``bounds`` equals the one that searched itself."""
    jdev, tdev, q, _ = planted
    tq = [_t(a) for a in q]
    jq = [jnp.asarray(a) for a in q]
    kw = dict(KW, match_capacity=256, vote_rank="scan", expand_block=512)
    raw, lb, ub = tl.match_query_sparse(tdev, *tq, with_bounds=True, **kw)
    jraw, jlb, jub = jl.match_query_sparse(
        jdev, *jq, offset_stride=STRIDE, with_bounds=True, **kw)
    _assert_same(raw, jraw)
    total, lb2, ub2 = jl.query_total(jdev, jq[0], jq[1], jq[2], jq[4],
                                     with_bounds=True)
    for a, b in ((lb, jlb), (ub, jub), (lb2, lb), (ub2, ub)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert int(total) == int(raw.total_rows) > 256
    again = tl.match_query_sparse(tdev, *tq, bounds=(lb, ub),
                                  **dict(kw, match_capacity=65536))
    fresh = tl.match_query_sparse(tdev, *tq, **dict(kw, match_capacity=65536))
    _assert_same(again, fresh)
    got = tl.match_by_rank(tdev, *tq, rank="sort", bounds=(lb, ub),
                           **dict(KW, match_capacity=65536))
    _assert_same(got, fresh)


def _meta_paths():
    """Every match path of the port, on meta tensors (shapes only)."""
    from shazam_tpu_torch.index.store import DeviceIndex
    from shazam_tpu_torch.match.ondevice import recognize_fingerprints
    from shazam_tpu_torch.ops.fingerprint import Fingerprints

    def ints(*shape):
        return torch.empty(shape, dtype=torch.int64, device="meta")

    def bools(*shape):
        return torch.empty(shape, dtype=torch.bool, device="meta")

    index = DeviceIndex(ints(4096), ints(4096), ints(4096), 4000, 1024)
    stacked = DeviceIndex(ints(3, 4096), ints(3, 4096), ints(3, 4096), 9000,
                          1024)
    q = (ints(Q), ints(Q), ints(Q), ints(Q), bools(Q), bools(Q))
    bounds = (ints(Q), ints(Q))
    fp = Fingerprints(ints(1, 2048), ints(1, 2048), ints(1, 2048),
                      ints(1, 2048), bools(1, 2048),
                      torch.empty(1, dtype=torch.int32, device="meta"))
    kw = dict(n_songs=50, delta_min=-1024, delta_range=6144, topn=2,
              match_capacity=1024)
    return {
        "dense": lambda: tl.match_query(index, *q, **kw),
        "sort": lambda: tl.match_query_sparse(index, *q, **kw),
        "scan_blocked": lambda: tl.match_query_sparse(
            index, *q, vote_rank="scan", expand_block=128, expand_runs=16,
            with_bounds=True, **kw),
        "bounds_reuse": lambda: tl.match_by_rank(
            index, *q, rank="scan", expand_block=128, expand_runs=16,
            bounds=bounds, **kw),
        "with_bounds": lambda: tl.match_by_rank(index, *q, rank="sort",
                                                with_bounds=True, **kw),
        "spanned_sort": lambda: tl.match_query_sparse_spanned(
            stacked, *q, expand_block=128, expand_runs=16, with_bounds=True,
            **kw),
        "clip_dense": lambda: recognize_fingerprints(
            fp, index, query_capacity=512, **kw),
    }


@pytest.mark.parametrize("path", list(_meta_paths()))
def test_match_paths_never_read_back(path):
    """recognize_clip reads the device back once, at the end: no match
    path may sync the host before. Meta tensors hold no values, so any
    ``.item()`` (a 0-dim tensor index included) raises here."""
    _meta_paths()[path]()
