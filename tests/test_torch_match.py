"""Port parity, index and match: build/merge, search bounds, RawMatch.

One seeded catalog of hash rows (hyper-common keys shared by many songs,
keys that share their 64-bit prefix but not ex, sentinel-like all-ones
keys) goes into both packages; search bounds and every RawMatch field
must be equal, and an index saved by either package loads in the other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shazam_tpu.index import store as jstore
from shazam_tpu.index.search import lexi_bounds as jax_bounds
from shazam_tpu.index.search import maybe_build_head
from shazam_tpu.match.lookup import match_query as jax_match
from shazam_tpu_torch.index import store
from shazam_tpu_torch.index.search import lexi_bounds
from shazam_tpu_torch.match.lookup import match_query, query_total, raw_to_host

N_SONGS = 12


def _per_song(seed=0, rows=900):
    rng = np.random.default_rng(seed)
    common = rng.integers(0, 1 << 32, (6, 2), dtype=np.uint64).astype(np.uint32)
    out = []
    for sid in range(1, N_SONGS):
        hi = rng.integers(0, 1 << 32, rows, dtype=np.uint64).astype(np.uint32)
        lo = rng.integers(0, 1 << 32, rows, dtype=np.uint64).astype(np.uint32)
        ex = rng.integers(0, 1 << 16, rows).astype(np.uint32)
        off = rng.integers(0, 700, rows).astype(np.uint32)
        hi[:60], lo[:60] = common[np.arange(60) % 6, 0], common[np.arange(60) % 6, 1]
        ex[:60] = np.arange(60) % 3            # one (hi, lo), several ex
        hi[60:62] = lo[60:62] = 0xFFFFFFFF     # all-ones 64-bit prefix
        out.append((sid, hi, lo, ex, off))
    return out


@pytest.fixture(scope="module")
def indexes():
    entries = _per_song()
    jix = jstore.build_index(entries, n_songs=N_SONGS)
    tix = store.build_index(entries, n_songs=N_SONGS)
    return jix, tix


def _queries(jix, seed=1, n=512):
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, jix.n_hashes, n)
    q_hi, q_lo, q_ex = jix.key_hi[pick], jix.key_lo[pick], jix.key_ex[pick]
    q_ex = q_ex.copy()
    q_ex[:40] = (q_ex[:40] + 7) & 0xFFFF            # prefix present, ex absent
    q_hi = q_hi.copy()
    q_hi[40:80] = rng.integers(0, 1 << 32, 40, dtype=np.uint64).astype(np.uint32)
    q_t = rng.integers(0, 100, n).astype(np.uint32)
    order = np.lexsort((q_t, q_ex, q_lo, q_hi))
    q_hi, q_lo, q_ex, q_t = q_hi[order], q_lo[order], q_ex[order], q_t[order]
    valid = np.ones(n, bool)
    valid[-64:] = False                              # padding lanes
    q_hi[-64:] = 0xFFFFFFFF
    same = np.zeros(n, bool)
    same[1:] = ((q_hi[1:] == q_hi[:-1]) & (q_lo[1:] == q_lo[:-1])
                & (q_ex[1:] == q_ex[:-1]))
    first = valid & ~same
    return q_hi, q_lo, q_ex, q_t, valid, first


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64)
                            if np.asarray(a).dtype != bool else np.asarray(a))


def test_build_and_merge_match_jax(indexes):
    jix, tix = indexes
    for name in ("key_hi", "key_lo", "key_ex", "song_id", "offset"):
        assert np.array_equal(getattr(jix, name), getattr(tix, name))
    assert (tix.n_songs, tix.max_offset) == (jix.n_songs, jix.max_offset)
    more = _per_song(seed=5, rows=200)
    jm = jstore.merge_into(jix, jstore.build_index(more, n_songs=N_SONGS))
    tm = store.merge_into(tix, store.build_index(more, n_songs=N_SONGS))
    for name in ("key_hi", "key_lo", "key_ex", "song_id", "offset"):
        assert np.array_equal(getattr(jm, name), getattr(tm, name))


def test_lexi_bounds_match_jax(indexes):
    jix, tix = indexes
    q_hi, q_lo, q_ex, _t_, valid, _f = _queries(jix)
    dev = tix.device_arrays("cpu")
    assert dev.key64.shape[0] % 512 == 0 and dev.n_rows == tix.n_hashes
    lb, ub = lexi_bounds(dev, _t(q_hi), _t(q_lo), _t(q_ex), _t(valid))
    keys = [jnp.asarray(a) for a in (jix.key_hi, jix.key_lo, jix.key_ex)]
    head = maybe_build_head(keys[0])
    assert head is not None
    for h in (None, head):
        jl, ju = jax_bounds(*keys, *(jnp.asarray(a) for a in (q_hi, q_lo, q_ex)),
                            head=h, q_valid=jnp.asarray(valid))
        assert np.array_equal(lb.numpy(), np.asarray(jl))
        assert np.array_equal(ub.numpy(), np.asarray(ju))
    # against a brute-force count of rows holding each 80-bit key
    rows = {}
    for k in zip(jix.key_hi.tolist(), jix.key_lo.tolist(), jix.key_ex.tolist()):
        rows[k] = rows.get(k, 0) + 1
    want = [rows.get(k, 0) if v else 0 for k, v in
            zip(zip(q_hi.tolist(), q_lo.tolist(), q_ex.tolist()), valid)]
    lens = (ub - lb).numpy()
    assert lens.tolist() == want
    assert (lens == 0).sum() > 64 + 40 and lens.max() >= 10 * (N_SONGS - 1)
    assert not lb[-64:].any() and not ub[-64:].any()


@pytest.mark.parametrize("cap", [4096, 300, 16])   # fits; clamps; all but tiny
def test_match_query_matches_jax(indexes, cap):
    jix, tix = indexes
    q = _queries(jix, seed=cap)
    kw = dict(n_songs=N_SONGS, delta_min=-128, delta_range=1024 + 256,
              match_capacity=cap, topn=3)
    raw, _ = raw_to_host(match_query(tix.device_arrays("cpu"),
                                     *(_t(a) for a in q), **kw))
    jraw = jax_match(jix.device_arrays(), *(jnp.asarray(a) for a in q),
                     offset_stride=jix.offset_stride, **kw)
    for field, got, want in zip(raw._fields, raw, jraw):
        assert np.array_equal(np.asarray(got), np.asarray(want)), field
    total = query_total(tix.device_arrays("cpu"), _t(q[0]), _t(q[1]),
                        _t(q[2]), _t(q[4]))
    assert int(total) == raw.total_rows
    if cap == 300:
        assert raw.n_dropped > 0 and raw.total_rows > cap


def test_npz_loads_in_both_packages(indexes, tmp_path):
    jix, tix = indexes
    tix.save(str(tmp_path / "t.npz"))
    jix.save(str(tmp_path / "j.npz"))
    for a, b in ((jstore.FingerprintIndex.load(str(tmp_path / "t.npz")), tix),
                 (store.FingerprintIndex.load(str(tmp_path / "j.npz")), jix)):
        for name in ("key_hi", "key_lo", "key_ex", "song_id", "offset"):
            assert np.array_equal(getattr(a, name), getattr(b, name))
        assert (a.n_songs, a.max_offset) == (b.n_songs, b.max_offset)
    fx = store.from_numpy(jix.key_hi, jix.key_lo, jix.key_ex, jix.song_id,
                          jix.offset, jix.n_songs, jix.max_offset)
    assert np.array_equal(fx.key_ex, tix.key_ex) and fx.n_songs == N_SONGS
