"""Port parity for apriori early exit (shazam_tpu_torch/match/apriori.py) on
the CPU.

The same index and ``QueryPairs`` go through the JAX package's
``match_query_apriori`` / ``match_query_apriori_ondevice`` and the port's:
every ``RawMatch`` field, the batches used and the clamp flag must be
equal. Mirrors ``tests/test_match.py:210``, ``:245`` and ``:274``,
``tests/test_edges.py:91`` and ``tests/test_harness.py:68`` (through
``SIA``), plus the accumulators against JAX's ``match_local`` and
``rank_votes`` and the warning cases of ``recognize_samples``.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_match import (_build_db, _index_from_rows, _query_from_pairs,
                              _random_hex, _run_match)

from shazam_tpu_torch.api import SIA
from shazam_tpu_torch.audio import synth_song
from shazam_tpu_torch.config import FingerprintConfig
from shazam_tpu_torch.index.store import FingerprintIndex
from shazam_tpu_torch.match import apriori
from shazam_tpu_torch.match.lookup import (accumulate_votes, raw_to_host,
                                           rank_votes)
from shazam_tpu_torch.match.prepare import QueryPairs

FIELDS = ("top_songs", "top_deltas", "top_votes", "row_counts", "total_rows",
          "n_ranked", "n_dropped", "runner_votes")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _port_index(jix):
    ix = FingerprintIndex(jix.key_hi, jix.key_lo, jix.key_ex, jix.song_id,
                          jix.offset, n_songs=jix.n_songs,
                          max_offset=jix.max_offset)
    return ix.device_arrays("cpu")


def _kw(jix, pad=100, **kw):
    return dict(n_songs=jix.n_songs, delta_min=-(jix.max_offset + pad),
                delta_range=2 * (jix.max_offset + pad), **kw)


def _both(jix, q, fn, **kw):
    """(JAX result, port result) of one apriori variant on the same
    index and query; each (RawMatch, used, clamped)."""
    from shazam_tpu.match import apriori as japriori

    want = getattr(japriori, fn)(jix.device_arrays(), q,
                                 offset_stride=jix.offset_stride, **kw)
    got = getattr(apriori, fn)(_port_index(jix), QueryPairs(*q), **kw)
    return want, got


def _assert_same(want, got):
    (wraw, wused, wcl), (graw, gused, gcl) = want, got
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(graw, f)),
                                      np.asarray(getattr(wraw, f)), f)
    assert (gused, gcl) == (int(wused), bool(wcl))


def _near_equal_query(rows):
    songs = [r for r in rows if r[1] in (1, 2)]
    return _query_from_pairs(
        sorted({(h, max(off - 5, 0)) for h, _s, off in songs[:160]}),
        pad_to=2048)


def _skewed_query(rows):
    song3 = [r for r in rows if r[1] == 3]
    return _query_from_pairs(sorted({(h, off + 7) for h, _s, off in
                                     song3[:400]}), pad_to=2048)


def test_apriori_without_exit_matches_full(rng):
    """``test_match.py:210``: near-equal support, the margin never fires,
    every batch runs, and the result equals the one-shot match."""
    rows = _build_db(rng, n_songs=6, rows_per_song=150)
    jix = _index_from_rows(rows)
    q = _near_equal_query(rows)
    kw = _kw(jix, match_capacity=65536, topn=3, batch_size=64)
    want, got = _both(jix, q, "match_query_apriori", **kw)
    _assert_same(want, got)
    raw, used, _ = got
    assert used == -(-q.n_pairs // 64) > 1
    full = _run_match(jix, q, topn=3)
    for f in ("top_songs", "top_deltas", "top_votes"):
        n = min(3, int(full.n_ranked))
        np.testing.assert_array_equal(np.asarray(getattr(raw, f))[:n],
                                      np.asarray(getattr(full, f))[:n])
    assert int(raw.total_rows) == int(full.total_rows)


def test_apriori_early_exit_fires(rng):
    """``test_match.py:245``: a skewed query stops mid-sweep, the partial
    leader is the true song, and JAX stops at the same batch."""
    rows = _build_db(rng, n_songs=6, rows_per_song=150)
    jix = _index_from_rows(rows)
    q = _skewed_query(rows)
    kw = _kw(jix, match_capacity=65536, topn=3, batch_size=256)
    want, got = _both(jix, q, "match_query_apriori", **kw)
    _assert_same(want, got)
    raw, used, _ = got
    assert used < -(-len(q.hi) // 256)
    assert int(raw.top_songs[0]) == 3 and int(raw.top_votes[0]) > 0


@pytest.mark.parametrize("which,batch_size", [
    ("near", 64), ("near", 56), ("skewed", 32), ("skewed", 24),
    ("skewed", 12), ("skewed", 8)])
def test_apriori_ondevice_equals_host_loop(rng, which, batch_size):
    """``test_match.py:274``: the device variant equals the host loop, and
    both equal JAX's two variants, batch for batch; batch counts that are
    not powers of two exercise JAX's padded batch count and the port's
    flag reads at batches 1, 2, 4, ..."""
    rows = _build_db(rng, n_songs=6, rows_per_song=150)
    jix = _index_from_rows(rows)
    q = _near_equal_query(rows) if which == "near" else _skewed_query(rows)
    kw = _kw(jix, match_capacity=65536, topn=3, batch_size=batch_size)
    host_want, host_got = _both(jix, q, "match_query_apriori", **kw)
    dev_want, dev_got = _both(jix, q, "match_query_apriori_ondevice", **kw)
    _assert_same(host_want, host_got)
    _assert_same(dev_want, dev_got)
    _assert_same(host_want, dev_got)
    n_batches = -(-q.n_pairs // batch_size)
    assert n_batches & (n_batches - 1) or batch_size in (64, 32)
    if which == "skewed":
        assert dev_got[1] < n_batches


def test_device_variant_gates_batches_launched_after_the_stop(rng):
    """A stop that the device variant reads late (between flag reads) still
    gives the host loop's result: the batches launched past it add
    nothing."""
    rows = _build_db(rng, n_songs=6, rows_per_song=150)
    jix = _index_from_rows(rows)
    q = _skewed_query(rows)
    seen = []
    for bs in range(4, 40):
        kw = _kw(jix, match_capacity=65536, topn=3, batch_size=bs)
        host = apriori.match_query_apriori(_port_index(jix), QueryPairs(*q),
                                           **kw)
        dev = apriori.match_query_apriori_ondevice(_port_index(jix),
                                                   QueryPairs(*q), **kw)
        _assert_same(host, dev)
        seen.append((host[1], -(-q.n_pairs // bs)))
    late = [(u, n) for u, n in seen if u & (u - 1) and u < n]
    assert late, seen


def test_apriori_multibatch_total_not_flagged_overflow():
    """``test_edges.py:91``: an accumulated total past one batch's capacity
    is not a clamp; a batch past it is."""
    rng = np.random.default_rng(51)
    hexes = _random_hex(rng, 200)
    rows = [(h, 2 + r, 100 + 2 * i + r) for i, h in enumerate(hexes)
            for r in (0, 1)]
    jix = _index_from_rows(rows)
    q = _query_from_pairs(sorted({(h, 7) for h in hexes}))
    for fn in ("match_query_apriori", "match_query_apriori_ondevice"):
        kw = _kw(jix, pad=50, match_capacity=128, batch_size=32)
        want, got = _both(jix, q, fn, **kw)
        _assert_same(want, got)
        raw, used, clamped = got
        assert used > 1 and int(raw.total_rows) == 400 and not clamped
        kw = _kw(jix, pad=50, match_capacity=32, batch_size=32)
        want, got = _both(jix, q, fn, **kw)
        _assert_same(want, got)
        assert got[2]


def test_rank_votes_and_accumulators_match_jax(rng):
    """``lookup.rank_votes`` against JAX's on tie-heavy histograms, and
    ``accumulate_votes`` over one vote stream against JAX's
    ``match_local``."""
    from shazam_tpu.match.lookup import match_local
    from shazam_tpu.match.lookup import rank_votes as jax_rank

    for n_songs, topn in ((7, 3), (1, 2), (2, 5)):
        hist = rng.integers(0, 3, (n_songs, 40)).astype(np.int32)
        rows = rng.integers(0, 9, n_songs).astype(np.int32)
        want = jax_rank(jnp.asarray(hist), jnp.asarray(rows), jnp.int32(77),
                        delta_min=-13, topn=topn, n_dropped=jnp.int32(4))
        got, _ = raw_to_host(rank_votes(
            torch.from_numpy(hist), torch.from_numpy(rows),
            torch.tensor(77), delta_min=-13, topn=topn,
            n_dropped=torch.tensor(4)))
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)), f)

    from shazam_tpu_torch.match.lookup import _expand

    db = _build_db(rng, n_songs=5, rows_per_song=120)
    jix = _index_from_rows(db)
    q = _skewed_query(db)
    kw = _kw(jix)
    h, r, t, nd = match_local(
        jix.device_arrays(), *(jnp.asarray(a) for a in q[:6]),
        match_capacity=300, offset_stride=jix.offset_stride, **kw)
    index = _port_index(jix)
    cols = [torch.from_numpy(np.asarray(a).astype(
        bool if a.dtype == bool else np.int64)) for a in q[:6]]
    sid, delta, p, valid, total, n_dropped = _expand(
        index, *cols[:4], cols[4], match_capacity=300)
    hist = torch.zeros((kw["n_songs"], kw["delta_range"]), dtype=torch.int32)
    rows_hist = torch.zeros(kw["n_songs"], dtype=torch.int32)
    accumulate_votes(hist, rows_hist, sid, delta, cols[5][p], valid,
                     delta_min=kw["delta_min"])
    np.testing.assert_array_equal(hist.numpy(), np.asarray(h))
    np.testing.assert_array_equal(rows_hist.numpy(), np.asarray(r))
    assert (int(total), int(n_dropped)) == (int(t), int(nd))
    accumulate_votes(hist, rows_hist, sid, delta, cols[5][p], valid,
                     delta_min=kw["delta_min"], live=torch.tensor(False))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(h))


# ---- through SIA ---------------------------------------------------------------
N_SONGS, DUR = 4, 10.0


@pytest.fixture(scope="module")
def engines():
    """The port and the JAX package over the same songs."""
    from shazam_tpu.api import SIA as JaxSIA

    songs = [(f"track{i:06d}", synth_song(i, duration_s=DUR, seed=21))
             for i in range(N_SONGS)]
    port = SIA(device="cpu")
    port.ingest_arrays(songs, batch_size=4)
    ref = JaxSIA()
    ref.ingest_arrays(songs, batch_size=4)
    return port, ref, songs


def _top(res):
    top = res["results"][0]
    return (top["song_name"], top["offset"], top["hashes_matched_in_input"],
            res["total_matches"], res["overflowed"], res["partial_counts"])


def test_early_exit_recognition(engines):
    """``test_harness.py:68``: early exit names the full match's song, and
    the port's answer equals the JAX package's, counts included."""
    port, ref, _songs = engines
    song = synth_song(1, duration_s=DUR, seed=21)
    clip = song[int(2.0 * 44100): int(7.0 * 44100)]
    full = port.recognize_samples([clip])
    fast = port.recognize_samples([clip], early_exit=True)
    assert fast["results"][0]["song_name"] == full["results"][0]["song_name"]
    assert fast["results"][0]["song_name"] == "track000001"
    assert _top(fast) == _top(ref.recognize_samples([clip], early_exit=True))
    stereo = [clip, (clip * 0.5).astype(clip.dtype)]
    assert _top(port.recognize_samples(stereo, None, True)) == \
        _top(ref.recognize_samples(stereo, None, True))


def test_early_exit_routes_to_the_device_variant(engines, monkeypatch):
    port, _ref, songs = engines
    calls = []
    orig = apriori.match_query_apriori_ondevice

    def spy(*a, **k):
        calls.append(k["match_capacity"])
        return orig(*a, **k)

    import shazam_tpu_torch.api as api_mod

    monkeypatch.setattr(api_mod, "match_query_apriori_ondevice", spy)
    port.recognize_samples([songs[2][1][44100: 5 * 44100]], early_exit=True)
    assert calls == [port.config.match_capacity]


def test_recognize_file_early_exit(engines, tmp_path):
    from shazam_tpu_torch.audio.io import write_wav

    port, ref, songs = engines
    path = str(tmp_path / "clip.wav")
    write_wav(path, songs[3][1][3 * 44100: 8 * 44100], 44100)
    got = port.recognize_file(path, None, None, True)
    assert got["results"][0]["song_name"] == "track000003"
    assert _top(got) == _top(ref.recognize_file(path, early_exit=True))


def test_early_exit_past_the_sparse_threshold_warns_as_jax(engines):
    """Past ``sparse_vote_threshold`` both packages warn and run the full
    match; under it neither warns."""
    import dataclasses

    port, ref, songs = engines
    clip = songs[0][1][44100: 5 * 44100]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port.recognize_samples([clip], early_exit=True)
    base, ref_base = port.config, ref.config
    try:
        port.config = dataclasses.replace(base, sparse_vote_threshold=1000)
        ref.config = dataclasses.replace(ref_base, sparse_vote_threshold=1000)
        with pytest.warns(UserWarning) as got:
            out = port.recognize_samples([clip], early_exit=True)
        with pytest.warns(UserWarning) as want:
            ref_out = ref.recognize_samples([clip], early_exit=True)
        assert [str(w.message) for w in got] == [str(w.message) for w in want]
        assert "sparse-matcher threshold" in str(got[0].message)
        assert got[0].filename == __file__
        assert _top(out) == _top(port.recognize_samples([clip]))
        assert _top(out) == _top(ref_out)
    finally:
        port.config, ref.config = base, ref_base
    assert isinstance(port.config, FingerprintConfig)
