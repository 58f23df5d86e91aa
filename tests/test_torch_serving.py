"""The port's sharded serving engine (``parallel/serving.py``) and the
daemon's and stream engine's facade hooks.

One spawn of 4 gloo ranks (``test_torch_sharding.spawn_ranks``) runs the
``ShardedCatalog`` cases at world sizes 1, 2 and 4, the HTTP daemon over a
``ShardedRecognizer`` at world size 2 (rank 0 serves, rank 1 follows) and
the facade cases at world size 1; the parent holds them against the port's
own ``SIA`` and against the JAX package's ``ShardedCatalog`` on a mesh of
the same size, over the same index and the same prepared queries.

Mirrors ``tests/test_serving.py``: both regimes, the HTTP daemon, the
capacity escalation, warmup (also with stream sessions), streaming, and
apriori early exit (key-range) and its by-song fallback. Its jit-cache
test has no counterpart: the port compiles no program per query.
"""

import io
import os
import shutil
import wave

import numpy as np
import pytest

from tests.test_torch_sharding import WORLDS, cpu_meshes, host_raw, spawn_ranks

FS = 44100
N_SONGS = 5
DUR = 8.0


def _song(i):
    from shazam_tpu_torch.audio import synth_song

    return synth_song(i, DUR, seed=31)


def _clip(i, a, b):
    return _song(i)[int(a * FS): int(b * FS)]


def _wav_bytes(samples) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(FS)
        wf.writeframes(np.asarray(samples).astype(np.int16).tobytes())
    return buf.getvalue()


def _res(m):
    """A MatchResult (port or JAX) as comparable plain values."""
    return ([(r["song_id"], r["song_name"], r["offset"],
              r["hashes_matched_in_input"]) for r in m.results],
            m.total_matches, m.overflowed, m.partial_counts)


def _out(d):
    """A recognize_samples / daemon answer as comparable plain values."""
    return ([(r["song_id"], r["song_name"], r["offset"],
              r["hashes_matched_in_input"]) for r in d["results"]],
            d["total_matches"], d["overflowed"], d["input_hashes"])


# ---- the ranks' work --------------------------------------------------------

def _post(url, body):
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _daemon(rec, clips):
    """Rank 0 at world size 2: the HTTP daemon over the recognizer, a
    refused mutation, and one stream session."""
    import json
    import urllib.request

    from shazam_tpu_torch.serve import RecognitionServer
    from shazam_tpu_torch.stream import CHUNK, StreamRecognizer

    out = {}
    srv = RecognitionServer(rec, port=0, max_batch=4, max_wait_ms=50.0,
                            request_timeout_s=600.0)
    srv.start_background()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        out["http"] = [_post(f"{base}/recognize?topn=3", _wav_bytes(c))
                       for c in clips]
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            out["stats"] = json.loads(r.read())
        out["ingest"] = _post(f"{base}/ingest?name=new", _wav_bytes(clips[0]))
    finally:
        srv.close()
    song = _clip(3, 1.0, 7.0).astype(np.int16)
    sr = StreamRecognizer(rec, channels=1, window_seconds=4.0)
    for a in range(0, len(song) - CHUNK, CHUNK):
        sr.feed(song[a: a + CHUNK])
    out["stream"] = (sr.recognize(), sr.recognize(incremental=False))
    return out


def _facade(rec, ix, clip_a, clip_b):
    """Rank 0 at world size 1: early exit on both regimes, warmup."""
    import warnings

    from shazam_tpu_torch.parallel.serving import (ShardedCatalog,
                                                   ShardedRecognizer)
    from shazam_tpu_torch.serve import warmup

    out = {"early": _out(rec.recognize_samples([clip_a], topn=3,
                                               early_exit=True)),
           "full": _out(rec.recognize_samples([clip_a], topn=3))}
    by_song = ShardedRecognizer(ShardedCatalog(
        ix, mesh=rec.cat.mesh, catalog=rec.catalog, dense_limit_bytes=1))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out["by_song_early"] = _out(by_song.recognize_samples(
            [clip_b], topn=3, early_exit=True))
    out["by_song_warned"] = any("key-range" in str(x.message) for x in w)
    # test_serving.py:164 and :207 in one call: the stream sessions come
    # after the whole recognize_samples / recognize_batch warmup
    warmup(rec, seconds=2.0, max_batch=2, stream_window_seconds=2.0)
    out["warm"] = True
    return out


def _ranks_work(rank, world, d, clips, queries, hot):
    import dataclasses

    from shazam_tpu_torch.config import DEFAULT_CONFIG
    from shazam_tpu_torch.index.catalog import SongCatalog
    from shazam_tpu_torch.index.store import FingerprintIndex, from_numpy
    from shazam_tpu_torch.match.apriori import match_query_apriori
    from shazam_tpu_torch.parallel.serving import (ShardedCatalog,
                                                   ShardedRecognizer)
    from shazam_tpu_torch.parallel.sharded import sharded_match_apriori

    ix = FingerprintIndex.load(os.path.join(d, "index.npz"))
    db = os.path.join(d, f"cat{rank}.db")
    shutil.copy(os.path.join(d, "cat.db"), db)
    cat = SongCatalog(db)
    hix = from_numpy(*hot[0], n_songs=50, max_offset=2000)
    meshes = cpu_meshes(rank, WORLDS)
    out = {}
    for n, mesh in meshes.items():
        if mesh is None:
            continue
        for lim in (1 << 30, 1):
            sc = ShardedCatalog(ix, mesh=mesh, catalog=cat,
                                dense_limit_bytes=lim)
            out[("regime", n, lim)] = (sc.stats()["regime"],
                                       _res(sc.match(queries["regime"],
                                                     topn=3)))
        sc = ShardedCatalog(ix, mesh=mesh, catalog=cat)
        q = queries["apriori"]
        qf = sc._q_frames_for(q)
        kw = dict(n_songs=max(sc.n_songs, 1), delta_min=-qf,
                  delta_range=sc._delta_range_for(qf),
                  match_capacity=sc.config.match_capacity, topn=3,
                  batch_size=128)
        raw, used, clamped = sharded_match_apriori(mesh, sc._shards, q, **kw)
        raw1, used1, clamped1 = match_query_apriori(ix.device_arrays("cpu"),
                                                    q, **kw)
        out[("apriori", n)] = (
            _res(sc.match(q, topn=3)),
            _res(sc.match_apriori(q, topn=3, batch_size=128)),
            (host_raw(raw), used, clamped), (host_raw(raw1), used1, clamped1),
            -(-q.n_pairs // 128))
        sc = ShardedCatalog(ix, mesh=mesh, catalog=cat, dense_limit_bytes=1)
        q = queries["by_song"]
        out[("by_song_apriori", n)] = (_res(sc.match(q, topn=3)),
                                       _res(sc.match_apriori(q, topn=3)))
        for cap in (65536, 4096):
            cfg = dataclasses.replace(DEFAULT_CONFIG, match_capacity=cap)
            sc = ShardedCatalog(hix, mesh=mesh, config=cfg,
                                dense_limit_bytes=1 << 30)
            out[("escalate", n, cap)] = _res(sc.match(hot[1], topn=2))
    if rank < 2:
        rec = ShardedRecognizer(ShardedCatalog(ix, mesh=meshes[2],
                                               catalog=cat))
        if rank == 1:
            out["follow"] = rec.follow()
        else:
            try:
                out["daemon"] = _daemon(rec, clips)
            finally:
                rec.close()
    if rank == 0:
        rec = ShardedRecognizer(ShardedCatalog(ix, mesh=meshes[1],
                                               catalog=cat))
        out["facade"] = _facade(rec, ix, _clip(1, 1.0, 7.0),
                                _clip(3, 1.0, 6.0))
    return out


# ---- the parent -------------------------------------------------------------

@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    """The port's SIA on the CPU over 5 synthetic 8 s songs, its index and
    catalog in files the ranks read."""
    from shazam_tpu_torch.api import SIA

    d = tmp_path_factory.mktemp("engine")
    sia = SIA(catalog_path=str(d / "cat.db"), device="cpu")
    sia.ingest_arrays([(f"track{i:06d}", _song(i)) for i in range(N_SONGS)],
                      batch_size=4)
    sia.index.save(str(d / "index.npz"))
    return sia, d


def _query(sia, clip):
    from shazam_tpu_torch.match.prepare import prepare_query

    return prepare_query([sia._fingerprint_channel(clip)])


def _hot_case():
    from shazam_tpu_torch.match.prepare import QueryPairs

    rng = np.random.default_rng(3)
    n, hot = 60_000, 20_000
    hi = rng.integers(0, 2**32, n, dtype=np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint32)
    ex = rng.integers(0, 2**16, n, dtype=np.uint32)
    sid = rng.integers(0, 50, n, dtype=np.uint32)
    off = rng.integers(0, 2000, n, dtype=np.uint32)
    hi[:hot] = 0x7777
    lo[:hot] = 0x8888
    ex[:hot] = 0x99
    sid[:hot] = 7
    off[:hot] = 300
    order = np.lexsort((off, sid, ex, lo, hi))
    cols = tuple(a[order] for a in (hi, lo, ex, sid, off))
    m = 1024
    q_hi = rng.integers(0, 2**32, m, dtype=np.uint32)
    q_lo = rng.integers(0, 2**32, m, dtype=np.uint32)
    q_ex = rng.integers(0, 2**16, m, dtype=np.uint32)
    q_hi[0], q_lo[0], q_ex[0] = 0x7777, 0x8888, 0x99
    q = QueryPairs(q_hi, q_lo, q_ex, np.full(m, 100, np.uint32),
                   np.ones(m, bool), np.ones(m, bool), m)
    return cols, q


@pytest.fixture(scope="module")
def ranks(engine, tmp_path_factory):
    sia, d = engine
    queries = {"regime": _query(sia, _clip(2, 1.5, 6.5)),
               "apriori": _query(sia, _clip(1, 1.0, 7.0)),
               "by_song": _query(sia, _clip(3, 1.0, 6.0))}
    clips = [_clip(2, 1.5, 6.5), _clip(4, 2.0, 6.0)]
    hot = _hot_case()
    port = spawn_ranks(_ranks_work, 4, tmp_path_factory.mktemp("ranks"),
                       str(d), clips, queries, hot)
    return sia, queries, clips, hot, port


def _jax_catalog(sia_or_cols, n, **kw):
    from shazam_tpu.index.store import FingerprintIndex
    from shazam_tpu.parallel.mesh import make_mesh
    from shazam_tpu.parallel.serving import ShardedCatalog

    if isinstance(sia_or_cols, tuple):
        jix = FingerprintIndex(*sia_or_cols, n_songs=50, max_offset=2000)
    else:
        ix = sia_or_cols.index
        jix = FingerprintIndex(ix.key_hi, ix.key_lo, ix.key_ex, ix.song_id,
                               ix.offset, n_songs=ix.n_songs,
                               max_offset=ix.max_offset)
    return ShardedCatalog(jix, mesh=make_mesh(n), **kw)


def _ids(res):
    """(song_id, offset, matched) rows, total, overflowed: what does not
    depend on the catalog's names."""
    rows, total, over, _partial = res
    return [(s, o, m) for s, _name, o, m in rows], total, over


@pytest.mark.parametrize("limit", [1 << 30, 1])   # key_range / by_song
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_catalog_serves(ranks, n, limit):
    sia, queries, clips, _, port = ranks
    regime, got = port[0][("regime", n, limit)]
    assert regime == ("key_range" if limit > 1 else "by_song")
    for r in range(n):
        assert port[r][("regime", n, limit)] == (regime, got)
    assert got[0][0][1] == "track000002"
    single = _out(sia.recognize_samples([clips[0]], topn=3))
    assert (got[0], got[1], got[2]) == (single[0], single[1], single[2])
    want = _jax_catalog(sia, n, dense_limit_bytes=limit).match(
        queries["regime"], topn=3)
    assert _ids(got) == _ids(_res(want))


def test_sharded_recognizer_serves_http(ranks):
    """At world size 2 rank 0 serves the daemon and rank 1 enters every
    match: answers equal the port's SIA, /stats counts the index, a
    mutation is refused, and a stream session over the recognizer agrees
    with its own full recompute."""
    sia, _, clips, _, port = ranks
    daemon, follow = port[0]["daemon"], port[1]["follow"]
    for clip, (status, body) in zip(clips, daemon["http"]):
        assert status == 200
        assert _out(body)[:3] == _out(sia.recognize_samples([clip],
                                                            topn=3))[:3]
    assert daemon["stats"]["index_hashes"] == sia.index.n_hashes
    status, body = daemon["ingest"]
    assert status == 500 and "does not support online catalog mutation" \
        in body["error"]
    inc, full = daemon["stream"]
    assert inc["results"][0]["song_name"] == "track000003"
    assert inc["input_hashes"] == full["input_hashes"]
    assert (inc["results"][0]["hashes_matched_in_input"]
            == full["results"][0]["hashes_matched_in_input"])
    assert inc["results"][0]["offset"] == full["results"][0]["offset"]
    # two recognitions and the stream's two matches went through rank 1
    assert follow == {"matches": 4, "errors": 0}


@pytest.mark.parametrize("cap", [65536, 4096])
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_match_capacity_escalation(ranks, n, cap):
    """A hyper-hot hash (20K rows of one song and delta): every row votes,
    escalating from a small tier where needed, as the JAX package's."""
    import dataclasses

    from shazam_tpu.config import DEFAULT_CONFIG

    _, _, _, hot, port = ranks
    got = port[0][("escalate", n, cap)]
    rows, _total, over, _ = got
    assert not over and rows[0][0] == 7 and rows[0][3] >= 20_000
    want = _jax_catalog(hot[0], n, dense_limit_bytes=1 << 30,
                        config=dataclasses.replace(DEFAULT_CONFIG,
                                                   match_capacity=cap))
    assert _ids(got) == _ids(_res(want.match(hot[1], topn=2)))


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_apriori_early_exit(ranks, n):
    """Key-range apriori exits before the last round on a decisive clip,
    its top-1 is the full match's, it equals the port's single-device
    apriori field for field, and the JAX package's sharded apriori on a
    mesh of the same size."""
    from shazam_tpu.parallel.sharded import sharded_match_apriori

    sia, queries, _, _, port = ranks
    full, part, (raw, used, clamped), (raw1, used1, clamped1), n_batches = \
        port[0][("apriori", n)]
    assert part[0][0][0] == full[0][0][0]
    assert n_batches > 1 and used < n_batches
    assert (used, clamped) == (used1, clamped1)
    for f in raw:
        assert np.array_equal(raw[f], raw1[f]), f
    jsc = _jax_catalog(sia, n)
    q = queries["apriori"]
    qf = jsc._q_frames_for(q)
    jraw, jused, jclamped = sharded_match_apriori(
        jsc.mesh, jsc._shards, q, n_songs=max(jsc.n_songs, 1),
        delta_min=-qf, delta_range=jsc._delta_range_for(qf),
        match_capacity=jsc.config.match_capacity, topn=3, batch_size=128,
        offset_stride=jsc._stride, sharded_head=jsc._head)
    assert (used, clamped) == (jused, jclamped)
    for f in raw:
        assert np.array_equal(raw[f], np.asarray(getattr(jraw, f))), f
    assert _ids(part) == _ids(_res(jsc.match_apriori(q, topn=3,
                                                     batch_size=128)))


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_apriori_by_song_falls_back(ranks, n):
    _, _, _, _, port = ranks
    full, part = port[0][("by_song_apriori", n)]
    assert part == full and full[0][0][1] == "track000003"


def test_facade_early_exit_warmup(ranks):
    """At world size 1: ``early_exit`` reaches the key-range partial scan
    with the full match's top-1; the by-song recognizer warns and runs the
    full match; ``serve.warmup`` drives the whole engine surface, stream
    sessions included."""
    _, _, _, _, port = ranks
    f = port[0]["facade"]
    assert f["early"][0][0][0] == f["full"][0][0][0]
    assert f["by_song_warned"]
    assert f["by_song_early"][0][0][1] == "track000003"
    assert f["warm"]


# ---- the daemon's and stream engine's facade hooks --------------------------

class _Facade:
    """An engine with ``ShardedRecognizer``'s surface over a port SIA: no
    ``prepare_batch``, ``ingest_channels``, ``delete_songs`` or
    ``_match_prepared``, and a ``recognize_batch`` without
    ``match_capacity``."""

    def __init__(self, sia):
        self._sia = sia
        self.config, self.catalog, self.device = (sia.config, sia.catalog,
                                                  sia.device)
        self.prepared = 0

    def _live_n_hashes(self):
        return self._sia._live_n_hashes()

    def get_metadata(self, track_id):
        return self._sia.get_metadata(track_id)

    def recognize_samples(self, channels, topn=None, early_exit=False,
                          q_pad_to=None):
        return self._sia.recognize_samples(channels, topn=topn)

    def recognize_batch(self, clips, topn=None, pad_to_pow2=False,
                        q_pad_to=None):
        return [self.recognize_samples([c], topn=topn) for c in clips]

    def match_prepared(self, q, topn=None):
        from shazam_tpu_torch.match.align import align_results

        self.prepared += 1
        raw, cap = self._sia._match_prepared(q, n_samples=int(3.0 * FS),
                                             topn=topn)
        return align_results(raw, q.n_pairs, catalog=self.catalog,
                             config=self.config, match_capacity=cap)


def test_pipeline_only_for_engines_with_prepare_batch(engine):
    from shazam_tpu_torch.serve import MicroBatcher

    sia, _ = engine
    for eng, want in ((sia, True), (_Facade(sia), False)):
        mb = MicroBatcher(eng, pipeline=True)
        try:
            assert mb.pipeline is want
        finally:
            mb.close()


@pytest.mark.parametrize("pin", [None, 65536])
def test_facade_daemon_recognizes_and_refuses_mutation(engine, pin):
    """A facade engine is served (``match_capacity`` is passed only when
    a tier is pinned, and only to engines that take it), and /ingest and
    /delete are refused with the JAX package's message. With a pin, the
    port's SIA still receives it."""
    from shazam_tpu_torch.serve import RecognitionServer

    sia, _ = engine
    clip = _clip(2, 1.5, 6.5)
    single = _out(sia.recognize_samples([clip], topn=3))
    for eng in ((_Facade(sia),) if pin is None else (_Facade(sia), sia)):
        srv = RecognitionServer(eng, port=0, max_wait_ms=5.0,
                                pin_capacity=pin if eng is sia else None)
        srv.start_background()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            status, body = _post(f"{base}/recognize?topn=3", _wav_bytes(clip))
            assert status == 200 and _out(body)[:3] == single[:3]
            if eng is sia:
                continue
            for route in ("ingest?name=x", "delete?songs=1"):
                status, body = _post(f"{base}/{route}", _wav_bytes(clip))
                assert status == 500
                assert "does not support online catalog mutation" \
                    in body["error"]
        finally:
            srv.close()
    assert sia.index.n_hashes == sia._live_n_hashes()


def test_stream_matches_through_match_prepared_on_facades(engine):
    """``StreamRecognizer.recognize`` takes ``match_prepared`` on engines
    without ``_match_prepared``, with the SIA's answer."""
    from shazam_tpu_torch.stream import CHUNK, StreamRecognizer

    sia, _ = engine
    song = _clip(3, 1.0, 4.5).astype(np.int16)
    facade = _Facade(sia)
    answers = []
    for eng in (sia, facade):
        sr = StreamRecognizer(eng, channels=1, window_seconds=3.0)
        for a in range(0, len(song) - CHUNK, CHUNK):
            sr.feed(song[a: a + CHUNK])
        answers.append(_out(sr.recognize()))
    assert facade.prepared == 1
    assert answers[1] == answers[0]
    assert answers[0][0][0][1] == "track000003"
