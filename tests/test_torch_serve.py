"""Port parity for the HTTP serving daemon (shazam_tpu_torch/serve.py) on
the CPU.

Mirrors ``tests/test_serve.py`` (all but the spanned store): concurrent
mono requests coalesce into ONE recognize_batch dispatch with per-request
results identical to recognize_samples; multi-channel requests take the
channel-union path; errors are reported per request, never crossing the
batch; every route, auth, limits, /metrics, the pipeline on and off and
graceful close. Also the daemon's /recognize against the JAX package's
recognize_samples on the same seeded catalog and clips. One module-scoped
catalog of 5 x 8 s songs.
"""

import io
import json
import threading
import urllib.request
import urllib.error
import wave

import numpy as np
import pytest

import torch

from shazam_tpu_torch.api import SIA as PortSIA
from shazam_tpu_torch.audio import synth_song
from shazam_tpu_torch.match.tiers import match_tiers
from shazam_tpu_torch.serve import RecognitionServer

N_SONGS = 5
DUR = 8.0
FS = 44100


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def SIA(**kw):
    return PortSIA(device="cpu", **kw)


def _wav_bytes(samples: np.ndarray, fs: int = FS) -> bytes:
    arr = np.asarray(samples).astype(np.int16)
    if arr.ndim == 1:
        n_ch, frames = 1, arr
    else:
        n_ch, frames = arr.shape[0], arr.T.reshape(-1)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(n_ch)
        wf.setsampwidth(2)
        wf.setframerate(fs)
        wf.writeframes(frames.tobytes())
    return buf.getvalue()


def _post(url: str, body: bytes, timeout: float = 300.0):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def server():
    sia = SIA()
    sia.ingest_arrays(
        [(f"s{i}", synth_song(i, duration_s=DUR, seed=31))
         for i in range(N_SONGS)])
    srv = RecognitionServer(sia, port=0, max_batch=8, max_wait_ms=400.0,
                            request_timeout_s=600.0)
    srv.start_background()
    yield srv
    srv.close()


def _clip(sid: int, start_s: float = 1.0, secs: float = 5.0):
    song = synth_song(sid, duration_s=DUR, seed=31)
    a = int(start_s * FS)
    return song[a: a + int(secs * FS)]


def test_single_request(server):
    url = f"http://127.0.0.1:{server.port}/recognize?topn=2"
    code, out = _post(url, _wav_bytes(_clip(1)))
    assert code == 200
    assert out["results"][0]["song_name"] == "s1"
    assert out["total_matches"] > 0
    # reference one-shot flow ends with a metadata fetch for the top
    # match (recognizer.py:397); synthetic names carry none
    assert "metadata" in out and out["metadata"] is None


def test_concurrent_requests_batch(server):
    """4 concurrent posts coalesce (max_wait 400 ms) into >=1 shared
    batch and every clip still gets its own correct top-1."""
    url = f"http://127.0.0.1:{server.port}/recognize"
    results = {}

    def hit(sid):
        code, out = _post(url, _wav_bytes(_clip(sid, start_s=1.5)))
        results[sid] = (code, out)

    threads = [threading.Thread(target=hit, args=(sid,))
               for sid in range(N_SONGS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    for sid, (code, out) in results.items():
        assert code == 200
        assert out["results"][0]["song_name"] == f"s{sid}", (sid, out)
    assert server.batcher.stats["max_batch"] >= 2  # genuinely micro-batched


def test_stereo_channel_union(server):
    """2-channel requests take the recognize_samples channel-union path."""
    clip = _clip(2)
    stereo = np.stack([clip, clip])
    url = f"http://127.0.0.1:{server.port}/recognize"
    code, out = _post(url, _wav_bytes(stereo))
    assert code == 200
    assert out["results"][0]["song_name"] == "s2"


def test_stats_and_health(server):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/healthz", timeout=30) as r:
        assert json.loads(r.read())["ok"]
    # self-contained: one request so the counter is non-zero even when
    # this test runs alone
    code, _ = _post(f"http://127.0.0.1:{server.port}/recognize",
                    _wav_bytes(_clip(1)))
    assert code == 200
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["n_songs"] == N_SONGS
    assert stats["requests"] >= 1
    assert stats["index_hashes"] > 0


def test_bad_requests(server):
    url = f"http://127.0.0.1:{server.port}/recognize"
    code, out = _post(url, b"not a wav file")
    assert code == 400 and "error" in out

    # mismatched sample rate resamples (SIA default) rather than erroring;
    # loud failure with resample=False is covered in test_resample.py
    code, out = _post(url, _wav_bytes(_clip(0), fs=22050))
    assert code == 200 and "results" in out

    code, out = _post(f"http://127.0.0.1:{server.port}/nope", b"x")
    assert code == 404

    # over-length clips are rejected before any device work (each new
    # length bucket would compile a fresh program)
    long_clip = np.tile(_clip(0), 20)  # 100 s > 60 s cap
    code, out = _post(url, _wav_bytes(long_clip))
    assert code == 400 and "request cap" in out["error"]

    code, out = _post(url, _wav_bytes(_clip(3)))
    assert code == 200 and out["results"][0]["song_name"] == "s3"


def test_batcher_survives_engine_errors(server):
    """A raising engine must produce per-request 500s, not a dead
    batcher thread (every later request would 504 silently)."""
    sia = server.sia
    orig = sia.prepare_batch  # the pipelined batcher's stage-1 entry

    def boom(*a, **k):
        raise RuntimeError("transient device fault")

    sia.prepare_batch = boom
    try:
        url = f"http://127.0.0.1:{server.port}/recognize"
        results = {}

        def hit(i):
            results[i] = _post(url, _wav_bytes(_clip(i, start_s=2.0)))

        threads = [threading.Thread(target=hit, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # batched path raised -> per-request errors (if the two posts
        # didn't coalesce, they took recognize_samples and succeeded —
        # either way nothing hangs and the server stays up)
        for code, out in results.values():
            assert code in (200, 500)
    finally:
        sia.prepare_batch = orig

    code, out = _post(url, _wav_bytes(_clip(1)))
    assert code == 200 and out["results"][0]["song_name"] == "s1"


def test_online_ingest_then_recognize(server):
    """POST /ingest grows the live index between recognition batches:
    the new song is immediately recognizable, and byte-identical
    re-uploads dedup by sample SHA-1 (reference resume semantics)."""
    base = f"http://127.0.0.1:{server.port}"
    new_song = synth_song(77, duration_s=DUR, seed=31)
    body = _wav_bytes(new_song)
    code, out = _post(f"{base}/ingest?name=newtrack", body)
    assert code == 200, out
    assert out["ingested"] == 1 and out["hashes"] > 100

    code, again = _post(f"{base}/ingest?name=newtrack_copy", body)
    assert code == 200
    assert again["skipped"] == 1 and again["ingested"] == 0

    clip = np.asarray(new_song)[int(1.5 * FS): int(6.5 * FS)]
    code, rec = _post(f"{base}/recognize", _wav_bytes(clip))
    assert code == 200
    assert rec["results"][0]["song_name"] == "newtrack"

    # old songs still recognized against the grown index
    code, rec = _post(f"{base}/recognize", _wav_bytes(_clip(0)))
    assert code == 200 and rec["results"][0]["song_name"] == "s0"


def test_ingest_requires_name(server):
    code, out = _post(f"http://127.0.0.1:{server.port}/ingest",
                      _wav_bytes(_clip(0)))
    assert code == 400 and "name" in out["error"]


def test_stats_latency_summary(server):
    # self-contained: make one recognition and one ingest so the
    # counters are non-zero regardless of which other tests ran
    code, _ = _post(f"http://127.0.0.1:{server.port}/recognize",
                    _wav_bytes(_clip(0)))
    assert code == 200
    code, _ = _post(
        f"http://127.0.0.1:{server.port}/ingest?name=latsum",
        _wav_bytes(synth_song(123, duration_s=DUR, seed=9)))
    assert code == 200
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/stats", timeout=30) as r:
        s = json.loads(r.read())
    assert s["ingests"] >= 1
    lat = s["latency"]
    assert lat["count"] >= 1
    assert lat["p50_ms"] > 0 and lat["p99_ms"] >= lat["p50_ms"]


def test_persisted_online_ingest_survives_restart(tmp_path):
    """--persist semantics: POST /ingest saves the index, so a fresh
    process recognizes the song; without it load_index purges the
    orphaned catalog row (held on the JAX package by
    ``test_load_index_reconciles_orphaned_catalog_rows``)."""
    db = str(tmp_path / "cat")
    sia = SIA(catalog_path=db + ".sqlite")
    sia.ingest_arrays([("base", synth_song(0, duration_s=DUR, seed=5))])
    sia.save_index(db + ".npz")
    srv = RecognitionServer(sia, port=0, max_batch=4,
                            persist_path=db + ".npz")
    srv.start_background()
    try:
        song = synth_song(9, duration_s=DUR, seed=5)
        code, out = _post(f"http://127.0.0.1:{srv.port}/ingest?name=live",
                          _wav_bytes(song))
        assert code == 200 and out["ingested"] == 1
    finally:
        srv.close()

    sia2 = SIA(catalog_path=db + ".sqlite")
    sia2.load_index(db + ".npz")
    assert {d["song_name"] for d in sia2.catalog.get_songs()} == \
        {"base", "live"}
    clip = np.asarray(song)[int(1.0 * FS): int(6.0 * FS)]
    out = sia2.recognize_samples([clip])
    assert out["results"][0]["song_name"] == "live"


def test_metrics_endpoint(server):
    """GET /metrics exposes the /stats counters in Prometheus text
    exposition format and agrees with /stats."""
    base = f"http://127.0.0.1:{server.port}"
    with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
        stats = json.loads(r.read())
    with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    values = {line.split()[0]: line.split()[1]
              for line in text.splitlines() if not line.startswith("#")}
    assert int(values["sia_requests_total"]) >= stats["requests"] - 1
    assert int(values["sia_catalog_n_songs"]) == stats["n_songs"]
    assert int(values["sia_index_hashes"]) > 0
    assert 'sia_request_latency_milliseconds{quantile="0.50"}' in text
    assert int(values["sia_request_latency_milliseconds_count"]) >= 1


def test_save_endpoint(server, tmp_path):
    """POST /save snapshots the live index on demand (runs on the
    batcher thread); without a path and without --persist it reports
    the misconfiguration instead of writing nowhere."""
    import os

    base = f"http://127.0.0.1:{server.port}"
    path = str(tmp_path / "snap.npz")
    code, out = _post(f"{base}/save?path={path}", b"")
    assert code == 200 and out["saved"] == path
    assert os.path.getsize(path) > 0

    code, out = _post(f"{base}/save", b"")
    assert code == 500 and "no save path" in out["error"]


def test_graceful_signal_shutdown():
    """SIGTERM stops the listener without killing in-flight state: the
    serve loop returns, and close() drains the batcher cleanly."""
    import os
    import signal

    sia = SIA()
    sia.ingest_arrays([("x", synth_song(0, duration_s=DUR, seed=31))])
    srv = RecognitionServer(sia, port=0, max_batch=4)
    t = srv.start_background()
    old = signal.getsignal(signal.SIGTERM)
    try:
        srv.install_signal_handlers(sigs=(signal.SIGTERM,))
        code, out = _post(
            f"http://127.0.0.1:{srv.port}/recognize", _wav_bytes(_clip(0)))
        assert code == 200
        os.kill(os.getpid(), signal.SIGTERM)
        t.join(timeout=30)
        assert not t.is_alive()
    finally:
        signal.signal(signal.SIGTERM, old)
        srv.close()


def test_streaming_session(server):
    """Continuous listening over HTTP: open a session, feed raw int16
    PCM chunks, recognize mid-stream (incremental engine — device work
    proportional to new audio), close."""
    base = f"http://127.0.0.1:{server.port}"
    code, out = _post(f"{base}/stream/open?channels=1&window=10", b"")
    assert code == 200, out
    sid = out["session"]
    assert out["channels"] == 1 and out["window_seconds"] == 10.0

    clip = np.asarray(_clip(3, start_s=1.0, secs=6.0)).astype(np.int16)
    for i in range(6):  # 1 s chunks
        code, out = _post(f"{base}/stream/feed?session={sid}",
                          clip[i * FS:(i + 1) * FS].tobytes())
        assert code == 200, out
    assert out["buffered_seconds"] > 5.0

    code, out = _post(f"{base}/stream/recognize?session={sid}", b"")
    assert code == 200
    assert out["results"][0]["song_name"] == "s3"

    # feed + recognize in one round trip
    code, out = _post(f"{base}/stream/feed?session={sid}&recognize=1",
                      clip[:FS].tobytes())
    assert code == 200
    assert "buffered_seconds" in out and out["results"]

    code, out = _post(f"{base}/stream/close?session={sid}", b"")
    assert code == 200 and out["closed"]
    code, out = _post(f"{base}/stream/recognize?session={sid}", b"")
    assert code == 500 and "unknown or expired" in out["error"]


def test_stream_request_validation(server):
    base = f"http://127.0.0.1:{server.port}"
    code, out = _post(f"{base}/stream/nosuchop?session=x", b"")
    assert code == 404
    code, out = _post(f"{base}/stream/feed", b"\x00\x00")
    assert code == 400 and "session" in out["error"]
    code, out = _post(f"{base}/stream/open", b"")
    sid = out["session"]
    try:
        # odd byte count is not int16 PCM
        code, out = _post(f"{base}/stream/feed?session={sid}", b"\x00")
        assert code == 400 and "int16" in out["error"]
        # empty body likewise
        code, out = _post(f"{base}/stream/feed?session={sid}", b"")
        assert code == 400
        # interleave mismatch (3 samples into a 2-channel session)
        code, out = _post(f"{base}/stream/open?channels=2", b"")
        sid2 = out["session"]
        code, out = _post(f"{base}/stream/feed?session={sid2}",
                          b"\x00\x00" * 3)
        assert code == 500 and "multiple" in out["error"]
        _post(f"{base}/stream/close?session={sid2}", b"")
    finally:
        _post(f"{base}/stream/close?session={sid}", b"")


def test_stream_limits_and_ttl():
    """Session cap rejects the N+1th open; idle sessions are evicted
    after the TTL (so a leaked client can't pin state forever)."""
    import time as _time

    sia = SIA()
    sia.ingest_arrays([("x", synth_song(0, duration_s=DUR, seed=31))])
    srv = RecognitionServer(sia, port=0, max_streams=1, stream_ttl_s=0.5)
    srv.start_background()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        code, out = _post(f"{base}/stream/open", b"")
        assert code == 200
        code, out = _post(f"{base}/stream/open", b"")
        assert code == 500 and "too many open streams" in out["error"]
        _time.sleep(0.7)  # first session idles past the TTL
        code, out = _post(f"{base}/stream/open", b"")
        assert code == 200
    finally:
        srv.close()


def test_online_delete(server):
    """POST /delete removes a song from the live catalog+index (the
    reference's DELETE_SONGS admin workflow, run against the daemon)."""
    base = f"http://127.0.0.1:{server.port}"
    song = synth_song(55, duration_s=DUR, seed=31)
    code, out = _post(f"{base}/ingest?name=doomed", _wav_bytes(song))
    assert code == 200 and out["ingested"] == 1

    clip = np.asarray(song)[int(1.0 * FS): int(6.0 * FS)]
    code, rec = _post(f"{base}/recognize", _wav_bytes(clip))
    assert rec["results"][0]["song_name"] == "doomed"

    code, out = _post(f"{base}/delete?songs=doomed", b"")
    assert code == 200, out
    assert out["deleted_songs"] == 1 and out["removed_rows"] > 100

    code, rec = _post(f"{base}/recognize", _wav_bytes(clip))
    assert code == 200
    assert all(r["song_name"] != "doomed" for r in rec["results"])

    code, out = _post(f"{base}/delete?songs=nosuchsong", b"")
    assert code == 500 and "unknown song" in out["error"]

    code, out = _post(f"{base}/delete", b"")
    assert code == 400


def test_device_resident_ingest_delete_save(server, tmp_path):
    """/ingest, /delete, /save, /stats and /metrics on a device-resident
    SIA over the module's catalog and index (copied): the store absorbs
    the online ingest on the device, /stats reads it without a host sync,
    the delete syncs and drops it, and the snapshot reloads into a
    host-backed SIA that fsck passes and that answers alike."""
    import copy
    import os

    from shazam_tpu_torch.tools.fsck import check_integrity

    def with_catalog_of(other, **kw):
        sia = SIA(**kw)
        sia.catalog.conn.executescript(
            "\n".join(other.catalog.conn.iterdump()).replace(
                "CREATE TABLE", "CREATE TABLE IF NOT EXISTS"))
        return sia

    src = server.batcher.sia
    sia = with_catalog_of(src, device_resident=True,
                          index=copy.deepcopy(src.index),
                          device_reserve_hashes=1 << 17)
    srv = RecognitionServer(sia, port=0, max_batch=4, max_wait_ms=50.0)
    srv.start_background()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        rows0 = sia._live_n_hashes()
        song = synth_song(66, duration_s=DUR, seed=31)
        code, out = _post(f"{base}/ingest?name=resident", _wav_bytes(song))
        assert code == 200 and out["ingested"] == 1, out
        store = sia._dev_store
        assert store is not None and sia._host_stale
        assert store.capacity == 1 << 17
        code, rec = _post(f"{base}/recognize",
                          _wav_bytes(song[int(1.0 * FS): int(6.0 * FS)]))
        assert rec["results"][0]["song_name"] == "resident"
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["index_hashes"] == rows0 + out["hashes"]
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            assert f"sia_index_hashes {rows0 + out['hashes']}" in r.read().decode()
        assert sia._host_stale       # neither read synced the host index

        code, out = _post(f"{base}/delete?songs=s3", b"")
        assert code == 200 and out["removed_rows"] > 100
        assert sia._dev_store is None   # rebuilt on the host, as in JAX
        assert sia._live_n_hashes() == stats["index_hashes"] - out["removed_rows"]
        path = str(tmp_path / "resident.npz")
        code, out = _post(f"{base}/save?path={path}", b"")
        assert code == 200 and os.path.getsize(path) > 0
        clip = _clip(1)
        code, want = _post(f"{base}/recognize", _wav_bytes(clip))
    finally:
        srv.close()
    fresh = with_catalog_of(sia)
    fresh.load_index(path)
    assert check_integrity(fresh)["ok"]
    assert fresh.index.n_hashes == sia._live_n_hashes()
    got = fresh.recognize_samples([clip])["results"][0]
    assert (got["song_name"], got["offset"]) == (
        want["results"][0]["song_name"], want["results"][0]["offset"])


def test_cross_rate_request(server):
    """A 48 kHz upload is resampled to the config rate before matching
    (SIA(resample=True) default); the daemon must still identify it."""
    from shazam_tpu_torch.audio.resample import resample_channel

    clip48 = resample_channel(_clip(2).astype(np.float32), FS, 48000)
    url = f"http://127.0.0.1:{server.port}/recognize"
    code, out = _post(url, _wav_bytes(clip48, fs=48000))
    assert code == 200
    assert out["results"][0]["song_name"] == "s2"


def test_keepalive_survives_error_replies(server):
    """Error replies must drain the request body first: a 400/500 with
    unread bytes on the socket breaks the NEXT request on a keep-alive
    connection (the client sees a broken pipe instead of the reply)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
    try:
        # /save with a body and no configured path -> 500, body drained
        conn.request("POST", "/save", body=b"x" * 4096)
        r = conn.getresponse()
        assert r.status == 500 and b"save path" in r.read()
        # same socket: undecodable WAV -> 400 after a full drain
        conn.request("POST", "/recognize", body=b"not a wav " * 1000)
        r = conn.getresponse()
        assert r.status == 400
        r.read()
        # same socket: /delete with a body -> still usable
        conn.request("POST", "/delete", body=b"y" * 2048)
        r = conn.getresponse()
        assert r.status == 400
        r.read()
        # and a real recognition still flows over the same connection
        conn.request("POST", "/recognize", body=_wav_bytes(_clip(1)))
        r = conn.getresponse()
        out = json.loads(r.read())
        assert r.status == 200
        assert out["results"][0]["song_name"] == "s1"
    finally:
        conn.close()


def test_oversized_body_advertises_close(server):
    """A body too large to drain is never read — the reply must carry
    Connection: close so the client doesn't reuse the dead socket."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
    try:
        conn.putrequest("POST", "/recognize")
        conn.putheader("Content-Length", str(300 << 20))
        conn.endheaders()  # headers only: the server must not wait for 300 MB
        r = conn.getresponse()
        out = json.loads(r.read())
        assert r.status == 400 and "oversized" in out["error"]
        assert r.headers.get("Connection", "").lower() == "close"
    finally:
        conn.close()


def test_riff_non_wave_routes_to_ffmpeg(server):
    """A RIFF container that isn't WAVE (e.g. AVI) must not be fed to the
    WAV parser — it takes the ffmpeg spool path and fails as a decode
    error, not as a malformed-WAV chunk error."""
    url = f"http://127.0.0.1:{server.port}/recognize"
    avi = b"RIFF" + (64).to_bytes(4, "little") + b"AVI " + b"\x00" * 64
    code, out = _post(url, avi)
    assert code == 400
    assert "fmt+data" not in out["error"]  # the WAV chunk walker's message


def test_auth_token_gates_mutations():
    """serve --auth-token: /ingest, /delete, /save require the bearer
    token (401 otherwise, keep-alive preserved); recognition stays open;
    the client SDK sends the token automatically."""
    from shazam_tpu_torch.client import SIAClient, SIAServerError

    sia = SIA()
    sia.ingest_arrays([("base", synth_song(0, duration_s=DUR, seed=77))])
    srv = RecognitionServer(sia, port=0, max_wait_ms=5.0,
                            request_timeout_s=600.0, auth_token="sesame")
    srv.start_background()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        song = synth_song(9, duration_s=DUR, seed=77)

        # no token -> 401 on every mutating route, body drained
        code, out = _post(f"{base}/ingest?name=x", _wav_bytes(song))
        assert code == 401 and "authorization" in out["error"]
        code, out = _post(f"{base}/delete?songs=base", b"")
        assert code == 401
        code, out = _post(f"{base}/save?path=/tmp/nope.npz", b"")
        assert code == 401

        # wrong token -> still 401
        bad = SIAClient(base, auth_token="wrong")
        with pytest.raises(SIAServerError) as ei:
            bad.ingest("x", song, FS)
        assert ei.value.status == 401

        # recognition needs no token
        clip = song[FS: 6 * FS]
        code, out = _post(f"{base}/recognize", _wav_bytes(clip))
        assert code == 200  # (not yet ingested -> just no match)

        # the right token mutates normally, via the SDK
        cli = SIAClient(base, auth_token="sesame")
        out = cli.ingest("gated", song, FS)
        assert out["ingested"] == 1
        rec = cli.recognize(clip, FS)
        assert rec["results"][0]["song_name"] == "gated"
        out = cli.delete("gated")
        assert out["deleted_songs"] == 1
    finally:
        srv.close()


def test_auth_non_ascii_header_is_401_not_crash():
    """hmac.compare_digest raises TypeError on non-ASCII str; a stray
    latin-1 Authorization header must yield 401, not a dropped
    connection from a handler crash."""
    import http.client

    sia = SIA()
    sia.ingest_arrays([("x", synth_song(0, duration_s=DUR, seed=99))])
    srv = RecognitionServer(sia, port=0, max_wait_ms=5.0,
                            request_timeout_s=600.0, auth_token="sesame")
    srv.start_background()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("POST", "/delete?songs=x", body=b"",
                     headers={"Authorization": "Bearer caf\xe9"})
        r = conn.getresponse()
        assert r.status == 401
        r.read()
        conn.close()
    finally:
        srv.close()


def test_chunked_body_rejected_with_close(server):
    """Chunked uploads can't be drained by Content-Length; every route
    must reject them and mark the connection for close instead of
    leaving chunk bytes to poison the next request."""
    import http.client

    for path in ("/recognize", "/stream/feed?session=zz"):
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=60)
        conn.putrequest("POST", path)
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        conn.send(b"4\r\nwxyz\r\n0\r\n\r\n")
        r = conn.getresponse()
        assert r.status == 400
        assert r.headers.get("Connection", "").lower() == "close"
        r.read()
        conn.close()


def test_warmup_covers_both_stream_engines(server):
    """--warm-stream runs one session of each engine, so neither engine's
    first client pays its first-use work mid-stream."""
    from shazam_tpu_torch import stream as stream_mod
    from shazam_tpu_torch.serve import warmup

    built = []
    real = stream_mod.StreamRecognizer

    class Spy(real):
        def __init__(self, *a, **kw):
            built.append(kw.get("engine", "host"))
            super().__init__(*a, **kw)

    stream_mod.StreamRecognizer = Spy
    try:
        warmup(server.sia, seconds=2.0, max_batch=2,
               stream_window_seconds=3.0)
    finally:
        stream_mod.StreamRecognizer = real
    assert built == ["host", "device"]


def test_warmup_refuses_pair_buckets(server):
    """JAX's pair-bucket warmup has no counterpart here: a caller who sets
    it gets an error, not a setting that silently does nothing."""
    from shazam_tpu_torch.serve import warmup

    with pytest.raises(ValueError, match="pair_buckets"):
        warmup(server.sia, seconds=2.0, max_batch=1, pair_buckets=(1024,))


def test_single_request_takes_batch_path(server):
    """Size-1 micro-batches answer via recognize_batch, the path the
    warmup runs, not recognize_samples."""
    sia = server.sia
    calls = {"batch": 0, "samples": 0}
    # the pipelined batcher calls the two stages directly; counting
    # prepare_batch covers both it and the recognize_batch wrapper
    orig_prep, orig_samples = sia.prepare_batch, sia.recognize_samples

    def count_prep(*a, **k):
        calls["batch"] += 1
        return orig_prep(*a, **k)

    def count_samples(*a, **k):
        calls["samples"] += 1
        return orig_samples(*a, **k)

    sia.prepare_batch = count_prep
    sia.recognize_samples = count_samples
    try:
        url = f"http://127.0.0.1:{server.port}/recognize"
        code, out = _post(url, _wav_bytes(_clip(2)))
        assert code == 200
        assert out["results"][0]["song_name"] == "s2"
    finally:
        sia.prepare_batch = orig_prep
        sia.recognize_samples = orig_samples
    assert calls["batch"] == 1 and calls["samples"] == 0


def test_pipeline_overlap_and_mutation_flush(server):
    """The pipelined batcher (default) answers back-to-back waves
    correctly — batch k+1 is prepared while batch k's match is in
    flight — and an online ingest quiesces the match thread first, so
    the new song is recognizable immediately after its 200."""
    assert server.batcher.pipeline is True
    url = f"http://127.0.0.1:{server.port}/recognize"
    results = {}

    def fire(i, sid):
        code, out = _post(url, _wav_bytes(_clip(sid)))
        results[i] = (code, out["results"][0]["song_name"]
                      if out.get("results") else None)

    threads = [threading.Thread(target=fire, args=(i, i % N_SONGS))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(8):
        assert results[i] == (200, f"s{i % N_SONGS}"), (i, results[i])

    new = synth_song(77, duration_s=DUR, seed=5)
    code, out = _post(
        f"http://127.0.0.1:{server.port}/ingest?name=live77",
        _wav_bytes(new))
    assert code == 200 and out.get("ingested") == 1, out
    code, out = _post(url, _wav_bytes(new[FS: 6 * FS]))
    assert code == 200 and out["results"][0]["song_name"] == "live77"


def test_pinned_tier_server_matches_unpinned(server):
    """A pin_capacity server (serve --pin-tier) dispatches every
    micro-batch at the pinned tier; answers must be identical to the
    default server (per-clip escalation still covers clips whose totals
    exceed the pin)."""
    sia = server.sia
    pin = match_tiers(sia.config)[0]
    srv = RecognitionServer(sia, port=0, max_batch=4, max_wait_ms=5.0,
                            pin_capacity=pin)
    assert srv.batcher.pin_capacity == pin
    srv.start_background()
    try:
        for sid in range(3):
            body = _wav_bytes(_clip(sid))
            code_p, out_p = _post(
                f"http://127.0.0.1:{srv.port}/recognize?topn=2", body)
            code_u, out_u = _post(
                f"http://127.0.0.1:{server.port}/recognize?topn=2", body)
            assert (code_p, code_u) == (200, 200)
            assert out_p["results"] == out_u["results"]
            assert out_p["total_matches"] == out_u["total_matches"]
    finally:
        # each RecognitionServer owns its own MicroBatcher (only the
        # SIA engine is shared with the module fixture's server)
        srv.httpd.shutdown()
        srv.httpd.server_close()
        srv.batcher.close()


def test_pipeline_off_answers_the_same(server):
    """pipeline=False (the single-thread round-robin) gives the pipelined
    daemon's answers, batched."""
    srv = RecognitionServer(server.sia, port=0, max_batch=4,
                            max_wait_ms=300.0, pipeline=False)
    assert srv.batcher.pipeline is False and srv.batcher._mthread is None
    srv.start_background()
    try:
        results = {}

        def fire(sid):
            results[sid] = [
                _post(f"http://127.0.0.1:{p}/recognize?topn=2",
                      _wav_bytes(_clip(sid, start_s=1.25)))
                for p in (srv.port, server.port)]

        threads = [threading.Thread(target=fire, args=(sid,))
                   for sid in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for sid, ((code_a, a), (code_b, b)) in results.items():
            assert (code_a, code_b) == (200, 200)
            assert a["results"][0]["song_name"] == f"s{sid}"
            assert a["results"] == b["results"]
        assert srv.batcher.stats["errors"] == 0
        assert srv.batcher.stats["max_batch"] >= 2
    finally:
        srv.close()


@pytest.fixture(scope="module")
def jax_engine():
    from shazam_tpu.api import SIA as JaxSIA

    sia = JaxSIA()
    sia.ingest_arrays(
        [(f"s{i}", synth_song(i, duration_s=DUR, seed=31))
         for i in range(N_SONGS)])
    return sia


def test_recognize_matches_jax(server, jax_engine):
    """The port daemon's /recognize gives the JAX package's
    recognize_samples top-1 song and offset on the same catalog and
    clips (mono through the batch, stereo through the channel union)."""
    url = f"http://127.0.0.1:{server.port}/recognize?topn=2"
    for sid, start in ((0, 0.5), (4, 2.0)):
        clip = _clip(sid, start_s=start)
        for body, chans in ((_wav_bytes(clip), [clip]),
                            (_wav_bytes(np.stack([clip, clip // 2])),
                             [clip, clip // 2])):
            code, out = _post(url, body)
            want = jax_engine.recognize_samples(chans, topn=2)
            assert code == 200
            top, jtop = out["results"][0], want["results"][0]
            assert (top["song_name"], top["offset"]) == \
                (jtop["song_name"], jtop["offset"]) == (f"s{sid}",
                                                         top["offset"])
            # the hash sets agree to jaccard > 0.98, so their sizes do
            assert abs(out["input_hashes"] - want["input_hashes"]) \
                <= 0.02 * want["input_hashes"]
