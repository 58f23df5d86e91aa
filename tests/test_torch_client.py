"""Port parity for the client SDK (shazam_tpu_torch/client.py) against a
live port daemon on the CPU; mirrors ``tests/test_client.py``.

Contract: every daemon route has a 1:1 client method, audio encoding
round-trips (mono + stereo), streaming sessions work as context
managers, and server errors surface as SIAServerError with the
daemon's message — never a raw urllib exception.
"""

import numpy as np
import pytest
import torch

from shazam_tpu_torch.api import SIA
from shazam_tpu_torch.audio import synth_song
from shazam_tpu_torch.client import SIAClient, SIAServerError, encode_wav
from shazam_tpu_torch.serve import RecognitionServer

N_SONGS = 3
DUR = 8.0
FS = 44100


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def server():
    sia = SIA(device="cpu")
    sia.ingest_arrays(
        [(f"s{i}", synth_song(i, duration_s=DUR, seed=11))
         for i in range(N_SONGS)])
    srv = RecognitionServer(sia, port=0, max_batch=8, max_wait_ms=50.0,
                            request_timeout_s=600.0)
    srv.start_background()
    yield srv
    srv.close()


@pytest.fixture(scope="module")
def client(server):
    return SIAClient(f"http://127.0.0.1:{server.port}")


def _clip(sid: int, start_s: float = 1.0, secs: float = 5.0):
    song = synth_song(sid, duration_s=DUR, seed=11)
    a = int(start_s * FS)
    return np.asarray(song[a: a + int(secs * FS)])


def test_health_stats_metrics(client):
    assert client.healthy()
    stats = client.stats()
    assert stats["n_songs"] == N_SONGS
    text = client.metrics()
    assert "sia_requests_total" in text


def test_recognize_samples_and_wav_and_path(client, tmp_path):
    out = client.recognize(_clip(1), fs=FS)
    assert out["results"][0]["song_name"] == "s1"

    out = client.recognize(wav_bytes=encode_wav(_clip(2), FS), topn=2)
    assert out["results"][0]["song_name"] == "s2"
    assert len(out["results"]) <= 2

    p = tmp_path / "clip.wav"
    p.write_bytes(encode_wav(_clip(0), FS))
    out = client.recognize(path=str(p))
    assert out["results"][0]["song_name"] == "s0"

    with pytest.raises(ValueError, match="exactly one"):
        client.recognize(_clip(0), fs=FS, path=str(p))
    with pytest.raises(ValueError, match="fs"):
        client.recognize(_clip(0))


def test_float_sample_conventions(client):
    """Normalized [-1,1] float audio must scale to int16 — a plain
    astype would truncate it to silence; int16-scale float rounds."""
    clip = _clip(1)
    normalized = clip.astype(np.float32) / 32768.0
    out = client.recognize(normalized, fs=FS)
    assert out["results"][0]["song_name"] == "s1"

    int16_scale = clip.astype(np.float32)  # already at PCM scale
    out = client.recognize(int16_scale, fs=FS)
    assert out["results"][0]["song_name"] == "s1"

    from shazam_tpu_torch.client import _to_int16

    assert np.abs(_to_int16(normalized).astype(np.int32)
                  - clip.astype(np.int32)).max() <= 1
    # int32 beyond range clips instead of wrapping
    assert _to_int16(np.array([40000, -40000])).tolist() == [32767, -32768]


def test_stream_normalized_float_feed(client):
    clip = _clip(2, start_s=1.0, secs=6.0)
    with client.open_stream(channels=1, window_seconds=10.0) as s:
        s.feed(clip.astype(np.float64) / 32768.0)
        hit = s.recognize()
    assert hit["results"][0]["song_name"] == "s2"


def test_stereo_encode(client):
    clip = _clip(1)
    out = client.recognize(np.stack([clip, clip]), fs=FS)
    assert out["results"][0]["song_name"] == "s1"


def test_ingest_delete_save(client, tmp_path):
    song = np.asarray(synth_song(42, duration_s=DUR, seed=11))
    out = client.ingest("fresh", song, fs=FS)
    assert out["ingested"] == 1

    hit = client.recognize(song[FS: 6 * FS], fs=FS)
    assert hit["results"][0]["song_name"] == "fresh"

    path = str(tmp_path / "snap.npz")
    assert client.save(path)["saved"] == path

    out = client.delete("fresh")
    assert out["deleted_songs"] == 1
    hit = client.recognize(song[FS: 6 * FS], fs=FS)
    assert all(r["song_name"] != "fresh" for r in hit["results"])


def test_server_errors_surface(client):
    with pytest.raises(SIAServerError) as ei:
        client.recognize(wav_bytes=b"not a wav")
    assert ei.value.status == 400

    with pytest.raises(SIAServerError) as ei:
        client.delete("no_such_song_name")
    assert ei.value.status == 500 and "unknown song" in ei.value.message


def test_stream_session(client):
    clip = _clip(2, start_s=1.0, secs=6.0).astype(np.int16)
    with client.open_stream(channels=1, window_seconds=10.0) as s:
        for i in range(6):
            out = s.feed(clip[i * FS:(i + 1) * FS])
        assert out["buffered_seconds"] > 5.0
        hit = s.recognize()
        assert hit["results"][0]["song_name"] == "s2"
        # piggybacked recognition
        out = s.feed(clip[:FS], recognize=True)
        assert out["results"][0]["song_name"] == "s2"


def test_stream_closed_after_context(client):
    with client.open_stream(channels=1) as s:
        sid = s.session_id
    from shazam_tpu_torch.client import StreamSession

    stale = StreamSession(client, sid, 1)
    with pytest.raises(SIAServerError, match="unknown or expired"):
        stale.recognize()


@pytest.mark.parametrize("engine", ["host", "device"])
def test_stream_session_engines(client, engine):
    """open_stream(engine=...) reaches both port engines."""
    clip = _clip(0, start_s=0.5, secs=6.0).astype(np.int16)
    with client.open_stream(channels=1, window_seconds=4.0,
                            engine=engine) as s:
        for i in range(0, len(clip) - 8192, 8192):
            s.feed(clip[i: i + 8192])
        assert s.recognize()["results"][0]["song_name"] == "s0"


def test_client_is_a_copy_of_the_jax_client():
    """The port's SDK is the JAX package's, apart from the docstring: the
    two daemons speak one protocol."""
    import ast
    import inspect

    import shazam_tpu.client as jax_client
    import shazam_tpu_torch.client as port_client

    def body(mod):
        tree = ast.parse(inspect.getsource(mod))
        tree.body = tree.body[1:]          # the module docstring
        return ast.dump(tree)

    assert body(port_client) == body(jax_client)
    rng = np.random.default_rng(5)
    stereo = rng.normal(0, 0.3, (2, 1000))
    assert port_client.encode_wav(stereo, 44100) == \
        jax_client.encode_wav(stereo, 44100)
