"""Port parity for streaming recognition: ``stream.py`` and
``stream_device.py`` on the CPU, both engines.

Mirrors ``tests/test_stream.py`` (all but the spanned store) and
``tests/test_stream_device.py``: incremental equals the full recompute of
the window, bit for bit (every ``Fingerprints`` field against
``fingerprint_batch_fused`` of the window's samples, and against
``fingerprint_batch`` for a config the kernels do not take); work
proportional to new audio; fixed 16-frame quanta; the engine guards;
capacity escalation. Against the JAX package's stream fed the same
chunks: hash-set jaccard > 0.98 (``tests/test_dsp_parity.py:115``) and the
same top-1 song and offset. One module-scoped catalog of 5 x 8 s songs.
"""

import numpy as np
import pytest
import torch

from shazam_tpu_torch.api import SIA, _bucket_len
from shazam_tpu_torch.audio import synth_song
from shazam_tpu_torch.config import FingerprintConfig
from shazam_tpu_torch.ops.fingerprint import (fingerprint_batch,
                                              fingerprint_batch_fused,
                                              fingerprint_to_hex_pairs)
from shazam_tpu_torch.stream import (CHUNK, IncrementalFingerprinter,
                                     StreamRecognizer)
from shazam_tpu_torch.stream_device import (FRAME_STEP,
                                            DeviceIncrementalFingerprinter)

FS = 44100
N_SONGS, DUR = 5, 8.0
ENGINES = {"host": IncrementalFingerprinter,
           "device": DeviceIncrementalFingerprinter}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _song(i):
    return synth_song(i, duration_s=DUR, seed=31)


@pytest.fixture(scope="module")
def engine():
    sia = SIA(device="cpu")
    sia.ingest_arrays([(f"s{i}", _song(i)) for i in range(N_SONGS)])
    return sia


def _from_scratch(config, samples, capacity):
    """The window's samples fingerprinted in one pass, padded to their
    bucket as ``SIA`` pads them: the kernels' pipeline for the reference
    config, the plain one otherwise."""
    from shazam_tpu_torch.api import _fused_ok

    n = len(samples)
    x = np.zeros((1, _bucket_len(n)), np.float32)
    x[0, :n] = samples
    fn = fingerprint_batch_fused if _fused_ok(config) else fingerprint_batch
    c = config
    fp = fn(torch.from_numpy(x), torch.tensor([n]), fs=c.sample_rate,
            wsize=c.window_size, hop=c.hop, amp_min=c.amp_min,
            radius=c.peak_neighborhood_size, fan_value=c.fan_value,
            min_dt=c.min_hash_time_delta, max_dt=c.max_hash_time_delta,
            peak_capacity=capacity)
    return [a[0] for a in fp]


def _assert_bit_equal(inc, stream, capacity=None):
    a, b = inc.window_sample_range()
    cap = capacity or inc.config.peak_capacity
    got = inc.fingerprints(capacity=cap)
    want = _from_scratch(inc.config, stream[a:b], cap)
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g.cpu(), w), (name, a, b)
    return int(got.n_peaks)


@pytest.mark.parametrize("config", [
    FingerprintConfig(),
    FingerprintConfig(peak_neighborhood_size=8),   # the plain pipeline
], ids=["kernels", "plain"])
@pytest.mark.parametrize("name", ENGINES)
def test_incremental_equals_full_recompute(name, config):
    """After a feed every few chunks, the window's Fingerprints equal a
    from-scratch pass over exactly the window's samples, incl. windows
    that slid past the stream start."""
    stream = synth_song(1, duration_s=12.0, seed=34).astype(np.float32)
    inc = ENGINES[name](config, window_seconds=4.0, device="cpu")
    fed = checks = 0
    while fed + CHUNK <= len(stream):
        inc.feed(stream[fed: fed + CHUNK])
        fed += CHUNK
        if not getattr(inc, "ready", True) or (fed // CHUNK) % 7:
            continue
        assert _assert_bit_equal(inc, stream) > 0
        checks += 1
    assert checks >= 3 and inc.window_sample_range()[0] > 0


def test_incremental_work_proportional_to_new_audio():
    """Per recognize: STFT frames computed == new frames only, and the mask
    recompute is bounded by the two radius-wide edge strips."""
    cfg = FingerprintConfig()
    song = synth_song(2, duration_s=DUR, seed=35).astype(np.float32)
    inc = IncrementalFingerprinter(cfg, window_seconds=4.0, device="cpu")
    hop, r = cfg.hop, cfg.peak_neighborhood_size
    fed = 0
    while fed + CHUNK <= 30 * CHUNK:
        inc.feed(song[fed: fed + CHUNK])
        fed += CHUNK
    frames_before = inc.frames_computed
    strips_before = inc.strip_frames_computed
    inc.feed(song[fed: fed + CHUNK])
    inc.fingerprints()
    assert inc.frames_computed - frames_before == CHUNK // hop
    assert inc.strip_frames_computed - strips_before <= 2 * r


def test_device_feed_consumes_fixed_quanta():
    """Absorbed frames advance in 16-frame quanta, STFT work tracks new
    audio only, and fingerprints() computes no STFT frame."""
    cfg = FingerprintConfig()
    song = synth_song(2, duration_s=DUR, seed=35).astype(np.float32)
    inc = DeviceIncrementalFingerprinter(cfg, window_seconds=4.0,
                                         device="cpu")
    fed = 0
    sizes = [CHUNK, 3000, CHUNK, 12345, 2 * CHUNK]   # odd sizes too
    k = 0
    while fed + sizes[k % len(sizes)] <= len(song):
        step = sizes[k % len(sizes)]
        inc.feed(song[fed: fed + step])
        fed += step
        k += 1
        assert inc.n_frames % FRAME_STEP == 0
    n_quanta = (fed - (cfg.window_size - cfg.hop)) // (FRAME_STEP * cfg.hop)
    assert inc.frames_computed == n_quanta * FRAME_STEP
    assert inc.ready
    before = inc.frames_computed
    _assert_bit_equal(inc, song)
    assert inc.frames_computed == before


def test_device_engine_guards():
    """Too-short windows and wide radii are refused; fingerprints() before
    the ring fills raises OverflowError (the recognizer's fallback)."""
    cfg = FingerprintConfig()
    with pytest.raises(ValueError, match="2.5 s"):
        DeviceIncrementalFingerprinter(cfg, window_seconds=1.0, device="cpu")
    with pytest.raises(ValueError, match="radius"):
        DeviceIncrementalFingerprinter(
            FingerprintConfig(peak_neighborhood_size=17), 4.0, device="cpu")
    with pytest.raises(ValueError, match="2 \\* radius"):
        IncrementalFingerprinter(cfg, window_seconds=0.2, device="cpu")
    inc = DeviceIncrementalFingerprinter(cfg, window_seconds=4.0,
                                         device="cpu")
    inc.feed(np.zeros(CHUNK, np.float32))
    assert not inc.ready
    with pytest.raises(OverflowError):
        inc.fingerprints()


def _stereo(clip):
    out = np.empty(2 * len(clip), np.int16)
    out[0::2] = clip
    out[1::2] = clip
    return out


@pytest.mark.parametrize("name", ENGINES)
def test_stream_recognizer_incremental(engine, name):
    """Chunked stereo feed + incremental recognize() finds the song, never
    falls back once ready, and equals the full recompute."""
    clip = _song(3)[int(0.5 * FS): int(7.5 * FS)]
    stereo = _stereo(clip)
    rec = StreamRecognizer(engine, channels=2, window_seconds=4.0,
                           engine=name)
    outs = []
    for base in range(0, len(stereo) - 2 * CHUNK, 2 * CHUNK):
        rec.feed(stereo[base: base + 2 * CHUNK])
        if rec.ready and rec.buffered_seconds > 3.5:
            outs.append(rec.recognize())
    assert len(outs) >= 3 and rec.fallbacks == 0
    for out in outs:
        assert out["results"][0]["song_name"] == "s3"
    full = rec.recognize(incremental=False)
    inc = rec.recognize()
    assert inc["input_hashes"] == full["input_hashes"]
    assert inc["results"] == full["results"]
    assert inc["total_matches"] == full["total_matches"]


def test_device_recognizer_falls_back_until_ready(engine):
    rec = StreamRecognizer(engine, channels=1, window_seconds=4.0,
                           engine="device")
    rec.feed(_song(1)[: 2 * CHUNK])
    assert not rec.ready
    rec.recognize()
    assert rec.fallbacks == 1
    with pytest.raises(ValueError, match="unknown streaming engine"):
        StreamRecognizer(engine, engine="nope")


@pytest.mark.parametrize("name", ENGINES)
def test_stream_recognizer_escalates_peak_capacity(name):
    """A window that overflows the configured peak capacity escalates it
    (sticky) and STAYS on the incremental path, equal to the full
    recompute."""
    cfg = FingerprintConfig(peak_capacity=64)
    sia = SIA(cfg, device="cpu")
    song = _song(4)
    sia.ingest_arrays([("dense", song)])
    clip = song[int(0.5 * FS): int(7.5 * FS)]
    rec = StreamRecognizer(sia, channels=1, window_seconds=4.0, engine=name)
    outs = []
    for base in range(0, len(clip) - CHUNK, CHUNK):
        rec.feed(clip[base: base + CHUNK])
        if rec.ready and rec.buffered_seconds > 3.5:
            outs.append(rec.recognize())
    assert len(outs) >= 2 and rec.fallbacks == 0
    assert rec._peak_cap > cfg.peak_capacity
    out = rec.recognize()
    assert out["results"][0]["song_name"] == "dense"
    full = rec.recognize(incremental=False)
    assert out["input_hashes"] == full["input_hashes"]
    assert out["results"] == full["results"]


@pytest.mark.parametrize("name", ENGINES)
def test_peak_escalation_jumps_to_fitting_tier(engine, name):
    """The overflow carries the true peak count, so one retry reaches a
    fitting tier."""
    rec = StreamRecognizer(engine, channels=1, window_seconds=4.0,
                           engine=name)
    clip = _song(2)[int(0.5 * FS): int(6.5 * FS)]
    for base in range(0, len(clip) - CHUNK, CHUNK):
        rec.feed(clip[base: base + CHUNK])
    n = int(rec._fps[0].fingerprints().n_peaks)
    assert n > 64
    rec._peak_cap = 64
    calls = []
    real = rec._fps[0].fingerprints
    rec._fps[0].fingerprints = lambda **kw: calls.append(kw) or real(**kw)
    out = rec.recognize()
    assert out["results"][0]["song_name"] == "s2"
    assert len(calls) == 2 and calls[0]["capacity"] == 64
    assert rec._peak_cap >= n and rec._peak_cap // 2 < max(n, 65)


@pytest.fixture(scope="module")
def jax_engine():
    from shazam_tpu.api import SIA as JaxSIA

    sia = JaxSIA()
    sia.ingest_arrays([(f"s{i}", _song(i)) for i in range(N_SONGS)])
    return sia


@pytest.mark.parametrize("name", ENGINES)
def test_stream_matches_jax_stream(engine, jax_engine, name):
    """The same chunks into the port's stream and the JAX package's stream
    of the same engine: the window hash sets agree (jaccard > 0.98) and recognize()
    gives the same top-1 song and offset."""
    from shazam_tpu.ops.fingerprint import \
        fingerprint_to_hex_pairs as jax_hex_pairs
    from shazam_tpu.stream import StreamRecognizer as JaxStream

    clip = _song(1)[int(1.0 * FS): int(7.5 * FS)]
    port = StreamRecognizer(engine, channels=1, window_seconds=5.0,
                            engine=name)
    ref = JaxStream(jax_engine, channels=1, window_seconds=5.0, engine=name)
    sizes = (CHUNK, CHUNK // 2 + 7, 2 * CHUNK)
    pos = k = 0
    while pos + sizes[k % 3] <= len(clip):
        for rec in (port, ref):
            rec.feed(clip[pos: pos + sizes[k % 3]])
        pos += sizes[k % 3]
        k += 1
    assert port.ready
    assert port._fps[0].window_sample_range() == \
        ref._fps[0].window_sample_range()
    got = set(fingerprint_to_hex_pairs(port._fps[0].fingerprints()))
    want = set(jax_hex_pairs(ref._fps[0].fingerprints()))
    assert len(got & want) / len(got | want) > 0.98
    out, jout = port.recognize(), ref.recognize()
    top, jtop = out["results"][0], jout["results"][0]
    assert (top["song_name"], top["offset"]) == \
        (jtop["song_name"], jtop["offset"]) == ("s1", top["offset"])
