"""Port parity for the noise injectors and the acoustic channel.

``shazam_tpu_torch.audio.noise`` and ``.audio.channel`` are numpy/scipy
copies of the JAX package's modules: for the same input and seed each
function must return the same array bit for bit and leave the generator
in the same state (the sweep draws from one generator in order). The
property cases of ``tests/test_channel.py`` run through the port.
"""

import numpy as np
import pytest
import torch

from shazam_tpu.audio import channel as jchannel
from shazam_tpu.audio import noise as jnoise
from shazam_tpu_torch.audio import channel as tchannel
from shazam_tpu_torch.audio import noise as tnoise
from shazam_tpu_torch.audio.synth import synth_music_song

SEEDS = (0, 7, 2026)
SNRS = (-5.0, 0.0, 10.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs files in parallel worker processes: torch's CPU ops
    here use one thread so that the workers do not oversubscribe cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip(seed, n=44100 * 2):
    return np.random.default_rng(seed + 100).normal(0, 4000, n).astype(np.int16)


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("snr", SNRS)
def test_noise_functions_bit_equal(seed, snr):
    clip = _clip(seed)
    noise = _clip(seed + 1, 44100 * 3)
    _equal(tnoise.renormalize(clip), jnoise.renormalize(clip))
    _equal(tnoise.scale_noise_to_snr(clip, noise, snr),
           jnoise.scale_noise_to_snr(clip, noise, snr))
    for fn in ("white_noise_for_snr", "mix_at_snr"):
        args = (clip, snr) if fn == "white_noise_for_snr" else (clip, noise, snr)
        rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
        _equal(getattr(tnoise, fn)(*args, rng=rt),
               getattr(jnoise, fn)(*args, rng=rj))
        assert rt.bit_generator.state == rj.bit_generator.state
        # an int seed and None go through default_rng in both
        _equal(getattr(tnoise, fn)(*args, rng=seed),
               getattr(jnoise, fn)(*args, rng=seed))


def test_noise_edge_cases_equal():
    flat = np.full(100, 7, np.int16)
    _equal(tnoise.renormalize(flat), jnoise.renormalize(flat))
    silent = np.zeros(300, np.int16)
    _equal(tnoise.scale_noise_to_snr(_clip(1, 300), silent, 0.0),
           jnoise.scale_noise_to_snr(_clip(1, 300), silent, 0.0))
    short = _clip(2, 50)       # a noise shorter than the clip is tiled
    _equal(tnoise.mix_at_snr(_clip(3, 400), short, 3.0, rng=5),
           jnoise.mix_at_snr(_clip(3, 400), short, 3.0, rng=5))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("severity", (0.0, 0.5, 1.0))
def test_simulate_channel_bit_equal(seed, severity):
    clip = synth_music_song(seed % 5, duration_s=2.0)
    rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    _equal(tchannel.simulate_channel(clip, rng=rt, severity=severity),
           jchannel.simulate_channel(clip, rng=rj, severity=severity))
    assert rt.bit_generator.state == rj.bit_generator.state
    _equal(tchannel.simulate_channel(clip, fs=48000, rng=seed,
                                     severity=severity),
           jchannel.simulate_channel(clip, fs=48000, rng=seed,
                                     severity=severity))


def test_channel_helpers_equal():
    assert tchannel.CALIBRATED_SEVERITY == jchannel.CALIBRATED_SEVERITY == 0.5
    _equal(tchannel._butter_bandpass_sos(120.0, 7500.0, 44100),
           jchannel._butter_bandpass_sos(120.0, 7500.0, 44100))
    _equal(tchannel._butter_bandpass_sos(80.0, 30000.0, 44100),
           jchannel._butter_bandpass_sos(80.0, 30000.0, 44100))
    _equal(tchannel._room_impulse(np.random.default_rng(4), 44100, 90.0, 0.15),
           jchannel._room_impulse(np.random.default_rng(4), 44100, 90.0, 0.15))


# tests/test_channel.py's property cases, through the port

def test_deterministic_and_shape():
    clip = synth_music_song(1, duration_s=4.0)
    a = tchannel.simulate_channel(clip, rng=7)
    b = tchannel.simulate_channel(clip, rng=7)
    c = tchannel.simulate_channel(clip, rng=8)
    assert a.dtype == np.int16 and len(a) == len(clip)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_band_limit_applied():
    fs = 44100
    t = np.arange(4 * fs) / fs
    x = (8000.0 * np.sin(2 * np.pi * 50.0 * t)
         + 8000.0 * np.sin(2 * np.pi * 1000.0 * t)
         + 8000.0 * np.sin(2 * np.pi * 12000.0 * t)).astype(np.int16)
    y = tchannel.simulate_channel(x, fs=fs, rng=3).astype(np.float64)
    spec = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    f = np.fft.rfftfreq(len(y), 1 / fs)

    def band(fc):
        m = (f > fc * 0.98) & (f < fc * 1.02)
        return spec[m].max()

    assert band(50.0) < 0.05 * band(1000.0)
    assert band(12000.0) < 0.05 * band(1000.0)


def test_reverb_smears_transients():
    fs = 44100
    x = np.zeros(fs, np.int16)
    x[fs // 2] = 20000
    y = tchannel.simulate_channel(x, fs=fs, rng=11).astype(np.float64)
    peak_at = int(np.abs(y).argmax())
    tail = np.abs(y[peak_at + int(0.01 * fs): peak_at + int(0.08 * fs)])
    assert tail.max() > 0.02 * np.abs(y[peak_at])


def test_severity_knob():
    rng = np.random.default_rng(3)
    clip = (rng.normal(0, 6000, 44100 * 2)).astype(np.int16)
    a = tchannel.simulate_channel(clip, rng=5, severity=0.3)
    b = tchannel.simulate_channel(clip, rng=5, severity=0.3)
    np.testing.assert_array_equal(a, b)
    c = tchannel.simulate_channel(clip, rng=5, severity=0.9)
    assert not np.array_equal(a, c)

    def err(sev, seeds=range(8)):
        tot = 0.0
        for s in seeds:
            y = tchannel.simulate_channel(clip, rng=s,
                                          severity=sev).astype(np.float64)
            x = clip.astype(np.float64)
            tot += np.mean((y - x) ** 2) / np.mean(x ** 2)
        return tot

    assert err(0.0) < err(1.0)


def test_recognition_survives_channel(tmp_path):
    """Clips through the channel still mostly recognize on the port."""
    from shazam_tpu_torch.api import SIA
    from shazam_tpu_torch.audio.io import read
    from shazam_tpu_torch.audio.synth import synth_corpus

    files = synth_corpus(str(tmp_path), 3, duration_s=12.0,
                         style="music", seed=5)
    sia = SIA(catalog_path=str(tmp_path / "cat.sqlite"), device="cpu")
    sia.ingest_files([p for p, _ in files])
    hits = 0
    rng = np.random.default_rng(123)
    for path, sid in files:
        ch, fs, _ = read(path)
        clip = tchannel.simulate_channel(ch[0][3 * fs: 8 * fs], fs=fs,
                                         rng=rng)
        r = sia.recognize_samples([clip])
        if r["results"] and r["results"][0]["song_name"] == f"track{sid:06d}":
            hits += 1
    assert hits >= 2, hits
