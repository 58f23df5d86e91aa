"""Port parity for the music-like song generators.

``synth_music_song`` and ``synth_corpus(style=...)`` are numpy copies of
the JAX package's: equal sample for sample and file for file. The device
generator ``make_music_gen`` cannot draw the JAX package's threefry
stream, so it is held to the JAX generator's shape contract, to
determinism per (seed, id) whatever the batch, and to the JAX generator's
hash density: over the same 8 ids, both fingerprinted by the port's plain
pipeline, the mean unique-hash count agrees within 25 %. The property
cases of ``tests/test_music_synth.py`` run through the port.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from shazam_tpu.audio import synth as jsynth
from shazam_tpu_torch.audio import synth as tsynth
from shazam_tpu_torch.audio.synth_device import BLOCK, make_music_gen

ROOT = Path(__file__).resolve().parents[1]
DENSITY_IDS = list(range(8))
GEN_S = 20.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs files in parallel worker processes: torch's CPU ops
    here use one thread so that the workers do not oversubscribe cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gen():
    return make_music_gen(GEN_S, device="cpu")


@pytest.fixture(scope="module")
def rendered(gen):
    return gen(DENSITY_IDS).numpy()


def _unique_hashes(samples) -> int:
    from shazam_tpu_torch.ops.fingerprint import (fingerprint,
                                                  fingerprints_to_pairs)

    return len(fingerprints_to_pairs(fingerprint(
        np.array(samples, np.float32), device="cpu"))[0])


@pytest.mark.parametrize("sid", (0, 3, 11))
def test_synth_music_song_sample_equal(sid):
    a = tsynth.synth_music_song(sid, duration_s=20.0, seed=5)
    b = jsynth.synth_music_song(sid, duration_s=20.0, seed=5)
    assert a.dtype == b.dtype == np.int16 and np.array_equal(a, b)


@pytest.mark.parametrize("style", ("tones", "music"))
def test_synth_corpus_files_byte_equal(tmp_path, style):
    t = tsynth.synth_corpus(str(tmp_path / "t"), 2, duration_s=2.0,
                            style=style, seed=9)
    j = jsynth.synth_corpus(str(tmp_path / "j"), 2, duration_s=2.0,
                            style=style, seed=9)
    assert [i for _, i in t] == [i for _, i in j] == [0, 1]
    for (pt, _), (pj, _) in zip(t, j):
        assert pt.endswith(pj[-len("track000000.wav"):])
        with open(pt, "rb") as a, open(pj, "rb") as b:
            assert a.read() == b.read()
    with pytest.raises(ValueError):
        tsynth.synth_corpus(str(tmp_path), 1, style="bogus")


def test_audio_package_exports_the_jax_names():
    import shazam_tpu.audio as ja
    import shazam_tpu_torch.audio as ta

    assert ta.__all__ == ja.__all__
    assert all(callable(getattr(ta, name)) for name in ta.__all__)


# tests/test_music_synth.py's property cases, through the port

def test_deterministic_and_distinct():
    a = tsynth.synth_music_song(3, duration_s=4.0)
    b = tsynth.synth_music_song(3, duration_s=4.0)
    c = tsynth.synth_music_song(4, duration_s=4.0)
    assert a.dtype == np.int16
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert len(tsynth.synth_music_song(3, duration_s=8.0)) == 8 * 44100


def test_level_controls_amplitude():
    quiet = tsynth.synth_music_song(1, duration_s=3.0, level=0.1)
    loud = tsynth.synth_music_song(1, duration_s=3.0, level=0.4)
    assert np.max(np.abs(loud)) > 3.0 * np.max(np.abs(quiet))
    assert np.max(np.abs(loud)) <= 0.45 * 32767


def _argmax_stability(x):
    x = x.astype(np.float64)
    w, hop = 4096, 2048
    frames = np.lib.stride_tricks.sliding_window_view(x, w)[::hop][:200]
    spec = np.abs(np.fft.rfft(frames * np.hanning(w), axis=1)) ** 2
    return float(np.mean(np.abs(np.diff(spec.argmax(1))) <= 1))


def test_sustained_ridges_dominate():
    sm = _argmax_stability(tsynth.synth_music_song(0, duration_s=10.0))
    st = _argmax_stability(tsynth.synth_song(0, duration_s=10.0))
    assert sm > 0.68, (sm, st)
    assert sm > st + 0.08, (sm, st)


def test_fingerprint_density_short():
    from tests.oracle.oracle import oracle_fingerprint

    a = tsynth.synth_music_song(0, duration_s=20.0)
    n_def = len(oracle_fingerprint(a.astype(np.float64), fs=44100))
    a_loud = tsynth.synth_music_song(0, duration_s=20.0, level=0.8)
    n_loud = len(oracle_fingerprint(a_loud.astype(np.float64), fs=44100))
    assert 300 < n_def < 3500, n_def
    assert n_loud > 1.5 * n_def, (n_loud, n_def)


def test_music_corpus_recognition(tmp_path):
    from shazam_tpu_torch.api import SIA
    from shazam_tpu_torch.audio.io import read

    files = tsynth.synth_corpus(str(tmp_path), 3, duration_s=12.0,
                                style="music", seed=5)
    sia = SIA(catalog_path=str(tmp_path / "cat.sqlite"), device="cpu")
    sia.ingest_files([p for p, _ in files])
    hits = 0
    for path, sid in files:
        ch, fs, _ = read(path)
        r = sia.recognize_samples([ch[0][3 * fs: 8 * fs]])
        if r["results"] and r["results"][0]["song_name"] == f"track{sid:06d}":
            hits += 1
    assert hits >= 2, hits


# the device generator

def test_make_music_gen_shape_contract(gen, rendered):
    n_samp = int(GEN_S * 44100)
    n_gen = (n_samp // BLOCK + 1) * BLOCK
    assert gen.n_samp == n_samp
    assert gen.blen == -(-n_gen // (1 << 18)) * (1 << 18) and gen.blen >= n_gen
    assert rendered.shape == (len(DENSITY_IDS), gen.blen)
    assert rendered.dtype == np.float32
    assert not rendered[:, n_samp:].any()
    assert np.array_equal(rendered, np.round(rendered))
    assert rendered.min() >= -32768 and rendered.max() <= 32767
    peaks = np.abs(rendered).max(axis=1)
    assert (peaks <= round(0.15 * 32767)).all() and (peaks > 0).all()
    loud = make_music_gen(2.0, level=0.5, device="cpu")([0]).numpy()
    assert np.abs(loud).max() <= round(0.5 * 32767)


def test_make_music_gen_matches_jax_contract(gen):
    from shazam_tpu.audio.synth_device import make_music_gen as jgen

    for seconds in (GEN_S, 2.0, 210.0):
        j = jgen(seconds)
        t = make_music_gen(seconds, device="cpu")
        assert (t.n_samp, t.blen) == (j.n_samp, j.blen)


def test_make_music_gen_deterministic_distinct_batch_free(gen, rendered):
    again = gen([5, 2, 9]).numpy()
    assert np.array_equal(again[1], rendered[2])
    assert np.array_equal(gen([2]).numpy()[0], rendered[2])
    for i in range(len(DENSITY_IDS) - 1):
        assert not np.array_equal(rendered[i], rendered[i + 1])
    other_seed = make_music_gen(GEN_S, seed=78, device="cpu")([2]).numpy()
    assert not np.array_equal(other_seed[0], rendered[2])


def test_make_music_gen_hash_density_matches_jax(gen, rendered):
    """The mean unique-hash count over 8 ids is within 25 % of the JAX
    generator's on the same ids (both through the port's plain
    pipeline)."""
    from shazam_tpu.audio.synth_device import make_music_gen as jgen

    j = jgen(GEN_S)
    jax_rows = np.asarray(j(np.asarray(DENSITY_IDS, np.int32)))
    ours = np.mean([_unique_hashes(r[: gen.n_samp]) for r in rendered])
    theirs = np.mean([_unique_hashes(r[: j.n_samp]) for r in jax_rows])
    assert abs(ours / theirs - 1.0) <= 0.25, (ours, theirs)


def test_make_music_gen_catalog_recognizes_clips(gen, rendered):
    """4 rendered songs ingested from the tensor (``ingest_device_batch``,
    as chip_smoke's phase 10 does): a 5 s clip of each is recognized at
    its offset."""
    from shazam_tpu_torch.api import SIA

    sia = SIA(device_resident=True, device="cpu")
    st = sia.ingest_device_batch([f"track{i:06d}" for i in range(4)],
                                 torch.from_numpy(rendered[:4]),
                                 [gen.n_samp] * 4)
    assert st["ingested"] == 4 and not st["overflowed"]
    for i in range(4):
        start = (3 + 2 * i) * 44100
        clip = rendered[i, start: start + 5 * 44100].astype(np.int16)
        top = sia.recognize_samples([clip])["results"][0]
        assert top["song_name"] == f"track{i:06d}"
        assert abs(top["offset_seconds"] - start / 44100) < 0.1


def test_offsets_are_where_the_votes_peak_as_in_jax(gen, rendered,
                                                    monkeypatch):
    """On this music a clip's own start may gather few votes, and the
    reference's recognizer then answers the right song at another offset:
    here clips of song 3 at every whole second, through the JAX
    recognizer and the port's on the same one-song catalog. Both give the
    same (song, offset) for every clip, one of them away from its start,
    and each offset is where chip_smoke's ``delta_votes`` (a count of
    matching (hash, frame) pairs apart from the match path) peaks, with no
    fewer votes than the start's. A delta off the peak fails that check."""
    from shazam_tpu.api import SIA as JSIA
    from shazam_tpu_torch.api import SIA

    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    song = rendered[3, : gen.n_samp].astype(np.int16)
    jsia, tsia = JSIA(), SIA(device="cpu")
    for sia in (jsia, tsia):
        sia.ingest_arrays([("track000003", song)])
    song_fp = tsia._fingerprint_channel(song)
    fs, hop = 44100, 2048
    away, off_peak = 0, 0
    starts = range(int(GEN_S) - 5)
    for start in starts:
        clip = song[start * fs: (start + 5) * fs]
        j = jsia.recognize_samples([clip])["results"][0]
        t = tsia.recognize_samples([clip])["results"][0]
        assert (t["song_name"], t["offset"]) == (j["song_name"], j["offset"])
        assert t["song_name"] == "track000003"
        votes = chip_smoke.delta_votes(tsia._fingerprint_channel(clip),
                                       song_fp)
        peak = max(votes.values())
        assert votes[t["offset"]] == peak
        assert max(votes.get(start * fs // hop + k, 0) for k in (0, 1)) <= peak
        away += abs(t["offset_seconds"] - start) >= 0.1
        off_peak += votes.get(t["offset"] + 40, 0) < peak
    assert away >= 1
    assert off_peak == len(starts)
