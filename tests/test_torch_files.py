"""Port parity for file, channel and resampled ingest and ``recognize_file``.

The copied host modules (``audio/io``, ``audio/resample``, ``audio/mp3``,
``index/store.merge_indices``) must return what the JAX package's return
on the same inputs. Then one seeded WAV corpus of 10 x 8 s songs in four
formats (44.1 kHz mono int16, stereo int16 with the right channel at 0.7x
the left, mono int16 at 48 kHz, mono IEEE float32) goes through both
packages' ``ingest_files``: the index columns and the catalog are equal.
Every format decodes to int16 in both packages (float WAVs are scaled by
32768 and clipped), so even the float32 files give equal hash sets, not
only sets within the jaccard > 0.98 gate. The JAX scenarios of
``tests/test_streaming_ingest.py``, ``tests/test_resample.py`` and
``tests/test_review_fixes.py`` are mirrored on the port.
"""

import os

import numpy as np
import pytest
import torch

from shazam_tpu_torch.api import SIA
from shazam_tpu_torch.audio import io as tio
from shazam_tpu_torch.audio import synth_song
from shazam_tpu_torch.audio.resample import resample_channel
from tests.test_audio_io import X, _encode, _wav_raw

FS = 44100
N_SONGS, SONG_S = 10, 8.0
# file i's format: 44.1 kHz mono int16 unless listed
FORMATS = {1: "stereo", 2: "48k", 3: "float", 6: "stereo", 7: "48k",
           8: "float"}
INDEX_COLS = ("key_hi", "key_lo", "key_ex", "song_id", "offset")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs files in parallel worker processes: torch's CPU ops
    here use one thread so that the workers do not oversubscribe cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _song(i):
    return synth_song(i, SONG_S, seed=21)


def _write(path, song, fmt):
    if fmt == "stereo":
        tio.write_wav(path, np.stack([song, (song * 0.7).astype(song.dtype)]),
                      FS)
    elif fmt == "48k":
        tio.write_wav(path, resample_channel(song, FS, 48000), 48000)
    elif fmt == "float":
        tio.write_float_wav(path, song, FS)
    else:
        tio.write_wav(path, song, FS)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_files")
    files = []
    for i in range(N_SONGS):
        path = str(d / f"track{i:06d}.wav")
        _write(path, _song(i), FORMATS.get(i, "mono"))
        files.append(path)
    return files


@pytest.fixture(scope="module")
def engines(corpus):
    from shazam_tpu.api import SIA as JaxSIA

    port = SIA(device="cpu")
    stats = port.ingest_files(corpus, batch_size=4, merge_chunk_hashes=5000)
    ref = JaxSIA()
    ref_stats = ref.ingest_files(corpus, batch_size=4,
                                 merge_chunk_hashes=5000)
    return port, ref, stats, ref_stats


def _songs(sia):
    return [{k: d[k] for k in ("song_id", "song_name", "file_sha1",
                               "total_hashes")}
            for d in sia.catalog.get_songs()]


def _top(res):
    top = res["results"][0]
    return top["song_name"], top["offset"]


# --------------------------------------------------------------------- #
# the copied host modules
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("width", ["u8", "i16", "i24", "i32", "f32"])
@pytest.mark.parametrize("n_ch", [1, 2])
def test_read_and_probe_match_jax(tmp_path, width, n_ch):
    from shazam_tpu.audio import io as jio

    sig = X if n_ch == 1 else np.stack([X, -X], 1).reshape(-1)
    payload, sw, tag = _encode(sig, width)
    p = str(tmp_path / f"{width}_{n_ch}.wav")
    _wav_raw(p, payload, 22050, n_ch, sw, tag)
    assert tio.probe(p) == jio.probe(p) == (n_ch, 22050, len(X))
    got, want = tio.read(p), jio.read(p)
    assert got[1:] == want[1:]
    assert len(got[0]) == len(want[0]) == n_ch
    for a, b in zip(got[0], want[0]):
        assert a.dtype == b.dtype == np.int16 and np.array_equal(a, b)
    blob = open(p, "rb").read()
    for a, b in zip(tio.read_wav_bytes(blob, 1e-3)[0],
                    jio.read_wav_bytes(blob, 1e-3)[0]):
        assert np.array_equal(a, b)


def test_corpus_reads_match_jax(corpus):
    from shazam_tpu.audio import io as jio

    for path in corpus:
        assert tio.probe(path) == jio.probe(path)
        got, want = tio.read(path, limit=5.0), jio.read(path, limit=5.0)
        assert got[1:] == want[1:]
        assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
    assert tio.probe(corpus[0] + ".mp3") is None


def test_find_files_and_hash_match_jax(tmp_path):
    from shazam_tpu.audio import io as jio

    for name in ("a.wav", "TRACK01.WAV", "b.Wave", "c.Mp3", "d.txt",
                 "sub/e.wav", "noext"):
        (tmp_path / name).parent.mkdir(exist_ok=True)
        (tmp_path / name).write_bytes(name.encode())
    for exts in ([".wav"], ["wav", ".WAVE"], [".mp3", ".wav"]):
        got = sorted(tio.find_files(str(tmp_path), exts))
        assert got == sorted(jio.find_files(str(tmp_path), exts))
    assert os.path.join(str(tmp_path), "TRACK01.WAV") in [
        p for p, _ in tio.find_files(str(tmp_path), [".wav"])]
    p = str(tmp_path / "c.Mp3")
    assert tio.unique_file_hash(p) == jio.unique_file_hash(p)


def test_write_wav_matches_jax(tmp_path):
    from shazam_tpu.audio import io as jio

    rng = np.random.default_rng(3)
    for data in (rng.uniform(-1.0, 1.0, (2, 999)),
                 rng.integers(-3000, 3000, 777).astype(np.int16)):
        a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
        tio.write_wav(a, data, 48000)
        jio.write_wav(b, data, 48000)
        assert open(a, "rb").read() == open(b, "rb").read()
    song = _song(0)[:5000]
    tio.write_float_wav(a, np.stack([song, -song]), FS)
    ch, fs, _ = jio.read(a)
    assert fs == FS and np.array_equal(ch[0], song)
    assert np.array_equal(ch[1], -song)


@pytest.mark.parametrize("case", ["int16_up", "float_down", "int16_down",
                                  "same"])
def test_resample_matches_jax(case):
    from shazam_tpu.audio.resample import resample_channel as jresample
    from shazam_tpu.audio.resample import resample_channels as jchannels
    from shazam_tpu_torch.audio.resample import resample_channels

    rng = np.random.default_rng(1)
    x, fs, target = {
        "int16_up": (rng.integers(-20000, 20000, 22050, dtype=np.int16),
                     22050, 44100),
        "float_down": (rng.uniform(-1, 1, 48000).astype(np.float32),
                       48000, 44100),
        "int16_down": (_song(4)[:96000], 48000, 44100),
        "same": (np.arange(1000, dtype=np.int16), 44100, 44100),
    }[case]
    got, want = resample_channel(x, fs, target), jresample(x, fs, target)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if case == "same":
        assert got is x
    for a, b in zip(resample_channels([x, x[::-1]], fs, target),
                    jchannels([x, x[::-1]], fs, target)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        resample_channel(x, 0, target)


def test_merge_indices_matches_jax():
    from shazam_tpu.index import store as jstore
    from shazam_tpu_torch.index import store

    rng = np.random.default_rng(5)
    runs = []
    for n_songs in (4, 6, 3):
        entries = []
        for sid in range(n_songs):
            n = int(rng.integers(50, 200))
            # few distinct keys: runs of equal (hi, lo) across indices
            entries.append((sid, rng.integers(0, 30, n, dtype=np.uint32),
                            rng.integers(0, 3, n, dtype=np.uint32),
                            rng.integers(0, 4, n, dtype=np.uint32),
                            rng.integers(0, 900, n, dtype=np.uint32)))
        runs.append(entries)
    got = store.merge_indices([store.build_index(e) for e in runs])
    want = jstore.merge_indices([jstore.build_index(e) for e in runs])
    assert (got.n_songs, got.max_offset) == (want.n_songs, want.max_offset)
    for name in INDEX_COLS:
        assert np.array_equal(getattr(got, name), getattr(want, name))
    two = store.merge_into(store.build_index(runs[0]),
                           store.build_index(runs[1]))
    for name in INDEX_COLS:
        assert np.array_equal(
            getattr(two, name),
            getattr(store.merge_indices([store.build_index(runs[0]),
                                         store.build_index(runs[1])]), name))
    empty = store.merge_indices([store.build_index([])])
    assert empty.n_hashes == 0 and empty.n_songs == 0


def test_mp3_matches_jax(tmp_path, monkeypatch):
    """libmpg123 loads in both or neither; a stream it rejects raises in
    both when no ffmpeg can sniff it; the reference's MP3 fixture, where
    present, decodes to the same channels."""
    from shazam_tpu.audio import io as jio
    from shazam_tpu.audio import mp3 as jmp3
    from shazam_tpu_torch.audio import mp3
    from tests.test_real_fixture import MP3_FIXTURE

    assert mp3.available() == jmp3.available()
    if not mp3.available():
        pytest.skip("libmpg123 not present")
    bad = tmp_path / "noise.mp3"
    bad.write_bytes(b"\x00" * 64)
    monkeypatch.setattr(tio, "_FFMPEG", None)
    monkeypatch.setattr(jio, "_FFMPEG", None)
    for mod in (tio, jio):
        with pytest.raises(Exception):
            mod.read(str(bad))
    if not os.path.exists(MP3_FIXTURE):
        pytest.skip("the reference's MP3 fixture is not present")
    got, want = tio.read(MP3_FIXTURE, 3.0), jio.read(MP3_FIXTURE, 3.0)
    assert got[1:] == want[1:]
    assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))


# --------------------------------------------------------------------- #
# ingest_files against the JAX package
# --------------------------------------------------------------------- #
def test_ingest_files_builds_the_jax_index(engines):
    port, ref, stats, ref_stats = engines
    for name in INDEX_COLS:
        assert np.array_equal(getattr(port.index, name),
                              getattr(ref.index, name)), name
    assert (port.index.n_songs, port.index.max_offset) == (
        ref.index.n_songs, ref.index.max_offset)
    assert _songs(port) == _songs(ref)
    keys = ("files", "skipped", "ingested", "hashes", "overflowed", "merges",
            "peak_pending_channels")
    assert {k: stats[k] for k in keys} == {k: ref_stats[k] for k in keys}
    assert stats["ingested"] == N_SONGS and stats["overflowed"] == []


def test_streaming_ingest_matches_oneshot(corpus):
    """Mirrors test_streaming_ingest.py:71 on the port: chunked merges,
    bounded pending channels, and the index of ingest_arrays."""
    files = [f for i, f in enumerate(corpus) if i not in FORMATS]
    sia = SIA(device="cpu")
    stats = sia.ingest_files(files, batch_size=2, merge_chunk_hashes=3000)
    assert stats["ingested"] == len(files) and not stats["overflowed"]
    assert stats["merges"] >= 2
    assert stats["peak_pending_channels"] <= 2 * 2
    one = SIA(device="cpu")
    one.ingest_arrays([(f, tio.read(f)[0][0]) for f in files])
    for name in INDEX_COLS:
        assert np.array_equal(getattr(sia.index, name),
                              getattr(one.index, name)), name
    assert [d["song_name"] for d in sia.catalog.get_songs()] == [
        d["song_name"] for d in one.catalog.get_songs()]


def test_ingest_directory_resume(corpus):
    """Mirrors test_streaming_ingest.py:113: SHA-1 resume."""
    sia = SIA(device="cpu")
    first = sia.ingest_files(corpus[:4], batch_size=4)
    assert first["ingested"] == 4
    again = sia.ingest_directory(os.path.dirname(corpus[0]), batch_size=4)
    assert again["skipped"] == 4 and again["ingested"] == N_SONGS - 4
    assert again["files"] == N_SONGS
    last = sia.ingest_directory(os.path.dirname(corpus[0]), batch_size=4)
    assert last["skipped"] == N_SONGS and last["ingested"] == 0
    assert last["merges"] == 0


def test_streaming_ingest_stereo(tmp_path):
    """Mirrors test_streaming_ingest.py:126: a stereo WAV is one song, its
    channels set-unioned."""
    song = _song(1)
    path = str(tmp_path / "stereo.wav")
    _write(path, song, "stereo")
    sia = SIA(device="cpu")
    stats = sia.ingest_files([path], batch_size=4)
    assert stats["ingested"] == 1 and stats["hashes"] > 100
    out = sia.recognize_samples([song[FS: FS * 6]])
    assert out["results"][0]["song_name"] == "stereo"


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_recognize_file_agrees_with_jax(engines, corpus, tmp_path, i):
    """A 5 s clip written in file i's format: the port's top-1 song and
    offset are the JAX package's, and the source's."""
    port, ref, _, _ = engines
    start = (i + 1) * 11 * 2048
    clip = _song(i)[start: start + 5 * FS]
    path = str(tmp_path / "clip.wav")
    _write(path, clip, FORMATS.get(i, "mono"))
    got, want = port.recognize_file(path), ref.recognize_file(path)
    assert _top(got) == _top(want)
    assert got["results"][0]["song_name"] == f"track{i:06d}"
    assert abs(got["results"][0]["offset_seconds"] - start / FS) < 0.3
    assert got["input_hashes"] == want["input_hashes"]


def test_ingest_cross_rate_corpus(engines):
    """Mirrors test_resample.py:84: a 44.1 kHz clip of a song ingested
    from a 48 kHz file."""
    port, _, _, _ = engines
    clip = _song(7)[FS: 6 * FS]
    assert port.recognize_samples([clip])["results"][0]["song_name"] == \
        "track000007"


def test_resample_disabled_rejects(tmp_path):
    """Mirrors test_resample.py:72 and :102."""
    sia = SIA(device="cpu", resample=False)
    assert sia.resample is False and SIA(device="cpu").resample is True
    p = str(tmp_path / "c.wav")
    tio.write_wav(p, np.zeros(48000, np.float32), 48000)
    with pytest.raises(ValueError, match="sample rate"):
        sia.recognize_file(p)
    with pytest.raises(ValueError, match="sample rate"):
        sia.ingest_files([p])


def test_ingest_channels(tmp_path):
    """ingest_channels equals the JAX package's on the same channels, skips
    a repeat, refuses no audio, and mirrors test_review_fixes.py:192: an
    unsaved online ingest is purged at load and re-ingests cleanly."""
    from shazam_tpu.api import SIA as JaxSIA

    song_a = _song(0).astype(np.float32)
    song_b = _song(1)
    chans = [song_b, (song_b * 0.7).astype(np.int16)]
    port, ref = SIA(device="cpu"), JaxSIA()
    assert port.ingest_channels("b.wav", chans)["ingested"] == 1
    ref.ingest_channels("b.wav", chans)
    for name in INDEX_COLS:
        assert np.array_equal(getattr(port.index, name),
                              getattr(ref.index, name)), name
    assert _songs(port) == _songs(ref)
    assert port.ingest_channels("b", chans)["skipped"] == 1
    with pytest.raises(ValueError):
        port.ingest_channels("e", [np.zeros(0, np.int16)])

    db = str(tmp_path / "cat")
    sia = SIA(catalog_path=db + ".sqlite", device="cpu")
    sia.ingest_arrays([("a", song_a)])
    sia.save_index(db + ".npz")
    sia.ingest_channels("b", [song_b])
    assert {d["song_name"] for d in sia.catalog.get_songs()} == {"a", "b"}
    sia2 = SIA(catalog_path=db + ".sqlite", device="cpu")
    sia2.load_index(db + ".npz")
    assert {d["song_name"] for d in sia2.catalog.get_songs()} == {"a"}
    assert sia2.ingest_channels("b", [song_b])["ingested"] == 1
    out = sia2.recognize_samples([song_b[: 4 * FS]])
    assert out["results"][0]["song_name"] == "b"
