"""Port parity, end to end: ``shazam_tpu_torch.SIA`` against ``shazam_tpu.SIA``.

A 6-song x 10 s seeded corpus goes into both packages' SIA (the port on
the CPU, i.e. through the kernels' plain twins); 4 s clips cut at
frame-aligned offsets must give the same top-1 song and offset in both,
and the source song. Also the catalog/index life cycle: resume, save and
cross-load, delete, metadata, overflow retries, the sparse branch.
"""

import numpy as np
import pytest
import torch

from shazam_tpu_torch.api import SIA
from shazam_tpu_torch.audio import synth_song

N_SONGS, SONG_S, CLIP_S = 6, 10.0, 4.0
FS, HOP = 44100, 2048


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs files in parallel worker processes: torch's CPU ops
    here use one thread so that the workers do not oversubscribe cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def songs():
    return [(f"song{i}", synth_song(i, SONG_S, seed=100 + i))
            for i in range(N_SONGS)]


@pytest.fixture(scope="module")
def engines(songs):
    from shazam_tpu.api import SIA as JaxSIA

    port = SIA(device="cpu")
    stats = port.ingest_arrays(songs)
    assert stats["ingested"] == N_SONGS and stats["overflowed"] == []
    ref = JaxSIA()
    ref.ingest_arrays(songs)
    return port, ref


def _clip(songs, k):
    rng = np.random.default_rng(k)
    i = int(rng.integers(N_SONGS))
    frame = int(rng.integers(0, int((SONG_S - CLIP_S) * FS) // HOP))
    return i, frame, songs[i][1][frame * HOP: frame * HOP + int(CLIP_S * FS)]


def test_ingest_builds_the_same_index(engines):
    port, ref = engines
    for name in ("key_hi", "key_lo", "key_ex", "song_id", "offset"):
        assert np.array_equal(getattr(port.index, name),
                              getattr(ref.index, name))
    assert port.catalog.counts() == ref.catalog.counts()


@pytest.mark.parametrize("k", range(4))
def test_recognize_clip_agrees_with_jax(engines, songs, k):
    port, ref = engines
    i, frame, clip = _clip(songs, k)
    got = port.recognize_clip(clip)["results"][0]
    want = ref.recognize_clip(clip)["results"][0]
    assert got["song_name"] == want["song_name"] == f"song{i}"
    assert got["offset"] == want["offset"] == frame
    assert got["offset_seconds"] == want["offset_seconds"]
    assert got["hashes_matched_in_input"] == want["hashes_matched_in_input"]
    two = port.recognize_samples([clip])["results"][0]
    assert {k: two[k] for k in got} == got


def test_stereo_union_and_empty_input(engines, songs):
    port, _ = engines
    i, frame, clip = _clip(songs, 7)
    other = songs[(i + 1) % N_SONGS][1][: len(clip)]
    res = port.recognize_samples([clip, (clip // 2).astype(np.int16), other])
    assert res["results"][0]["song_name"] == f"song{i}"
    assert port.recognize_samples([])["results"] == []


def test_resume_skips_known_songs(engines, songs):
    port, _ = engines
    rows = port.index.n_hashes
    stats = port.ingest_arrays(songs[:2])
    assert stats["skipped"] == 2 and stats["ingested"] == 0
    assert port.index.n_hashes == rows


def test_save_load_across_packages(songs, tmp_path):
    from shazam_tpu.api import SIA as JaxSIA

    db = str(tmp_path / "catalog.sqlite")
    port = SIA(catalog_path=db, device="cpu")
    port.ingest_arrays(songs[:3])
    port.catalog.insert_metadata(2, track_title="Two", artist_name="A")
    port.save_index(str(tmp_path / "index.npz"))
    frame = 25
    clip = songs[2][1][frame * HOP: frame * HOP + int(CLIP_S * FS)]
    want = port.recognize_clip(clip)["results"][0]
    assert (want["song_name"], want["offset"]) == ("song2", frame)

    ref = JaxSIA(catalog_path=db)
    ref.load_index(str(tmp_path / "index.npz"))
    got = ref.recognize_clip(clip)["results"][0]
    assert (got["song_id"], got["offset"]) == (want["song_id"], want["offset"])
    assert ref.get_metadata(2)["track_title"] == "Two"

    again = SIA(catalog_path=db, device="cpu")
    again.load_index(str(tmp_path / "index.npz"))
    assert again.get_metadata(2)["artist_name"] == "A"
    assert again.recognize_clip(clip)["results"][0] == want


def test_delete_songs(songs):
    port = SIA(device="cpu")
    port.ingest_arrays(songs[:3])
    clip = songs[1][1][40 * HOP: 40 * HOP + int(CLIP_S * FS)]
    sid = port.recognize_clip(clip)["results"][0]["song_id"]
    per_song = port.index.hashes_per_song()[sid]
    assert port.delete_songs([sid]) == per_song > 0
    res = port.recognize_clip(clip)["results"]
    assert all(r["song_id"] != sid for r in res)
    assert port.catalog.counts()["n_songs"] == 2


def test_capacity_overflows_retry_and_stay_exact(songs):
    """Tiny peak and match capacities force every retry path: the ingest
    re-run at twice the peak capacity, recognize_clip's hand-off to
    recognize_samples, its peak-capacity doubling and match-tier
    escalation. Results equal the default-capacity engine's."""
    from shazam_tpu_torch.config import FingerprintConfig

    small = FingerprintConfig(peak_capacity=64, match_capacity_fast=16,
                              match_capacity=64, decision_escalation=False)
    port = SIA(config=small, device="cpu")
    # the two songs hold 455 and 521 peaks: both overflow 300, fit 600
    stats = port.ingest_arrays(songs[:2], song_peak_capacity=300)
    assert stats["fallbacks"] == 2 and stats["overflowed"] == []
    full = SIA(device="cpu")
    full.ingest_arrays(songs[:2])
    frame = 30
    clip = songs[0][1][frame * HOP: frame * HOP + int(CLIP_S * FS)]
    assert np.array_equal(port.index.key_hi, full.index.key_hi)
    got = port.recognize_clip(clip)
    want = full.recognize_clip(clip)
    assert got["results"][0] == want["results"][0]
    assert got["results"][0]["offset"] == frame


def test_query_lane_overflow_hands_off(engines, monkeypatch):
    """White noise yields > 2048 hashes in 5 s: more than recognize_clip's
    query lanes, so the clip is handed on to the continuation, which
    dedups the pass's fingerprint again on the device at 4,096 lanes
    (no ``recognize_samples`` call) and answers as recognize_samples."""
    port, _ = engines
    noise = np.random.default_rng(0).normal(0, 8000, int(5 * FS)).astype(np.float32)
    calls = []
    real = SIA.recognize_samples

    def spy(self, channels, topn=None):
        calls.append(len(channels))
        return real(self, channels, topn=topn)

    monkeypatch.setattr(SIA, "recognize_samples", spy)
    got = port.recognize_clip(noise)
    assert calls == []
    assert got["input_hashes"] > 2048
    assert got == port.recognize_samples([noise]) | {
        k: got[k] for k in got if k.endswith("_time")}


def test_sparse_threshold_answers_like_dense(songs):
    """Past sparse_vote_threshold both recognition paths take the sparse
    ranks and give the dense answer."""
    from shazam_tpu_torch.config import FingerprintConfig

    dense = SIA(device="cpu")
    port = SIA(config=FingerprintConfig(sparse_vote_threshold=100),
               device="cpu")
    for sia in (dense, port):
        sia.ingest_arrays(songs[:3])
    frame = 20
    clip = songs[1][1][frame * HOP: frame * HOP + int(CLIP_S * FS)]
    want = dense.recognize_clip(clip)
    assert want["results"][0]["offset"] == frame
    timing = ("fingerprint_time", "query_time", "align_time", "total_time")
    for got in (port.recognize_clip(clip), port.recognize_samples([clip])):
        assert ({k: v for k, v in got.items() if k not in timing}
                == {k: v for k, v in want.items() if k not in timing})
