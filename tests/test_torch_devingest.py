"""Port parity for on-device ingest (``SIA.ingest_device_batch`` and
shazam_tpu_torch/index/devingest.py) on the CPU.

- ``device_sorted_run`` against the JAX package's on identical
  (hi, lo, ex, t1, valid, sids) columns, exact: the run's rows, its
  length, the per-row song counts and the overflow flag, with runs that
  fit, that exactly fill the capacity and that pass it by one lane.
- The cases of ``tests/test_devingest.py``: the port's device ingest is
  held exactly to the port's host ingest (rows, per-song counts, answers),
  and to the JAX package's device ingest by per-song hash jaccard > 0.98
  and equal top-1 song and offset (the port's K1 computes in float64, the
  JAX package in float32, so their hash sets differ slightly).
"""

import hashlib

import numpy as np
import pytest
import torch

from shazam_tpu_torch.api import SIA
from shazam_tpu_torch.audio import synth_song

COLS = ("key_hi", "key_lo", "key_ex", "song_id", "offset")
DUR = 4.0
BLEN = 1 << 18
FS = 44100


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def songs():
    return [(f"s{i}", synth_song(i, duration_s=DUR, seed=11))
            for i in range(7)]


def _batch(arrs):
    mat = np.zeros((len(arrs), BLEN), np.float32)
    for i, a in enumerate(arrs):
        mat[i, : len(a)] = a
    return mat, [len(a) for a in arrs]


def _dev_ingest(sia, named, **kw):
    mat, nv = _batch([s for _n, s in named])
    return sia.ingest_device_batch([n for n, _s in named],
                                   torch.from_numpy(mat), nv, **kw)


def _assert_rows_equal(a, b):
    assert a.n_hashes == b.n_hashes
    for name in COLS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


def _by_name(sia):
    return {d["song_name"]: d["total_hashes"] for d in sia.catalog.get_songs()}


def _pairs_by_name(sia):
    """{song name: set of (hi, lo, ex, offset)} of a SIA's index."""
    ix = sia.index
    names = {d["song_id"]: d["song_name"] for d in sia.catalog.get_songs()}
    sid = np.asarray(ix.song_id)
    out = {}
    for s, name in names.items():
        m = sid == s
        out[name] = set(zip(*(np.asarray(getattr(ix, c))[m].tolist()
                              for c in ("key_hi", "key_lo", "key_ex", "offset"))))
    return out


def _jaccard_ok(port, jax_sia):
    a, b = _pairs_by_name(port), _pairs_by_name(jax_sia)
    assert a.keys() == b.keys()
    for name in a:
        union = len(a[name] | b[name])
        assert len(a[name] & b[name]) / max(union, 1) > 0.98, name


def _same_top(port, jax_sia, clip, name):
    a = port.recognize_samples([clip])["results"][0]
    b = jax_sia.recognize_samples([clip])["results"][0]
    assert a["song_name"] == b["song_name"] == name
    assert a["offset"] == b["offset"]
    return a


# ---- device_sorted_run against the JAX package's ------------------------------
def _columns(seed, bsz=4, lanes=512):
    """Batch columns with exact duplicates inside rows, and rows 0 and 1
    one song (channels) sharing some lanes."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 8, (bsz, lanes)).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, (bsz, lanes), dtype=np.uint32) % 16
    hi[:, ::7] = rng.integers(0, 1 << 32, (bsz, lanes // 7 + 1), dtype=np.uint32)
    ex = rng.integers(0, 3, (bsz, lanes)).astype(np.uint32)
    t1 = rng.integers(0, 60, (bsz, lanes)).astype(np.uint32)
    hi[1, :100], lo[1, :100], ex[1, :100], t1[1, :100] = \
        hi[0, :100], lo[0, :100], ex[0, :100], t1[0, :100]
    valid = rng.random((bsz, lanes)) < 0.7
    valid[2, 300:] = False
    sids = np.array([5, 5, 9, 2], np.uint32)[:bsz]
    return hi, lo, ex, t1, valid, sids


@pytest.mark.parametrize("case", ["fits", "exact_fill", "one_over"])
def test_device_sorted_run_matches_jax(case):
    import jax.numpy as jnp

    from shazam_tpu.index.devingest import device_sorted_run as jax_run

    from shazam_tpu_torch.index.devingest import device_sorted_run

    hi, lo, ex, t1, valid, sids = _columns(3)
    n_lanes = int(valid.sum())
    cap = {"fits": 4096, "exact_fill": n_lanes, "one_over": n_lanes - 1}[case]
    stride = 64
    want_cols, want_n, want_counts, want_over = jax_run(
        *(jnp.asarray(a) for a in (hi, lo, ex, t1, valid, sids)),
        stride=stride, addition_cap=cap)
    (k64, e, p), n_run, counts, over = device_sorted_run(
        *(torch.from_numpy(a.astype(np.int64)) for a in (hi, lo, ex, t1)),
        torch.from_numpy(valid), torch.from_numpy(sids.astype(np.int64)),
        stride=stride, addition_cap=cap)
    assert bool(over) == bool(want_over) == (case == "one_over")
    assert len(k64) == min(cap, valid.size)
    if case == "one_over":
        return   # the run is incomplete: the caller must not merge it
    n = int(want_n)
    assert int(n_run) == n
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    key = k64[:n].numpy().view(np.uint64) ^ np.uint64(1 << 63)
    got = [key >> np.uint64(32), key & np.uint64(0xFFFFFFFF),
           e[:n].numpy(), p[:n].numpy()]
    for g, w in zip(got, want_cols):
        np.testing.assert_array_equal(g.astype(np.int64),
                                      np.asarray(w[:n]).astype(np.int64))
    # past n_run: sentinel rows only
    assert bool((k64[n:] == torch.iinfo(torch.int64).max).all())


# ---- tests/test_devingest.py's cases ----------------------------------------
@pytest.fixture(scope="module")
def host5(songs):
    host = SIA(device="cpu")
    host.ingest_arrays(songs[:5])
    return host


@pytest.fixture(scope="module")
def jax5(songs):
    import jax.numpy as jnp

    from shazam_tpu.api import SIA as JaxSIA

    jax_sia = JaxSIA(device_resident=True)
    mat, nv = _batch([s for _n, s in songs[:5]])
    stats = jax_sia.ingest_device_batch([n for n, _s in songs[:5]],
                                        jnp.asarray(mat), nv)
    assert stats["ingested"] == 5
    return jax_sia


def test_device_ingest_matches_host_ingest(songs, host5, jax5):
    dev = SIA(device="cpu", device_resident=True)
    stats = _dev_ingest(dev, songs[:5])
    assert stats["ingested"] == 5 and stats["overflowed"] == []
    assert stats["merges"] == 1 and "fallbacks" not in stats
    _assert_rows_equal(host5.index, dev.index)
    assert _by_name(host5) == _by_name(dev)
    _jaccard_ok(dev, jax5)

    clip = songs[2][1][22050: 22050 + 2 * FS]
    top = _same_top(dev, jax5, clip, "s2")
    want = host5.recognize_samples([clip])["results"][0]
    assert top["hashes_matched_in_input"] == want["hashes_matched_in_input"]
    assert dev.recognize_clip(clip)["results"][0]["song_name"] == "s2"


def test_device_ingest_channel_union(songs):
    """Two rows with one name are the channels of one song: identical
    channels dedup to the one-channel set; two different channels give
    the host ingest_channels union."""
    s0, s1 = songs[0][1], songs[1][1]
    single = SIA(device="cpu", device_resident=True)
    _dev_ingest(single, [("dup", s0)])
    double = SIA(device="cpu", device_resident=True)
    stats = _dev_ingest(double, [("dup", s0), ("dup", s0)])
    assert stats["ingested"] == 1 and stats["files"] == 1
    _assert_rows_equal(single.index, double.index)
    assert _by_name(single) == _by_name(double)

    stereo = SIA(device="cpu", device_resident=True)
    _dev_ingest(stereo, [("st", s0), ("st", s1)])
    host = SIA(device="cpu")
    host.ingest_channels("st", [s0, s1])
    _assert_rows_equal(host.index, stereo.index)
    assert _by_name(host) == _by_name(stereo)


def test_device_ingest_resume_and_incremental(songs, host5):
    sia = SIA(device="cpu", device_resident=True)
    first = _dev_ingest(sia, songs[:4])
    again = _dev_ingest(sia, songs[:4])
    assert again["skipped"] == 4 and again["ingested"] == 0
    assert again["merges"] == 0
    # the resume key is the SHA-1 of the name
    assert {d["song_name"]: d["file_sha1"] for d in sia.catalog.get_songs()} \
        == {n: hashlib.sha1(n.encode()).hexdigest().upper()
            for n, _s in songs[:4]}
    second = _dev_ingest(sia, songs[4:7])   # merges into the same store
    assert second["ingested"] == 3
    assert sia._live_n_hashes() == first["hashes"] + second["hashes"]
    ref = SIA(device="cpu")
    ref.ingest_arrays(songs[:7])
    _assert_rows_equal(ref.index, sia.index)


def _peaks(songs):
    from shazam_tpu_torch.ops.fingerprint import fingerprint

    return [int(fingerprint(s, device="cpu", peak_capacity=1 << 14).n_peaks)
            for _n, s in songs]


def test_device_ingest_overflow_retry(songs):
    """A capacity that one song passes and the other does not: the first
    run masks the over row, the 2x retry (cycle-padded to the batch) takes
    it, and the rows equal the host ingest, which retries that row alone
    at 2x. Both packages' peak counts put the same rows over."""
    from shazam_tpu.ops.fingerprint import fingerprint as jax_fingerprint

    pair = songs[:2]
    peaks = _peaks(pair)
    jax_peaks = [int(jax_fingerprint(s).n_peaks) for _n, s in pair]
    cap = (min(peaks) + max(peaks)) // 2
    assert min(peaks) < cap < max(peaks) <= 2 * cap
    assert [p > cap for p in jax_peaks] == [p > cap for p in peaks]
    over = [n for (n, _s), p in zip(pair, peaks) if p > cap]

    dev = SIA(device="cpu", device_resident=True)
    stats = _dev_ingest(dev, pair, song_peak_capacity=cap)
    assert stats["fallbacks"] == 1 and stats["merges"] == 2
    assert stats["overflowed"] == [] and stats["ingested"] == 2
    host = SIA(device="cpu")
    hstats = host.ingest_arrays(pair, song_peak_capacity=cap)
    assert hstats["fallbacks"] == 1 and hstats["overflowed"] == []
    _assert_rows_equal(host.index, dev.index)
    assert _by_name(host) == _by_name(dev)
    assert len(over) == 1

    # group_cap >= 12: no retry, the row is dropped and reported
    drop = SIA(device="cpu", device_resident=True)
    stats = _dev_ingest(drop, pair, song_peak_capacity=cap, group_cap=12)
    assert stats["fallbacks"] == 1 and stats["merges"] == 1
    assert stats["overflowed"] == over and stats["ingested"] == 1
    assert set(_by_name(drop)) == {n for n, _s in pair} - set(over)


def test_device_ingest_overflow_drops_and_reports(songs):
    """Still over at 2x: nothing of those rows is merged, the songs stay
    unfingerprinted, and a sufficient capacity then ingests them."""
    pair = songs[:2]
    sia = SIA(device="cpu", device_resident=True)
    stats = _dev_ingest(sia, pair, song_peak_capacity=64)
    assert stats["fallbacks"] == 2 and stats["merges"] == 2
    assert set(stats["overflowed"]) == {"s0", "s1"}
    assert stats["ingested"] == 0 and sia._live_n_hashes() == 0
    assert sia.catalog.get_songs() == []
    stats = _dev_ingest(sia, pair, song_peak_capacity=4096)
    assert stats["ingested"] == 2 and stats["overflowed"] == []


def _tied_noise(seed: int) -> np.ndarray:
    """4 s of noise that repeats every hop: every frame is the same, so
    every frequency-local maximum ties along time and is a peak (about
    7,700 peaks, 30,000 hashes)."""
    period = np.random.default_rng(seed).normal(0, 8000.0, 2048)
    return np.clip(np.tile(period, int(DUR * FS) // 2048), -32768,
                   32767).astype(np.int16)


def test_device_ingest_run_overflow_raises(songs):
    """An addition run past its capacity (the least, 2^16 rows, here:
    three dense rows hold more valid lanes) raises before anything is
    merged, and leaves the songs unfingerprinted."""
    sia = SIA(device="cpu", device_resident=True)
    sia.ingest_arrays(songs[:1])
    rows = sia._live_n_hashes()
    dense = [(f"noise{i}", _tied_noise(i)) for i in range(3)]
    with pytest.raises(ValueError, match="overflowed"):
        _dev_ingest(sia, dense, per_song_hash_capacity=8)
    assert sia._live_n_hashes() == rows
    assert [d["song_name"] for d in sia.catalog.get_songs()] == ["s0"]


def test_device_ingest_refusals():
    with pytest.raises(ValueError, match="device_resident"):
        SIA(device="cpu").ingest_device_batch(
            ["x"], torch.zeros(1, 8), [8])
    sia = SIA(device="cpu", device_resident=True)
    with pytest.raises(ValueError, match="tensor on"):
        sia.ingest_device_batch(["x"], np.zeros((1, 8), np.float32), [8])
    # past JAX's packed payload (n_songs * stride > 2^32): refused too
    from shazam_tpu_torch.index.store import FingerprintIndex

    z = np.zeros(0, np.uint32)
    big = SIA(device="cpu", device_resident=True,
              index=FingerprintIndex(z, z, z, z, z, n_songs=1 << 26,
                                     max_offset=100))
    with pytest.raises(ValueError, match="packed payload"):
        big.ingest_device_batch(["x"], torch.zeros(1, BLEN), [FS])


def test_defer_sort_matches_scatter_merge(songs):
    """append_run + one finalize gives the rows of per-batch merges."""
    a = SIA(device="cpu", device_resident=True)
    b = SIA(device="cpu", device_resident=True, device_reserve_hashes=1 << 17)
    for base in (0, 3):
        chunk = songs[base: base + 3]
        _dev_ingest(a, chunk)
        _dev_ingest(b, chunk, defer_sort=True)
    assert b._dev_store._unsorted and b._dev_store.capacity == 1 << 17
    _assert_rows_equal(a.index, b.index)       # .index finalizes b
    assert not b._dev_store._unsorted
    clip = songs[4][1][22050: 22050 + 2 * FS]
    assert b.recognize_samples([clip])["results"][0]["song_name"] == "s4"
