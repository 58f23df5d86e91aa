"""Port parity for the device-resident store (shazam_tpu_torch/index/devmerge.py)
on the CPU.

- The JAX package's span-wise index file (``SpannedDeviceStore.save``)
  loads in the port: ``SIA.load_index`` flattens it on the host, row for
  row what JAX's ``SpannedDeviceStore.load_flat`` gives.
- The six cases of ``tests/test_devmerge.py`` (merge against the host
  merge, key collisions, growth from empty, stride repack, a catalog too
  large for JAX's packed payload, the SIA end to end), each run through
  the port's ``DeviceIndex`` and JAX's on the same numpy rows: both equal
  the host ``merge_into`` chain.
- ``query_cols()`` (the matchers' search view) equals
  ``FingerprintIndex.device_arrays`` of the same rows after merges and
  deferred-sort appends, and a query right after a merge sees the merge.
"""

import numpy as np
import pytest
import torch

from shazam_tpu_torch.index.store import FingerprintIndex, merge_into

COLS = ("key_hi", "key_lo", "key_ex", "song_id", "offset")
DUR = 4.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_rows(rng, n, n_songs, max_offset, key_space=None):
    """n random rows, sorted, as numpy uint32 columns."""
    if key_space is None:
        hi = rng.integers(0, 1 << 32, n, dtype=np.uint32)
        lo = rng.integers(0, 1 << 32, n, dtype=np.uint32)
        ex = rng.integers(0, 1 << 16, n, dtype=np.uint32)
    else:   # a tiny key space: many exact collisions across runs
        hi = rng.integers(0, key_space, n, dtype=np.uint32)
        lo = rng.integers(0, key_space, n, dtype=np.uint32)
        ex = rng.integers(0, 3, n, dtype=np.uint32)
    sid = rng.integers(0, max(n_songs, 1), n, dtype=np.uint32)
    off = rng.integers(0, max_offset + 1, n, dtype=np.uint32)
    order = np.lexsort((off, sid, ex, lo, hi))
    return [a[order] for a in (hi, lo, ex, sid, off)], n_songs


def _port(rows):
    cols, n_songs = rows
    return FingerprintIndex(*cols, n_songs=n_songs,
                            max_offset=int(cols[4].max()) if len(cols[4]) else 0)


def _jax(rows):
    from shazam_tpu.index.store import FingerprintIndex as JaxIndex

    cols, n_songs = rows
    return JaxIndex(*cols, n_songs=n_songs,
                    max_offset=int(cols[4].max()) if len(cols[4]) else 0)


def _assert_same(a, b):
    for name in COLS:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)),
                                      err_msg=name)
    assert a.n_songs == b.n_songs and a.max_offset == b.max_offset


def _store():
    """The port's store class (imported per test, so that the span-wise
    load test also runs, and fails with the old KeyError, on a tree that
    lacks the module)."""
    from shazam_tpu_torch.index.devmerge import DeviceIndex

    return DeviceIndex


def _run_merges(base, adds):
    """The port's store, JAX's DeviceIndex and the host merge_into chain
    over the same rows; returns (port store, its to_host, JAX's, host's)."""
    from shazam_tpu.index.devmerge import DeviceIndex as JaxDeviceIndex

    store = _store().from_host(_port(base))
    jax_store = JaxDeviceIndex.from_host(_jax(base))
    host = _port(base)
    for add in adds:
        store.merge(_port(add))
        jax_store.merge(_jax(add))
        host = merge_into(host, _port(add))
        assert store.n_valid == host.n_hashes == jax_store.n_valid
        assert not store._unsorted
    return store, store.to_host(), jax_store.to_host(), host


def _assert_three(port_rows, jax_rows, host):
    _assert_same(port_rows, host)
    _assert_same(jax_rows, host)


def _assert_view_equal(view, host: FingerprintIndex):
    """A search view (``query_cols()``) equals device_arrays of the same
    rows over n_rows."""
    want = host.device_arrays("cpu")
    n = want.n_rows
    assert view.n_rows == n and view.stride == want.stride
    for name in ("key64", "key_sub", "payload"):
        assert torch.equal(getattr(view, name)[:n], getattr(want, name)[:n]), name
    # the tail is sentinel rows: no real key equals them
    assert bool((view.key64[n:] == torch.iinfo(torch.int64).max).all())
    assert bool((view.key_sub[n:] == torch.iinfo(torch.int64).max).all())


# ---- the JAX package's span-wise file ---------------------------------------
@pytest.fixture(scope="module")
def spanned(tmp_path_factory):
    """A JAX SIA with 4,096-row spans ingests 10 seeded 4 s songs and saves
    span-wise; its catalog is a file the port opens too."""
    from shazam_tpu.api import SIA as JaxSIA
    from shazam_tpu.audio.synth import synth_song

    root = tmp_path_factory.mktemp("spanned")
    songs = [(f"s{i}", synth_song(i, duration_s=DUR, seed=5))
             for i in range(10)]
    sia = JaxSIA(catalog_path=str(root / "db.sqlite"),
                 device_span_rows=1 << 12)
    sia.ingest_arrays(songs, batch_size=8)
    path = str(root / "db.npz")
    sia.save_index(path)
    return {"sia": sia, "path": path, "catalog": str(root / "db.sqlite"),
            "songs": songs}


def test_jax_spanwise_file_loads_flat(spanned):
    """The port's load_index of a span-wise file: the rows of JAX's
    load_flat (the parent tree raised KeyError 'key_hi' here), and the
    same top-1 as JAX for a clip."""
    from shazam_tpu.index.devmerge import SpannedDeviceStore

    from shazam_tpu_torch.api import SIA

    with np.load(spanned["path"]) as z:
        spans = sum(1 for k in z.files if k.endswith("_hi"))
        meta = z["spanned_meta"]
        last = len(z[f"s{spans - 1:05d}_hi"])
    assert spans == 3 and last < meta[0]   # 3 spans, the last not full
    want = SpannedDeviceStore.load_flat(spanned["path"])
    port = SIA(device="cpu", catalog_path=spanned["catalog"])
    port.load_index(spanned["path"])
    _assert_same(port.index, want)
    assert port.catalog.counts()["n_songs"] == len(spanned["songs"])

    clip = spanned["songs"][7][1][30000: 30000 + int(2.5 * 44100)]
    got, ref = port.recognize_samples([clip]), \
        spanned["sia"].recognize_samples([clip])
    top, ref_top = got["results"][0], ref["results"][0]
    assert top["song_name"] == ref_top["song_name"] == "s7"
    assert top["offset"] == ref_top["offset"]


# ---- tests/test_devmerge.py's cases, port and JAX on the same rows -----------
def test_device_merge_matches_host_packed():
    rng = np.random.default_rng(0)
    base = _random_rows(rng, 5000, 40, 3000)
    adds = [_random_rows(rng, 700 + 37 * k, 40, 3000) for k in range(4)]
    store, got, jax_rows, host = _run_merges(base, adds)
    _assert_three(got, jax_rows, host)
    _assert_view_equal(store.query_cols(), host)


def test_device_merge_with_key_collisions():
    """Cross-run equal keys, down to equal full rows, exercise the
    (ex, payload) search inside a key's run."""
    rng = np.random.default_rng(1)
    base = _random_rows(rng, 800, 6, 50, key_space=4)
    adds = [_random_rows(rng, 300, 6, 50, key_space=4) for _ in range(3)]
    store, got, jax_rows, host = _run_merges(base, adds)
    _assert_three(got, jax_rows, host)
    _assert_view_equal(store.query_cols(), host)


def test_capacity_growth_and_empty_start():
    rng = np.random.default_rng(2)
    base = _random_rows(rng, 0, 0, 0)
    adds = [_random_rows(rng, 40_000, 10, 1000) for _ in range(3)]
    store, got, jax_rows, host = _run_merges(base, adds)
    assert store.capacity == 1 << 17 > 1 << 16
    _assert_three(got, jax_rows, host)


def test_stride_repack_on_max_offset_growth():
    rng = np.random.default_rng(3)
    base = _random_rows(rng, 3000, 8, 1000)
    adds = [_random_rows(rng, 1500, 8, 50_000)]
    store0 = _store().from_host(_port(base))
    store, got, jax_rows, host = _run_merges(base, adds)
    assert store.stride > store0.stride
    _assert_three(got, jax_rows, host)
    _assert_view_equal(store.query_cols(), host)


def test_huge_catalog_int64_payload_against_jax_unpacked():
    """2M songs x stride 4096 passes 2^32: JAX switches to its unpacked
    5-column layout, the port's int64 payload just grows; rows equal."""
    rng = np.random.default_rng(4)
    base = _random_rows(rng, 2000, 100, 4000)
    adds = [_random_rows(rng, 1000, 2_000_000, 4000) for _ in range(2)]
    store, got, jax_rows, host = _run_merges(base, adds)
    assert store.n_songs * store.stride > 1 << 32
    _assert_three(got, jax_rows, host)
    _assert_view_equal(store.query_cols(), host)


def test_sia_device_resident_end_to_end():
    """ingest + recognize with device_resident=True equals the host-backed
    port SIA and the JAX device-resident SIA."""
    from shazam_tpu.api import SIA as JaxSIA
    from shazam_tpu.audio.synth import synth_song

    from shazam_tpu_torch.api import SIA

    songs = [(f"s{i}", synth_song(i, duration_s=DUR)) for i in range(6)]
    ref = SIA(device="cpu")
    ref.ingest_arrays(songs, batch_size=4)
    dut = SIA(device="cpu", device_resident=True)
    dut.ingest_arrays(songs[:3], batch_size=4)   # two merges into the store
    dut.ingest_arrays(songs[3:], batch_size=4)
    assert dut._dev_store is not None and dut._host_stale
    assert dut._live_n_hashes() == ref.index.n_hashes
    jax_sia = JaxSIA(device_resident=True)
    jax_sia.ingest_arrays(songs[:3], batch_size=4)
    jax_sia.ingest_arrays(songs[3:], batch_size=4)

    clip = np.asarray(songs[2][1])[: 2 * 44100]
    out_ref, out_dut = ref.recognize_samples([clip]), dut.recognize_samples([clip])
    out_jax = jax_sia.recognize_samples([clip])
    assert out_dut["results"][0]["song_name"] == "s2"
    assert out_jax["results"][0]["song_name"] == "s2"
    assert out_dut["results"][0]["offset"] == out_jax["results"][0]["offset"]
    assert (out_dut["results"][0]["hashes_matched_in_input"]
            == out_ref["results"][0]["hashes_matched_in_input"])
    assert dut.recognize_clip(clip)["results"][0]["song_name"] == "s2"
    _assert_same(dut.index, ref.index)   # the host sync on .index access


# ---- the search view --------------------------------------------------------
def test_query_view_after_appends_and_merges():
    """append_run + finalize give the rows of merges; the view is rebuilt
    after each change (key_sub holds global row positions)."""
    rng = np.random.default_rng(5)
    base = _random_rows(rng, 3000, 20, 2000, key_space=64)
    adds = [_random_rows(rng, 500 + 11 * k, 20, 2000, key_space=64)
            for k in range(4)]
    merged = _store().from_host(_port(base))
    appended = _store().from_host(_port(base))
    host = _port(base)
    from shazam_tpu_torch.index.devmerge import host_cols

    for add in adds:
        ix = _port(add)
        host = merge_into(host, ix)
        merged.merge(ix)
        run = tuple(torch.from_numpy(c) for c in host_cols(ix, appended.stride))
        appended.append_run(run, ix.n_hashes, ix.n_songs, ix.max_offset)
        assert appended._unsorted
        _assert_view_equal(merged.query_cols(), host)
    _assert_view_equal(appended.query_cols(), host)       # finalizes
    assert not appended._unsorted
    _assert_same(appended.to_host(), host)


def test_query_after_merge_sees_the_merge():
    """A stale key_sub would give wrong bounds silently: every addition
    key searched right after the merge finds exactly its rows."""
    from shazam_tpu_torch.index.search import lexi_bounds

    rng = np.random.default_rng(6)
    base = _random_rows(rng, 4000, 10, 500, key_space=200)
    store = _store().from_host(_port(base))
    host = _port(base)
    before = store.query_cols()
    add = _port(_random_rows(rng, 900, 10, 500, key_space=200))
    store.merge(add)
    host = merge_into(host, add)
    view = store.query_cols()
    assert view is not before and view.n_rows == host.n_hashes
    q = [torch.from_numpy(getattr(add, c).astype(np.int64))
         for c in ("key_hi", "key_lo", "key_ex")]
    lb, ub = lexi_bounds(view, *q)
    want = [np.count_nonzero((host.key_hi == h) & (host.key_lo == lo)
                             & (host.key_ex == e))
            for h, lo, e in zip(add.key_hi, add.key_lo, add.key_ex)]
    assert (ub - lb).tolist() == want
    # the view handed out before the merge still holds the base's rows
    _assert_view_equal(before, _port(base))


def test_reserved_capacity_does_not_change_the_match_policy():
    """The big-index escalation policy reads the store's real rows, not
    its reserved capacity: a resident SIA with a large reserve answers
    exactly as the host-backed one (the JAX package reads the capacity)."""
    import dataclasses

    from shazam_tpu.audio.synth import synth_song

    from shazam_tpu_torch.api import SIA
    from shazam_tpu_torch.config import FingerprintConfig
    from shazam_tpu_torch.match import tiers

    cfg = dataclasses.replace(FingerprintConfig(), sparse_vote_threshold=0,
                              bounds_probe_min_rows=1 << 16)
    songs = [(f"s{i}", synth_song(i, duration_s=DUR)) for i in range(3)]
    host = SIA(device="cpu", config=cfg)
    dev = SIA(device="cpu", config=cfg, device_resident=True,
              device_reserve_hashes=1 << 17)
    for sia in (host, dev):
        sia.ingest_arrays(songs)
    view = dev._ensure_device_index()
    assert view.n_rows < 1 << 16 <= view.payload.shape[0]
    assert not tiers.big_index(cfg, view)
    clip = np.asarray(songs[1][1])[20_000: 20_000 + 2 * 44100]
    a, b = (s.recognize_clip(clip) for s in (host, dev))
    assert a["results"] == b["results"] and a["results"][0]["song_name"] == "s1"
    assert a["total_matches"] == b["total_matches"]
