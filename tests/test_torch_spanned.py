"""Port parity for spans: ``SIA(device_span_rows=...)``, the span-wise file
format and fsck's spanned branch, on the CPU.

Mirrors of the ``tests/test_spanned.py`` cases that go through ``SIA``'s
API run the same songs through both packages: rows and answers must be
equal, and what JAX's spanned store refuses (ingest into a consolidated
or stacked store, a device run longer than ``span_rows``) the port's
refuses with the same message. Span-wise files cross between the
packages both ways. The store and matchers themselves are held to JAX's
in ``tests/test_torch_spanned_store.py``.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from shazam_tpu_torch.api import SIA
from shazam_tpu_torch.audio import synth_song
from shazam_tpu_torch.config import FingerprintConfig
from shazam_tpu_torch.index.devmerge import is_spanned_file
from shazam_tpu_torch.tools.fsck import check_integrity

COLS = ("key_hi", "key_lo", "key_ex", "song_id", "offset")
SPAN = 4096


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _songs(n, secs=3.0):
    return [(f"s{i}", synth_song(i, duration_s=secs, seed=11))
            for i in range(n)]


def _clip(songs, i, start=11025, secs=2.0):
    return songs[i][1][start: start + int(secs * 44100)]


def _index_equal(a, b):
    for c in COLS:
        assert np.array_equal(np.asarray(getattr(a, c)),
                              np.asarray(getattr(b, c))), c
    assert a.n_songs == b.n_songs


def _answer(res):
    top = res["results"][0] if res["results"] else {}
    return (top.get("song_name"), top.get("offset"),
            top.get("hashes_matched_in_input"), res["total_matches"],
            res["input_hashes"])


def _port(**kw):
    return SIA(device="cpu", **kw)


def _jax(**kw):
    from shazam_tpu.api import SIA as JaxSIA
    from shazam_tpu.config import FingerprintConfig as JaxConfig

    if "config" in kw:
        kw["config"] = JaxConfig(**dataclasses.asdict(kw["config"]))
    return JaxSIA(**kw)


def _batches(songs, size=2, blen=1 << 18):
    """(names, (B, blen) float32 samples, n_valid) per batch of songs."""
    for i in range(0, len(songs), size):
        chunk = songs[i:i + size]
        mat = np.zeros((len(chunk), blen), np.float32)
        for r, (_n, s) in enumerate(chunk):
            mat[r, : len(s)] = s
        yield [n for n, _s in chunk], mat, [len(s) for _n, s in chunk]


def _device_ingest(sia, songs, jax_side=False, blen=1 << 18, **kw):
    kw = {"per_song_hash_capacity": 4096, "defer_sort": True, **kw}
    for names, mat, nv in _batches(songs, blen=blen):
        if jax_side:
            import jax.numpy as jnp

            st = sia.ingest_device_batch(names, jnp.asarray(mat), nv, **kw)
        else:
            st = sia.ingest_device_batch(names, torch.from_numpy(mat), nv,
                                         **kw)
        assert st["overflowed"] == []


# ---- SIA API mirrors of tests/test_spanned.py --------------------------------
def test_spanned_device_ingest_matches_single():
    """``test_spanned.py:114``: device ingest into a spanned SIA equals a
    resident SIA's and JAX's spanned SIA's rows, and answers alike through
    recognize_samples, recognize_clip and recognize_batch."""
    songs = _songs(6)
    single = _port(device_resident=True)
    spanned = _port(device_span_rows=SPAN)
    ref = _jax(device_span_rows=SPAN)
    for sia in (single, spanned):
        _device_ingest(sia, songs)
    _device_ingest(ref, songs, jax_side=True)
    assert len(ref._dev_store.spans) >= 2        # JAX rolled its spans
    _index_equal(single.index, spanned.index)
    _index_equal(spanned.index, ref.index)

    clip = _clip(songs, 3)
    want = _answer(ref.recognize_samples([clip]))
    assert want[0] == "s3"
    assert _answer(spanned.recognize_samples([clip])) == want
    assert _answer(single.recognize_samples([clip])) == want
    assert _answer(spanned.recognize_clip(clip))[:3] == want[:3]
    outs = spanned.recognize_batch([clip, songs[1][1][:44100]])
    refs = ref.recognize_batch([clip, songs[1][1][:44100]])
    assert [_answer(r) for r in outs] == [_answer(r) for r in refs]


def test_spanned_host_ingest_and_from_host():
    """``test_spanned.py:160``: host ingest into a spanned SIA, and a host
    index preloaded into one, against a host-backed SIA and JAX's."""
    songs = _songs(10)
    host = _port()
    host.ingest_arrays(songs)
    spanned = _port(device_span_rows=SPAN)
    spanned.ingest_arrays(songs)
    ref = _jax(device_span_rows=SPAN)
    ref.ingest_arrays(songs)
    _index_equal(host.index, spanned.index)
    _index_equal(spanned.index, ref.index)

    pre = _port(index=host.index, device_span_rows=SPAN)
    pre.catalog = host.catalog
    assert pre._ensure_dev_store().n_valid == host.index.n_hashes
    clip = _clip(songs, 2, start=22050)
    want = _answer(ref.recognize_samples([clip]))
    assert want[0] == "s2"
    assert _answer(pre.recognize_samples([clip])) == want
    assert _answer(host.recognize_samples([clip])) == want


def test_consolidate_changes_nothing_and_ingest_stays_open():
    """``test_spanned.py:242``: consolidation stacks the store and keeps
    every answer; ingest after it raises JAX's message in both packages,
    and the answers stand."""
    songs = _songs(6)
    sia = _port(device_span_rows=SPAN)
    ref = _jax(device_span_rows=SPAN)
    _device_ingest(sia, songs[:4])
    _device_ingest(ref, songs[:4], jax_side=True)
    clip = _clip(songs, 2)
    before = _answer(sia.recognize_samples([clip]))
    host_before = sia.index
    sia.consolidate_index()
    ref.consolidate_index()
    assert sia._dev_store.is_stacked and ref._dev_store.is_stacked
    assert _answer(sia.recognize_samples([clip])) == before \
        == _answer(ref.recognize_samples([clip]))
    assert _answer(sia.recognize_clip(clip))[:3] == before[:3]
    _index_equal(host_before, sia.index)

    fresh = [n for n in songs[4:]]
    errors = []
    for s_, jax_side in ((ref, True), (sia, False)):
        with pytest.raises(ValueError, match="consolidated") as e:
            _device_ingest(s_, fresh, jax_side=jax_side)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert _answer(sia.recognize_samples([clip])) == before


def test_spanned_lifecycle_delete_save_reload(tmp_path):
    """``test_spanned.py:291``: delete, save span-wise, reload into a fresh
    spanned SIA: the deleted song is gone, in both packages alike."""
    songs = _songs(6)
    out = {}
    for name, make in (("port", _port), ("jax", _jax)):
        sia = make(device_span_rows=SPAN)
        assert sia.device_resident
        sia.ingest_arrays(songs)
        n0 = sia.index.n_hashes
        sid3 = next(r["song_id"] for r in sia.catalog.get_songs()
                    if r["song_name"] == "s3")
        removed = sia.delete_songs([sid3])
        assert 0 < removed < n0 and sia.index.n_hashes == n0 - removed
        path = str(tmp_path / f"{name}.npz")
        sia.save_index(path)
        fresh = make(device_span_rows=SPAN)
        fresh.catalog = sia.catalog
        fresh.load_index(path)
        out[name] = (fresh.index, removed,
                     _answer(fresh.recognize_samples([_clip(songs, 1)])),
                     _answer(fresh.recognize_samples([_clip(songs, 3)])))
    _index_equal(out["port"][0], out["jax"][0])
    assert out["port"][1:] == out["jax"][1:]
    assert out["port"][2][0] == "s1" and out["port"][3][0] != "s3"


def test_spanned_save_load_api_roundtrip(tmp_path):
    """``test_spanned.py:375``: save_index on a spanned SIA writes the
    span-wise format; load_index restores it into spanned and flat SIAs,
    still growable and queryable."""
    songs = _songs(5)
    sia = _port(device_span_rows=SPAN)
    sia.ingest_arrays(songs[:4])
    flat_before = sia.index
    path = str(tmp_path / "ix.npz")
    sia.save_index(path)
    assert is_spanned_file(path)
    with np.load(path) as z:
        meta = z["spanned_meta"]
        assert meta.dtype == np.int64 and int(meta[0]) == SPAN
        sizes = [len(z[f"s{i:05d}_hi"]) for i in range(len(z.files) // 4)]
        assert all(z[k].dtype == np.uint32 for k in z.files
                   if k != "spanned_meta")
    assert sum(sizes) == flat_before.n_hashes
    assert sizes[:-1] == [SPAN] * (len(sizes) - 1) and sizes[-1] <= SPAN

    fresh = _port(device_span_rows=SPAN)
    fresh.catalog = sia.catalog
    fresh.load_index(path)
    assert fresh._dev_store is not None and fresh._host_stale
    _index_equal(fresh.index, flat_before)
    clip = _clip(songs, 2)
    assert fresh.recognize_samples([clip])["results"][0]["song_name"] == "s2"
    fresh.ingest_arrays(songs[4:])
    clip4 = _clip(songs, 4)
    assert fresh.recognize_samples([clip4])["results"][0]["song_name"] == "s4"

    flat_sia = _port()
    flat_sia.catalog = sia.catalog
    flat_sia.load_index(path)
    _index_equal(flat_sia.index, flat_before)
    assert flat_sia.recognize_samples([clip])["results"][0]["song_name"] == "s2"


def test_empty_spanned_save_load(tmp_path):
    """``test_spanned.py:435``: an empty spanned store round-trips (no span
    entries in the file) between the packages and stays open to ingest."""
    from shazam_tpu.index.devmerge import SpannedDeviceStore

    sia = _port(device_span_rows=SPAN)
    sia._ensure_dev_store()
    path = str(tmp_path / "empty.npz")
    sia.save_index(path)
    with np.load(path) as z:
        assert z.files == ["spanned_meta"]
    back = SpannedDeviceStore.load(path)
    assert back.n_valid == 0 and back.to_host().n_hashes == 0
    assert SpannedDeviceStore.load_flat(path).n_hashes == 0

    jax_path = str(tmp_path / "jax_empty.npz")
    SpannedDeviceStore(span_rows=SPAN).save(jax_path)
    fresh = _port(device_span_rows=SPAN)
    fresh.load_index(jax_path)
    assert fresh._dev_store.n_valid == 0 and fresh.index.n_hashes == 0
    songs = _songs(1)
    fresh.ingest_arrays(songs)
    assert _answer(fresh.recognize_samples([_clip(songs, 0)]))[0] == "s0"


def test_stacked_load_api_end_to_end(tmp_path):
    """``test_spanned.py:537``: load_index(stacked=True) gives the stacked
    store and the same answers; both packages' stacked stores refuse
    ingest."""
    songs = _songs(5)
    sia = _port(device_span_rows=SPAN)
    sia.ingest_arrays(songs)
    path = str(tmp_path / "ix.npz")
    sia.save_index(path)
    clip = _clip(songs, 2)
    before = sia.recognize_samples([clip])
    assert before["results"][0]["song_name"] == "s2"

    fresh = _port(device_span_rows=SPAN)
    fresh.catalog = sia.catalog
    fresh.load_index(path, stacked=True)
    assert fresh._dev_store.is_stacked
    after = fresh.recognize_samples([clip])
    assert after["results"] == before["results"]
    _index_equal(fresh.index, sia.index)

    ref = _jax(device_span_rows=SPAN)
    ref.catalog = sia.catalog
    ref.load_index(path, stacked=True)
    assert ref._dev_store.is_stacked
    assert _answer(ref.recognize_samples([clip])) == _answer(after)
    new_audio = np.concatenate([songs[0][1], songs[1][1]])
    for s_ in (ref, fresh):
        with pytest.raises(ValueError, match="consolidated"):
            s_.ingest_arrays([("s9", new_audio)])
    assert fresh._dev_store.n_valid == sia.index.n_hashes


def test_spanned_torn_delete_reconciles_on_load(tmp_path):
    """``test_spanned.py:615``: a delete after the snapshot leaves the file
    holding the song's rows; the spanned load sees the catalog total
    differ from the store's rows and drops them."""
    songs = _songs(5)
    cat = str(tmp_path / "cat.sqlite")
    sia = _port(device_span_rows=SPAN, catalog_path=cat)
    sia.ingest_arrays(songs)
    path = str(tmp_path / "ix.npz")
    sia.save_index(path)
    sid2 = next(r["song_id"] for r in sia.catalog.get_songs()
                if r["song_name"] == "s2")
    n2 = sia.catalog.song_hashes_by_id()[sid2]
    sia.delete_songs([sid2])
    sia.catalog.close()

    fresh = _port(device_span_rows=SPAN, catalog_path=cat)
    fresh.load_index(path)
    assert fresh.index.n_hashes == sia.index.n_hashes
    assert not np.isin(fresh.index.song_id, [sid2]).any()
    out = fresh.recognize_samples([_clip(songs, 2)])
    assert all(r["song_id"] != sid2 for r in out["results"])
    assert fresh.recognize_samples(
        [_clip(songs, 1)])["results"][0]["song_name"] == "s1"
    assert n2 > 0


def test_untorn_spanned_load_skips_the_reconcile(tmp_path, monkeypatch):
    """The reconcile is gated on the catalog's hash total: a file that
    agrees with the catalog goes onto the store with no host sync."""
    songs = _songs(3)
    sia = _port(device_span_rows=SPAN)
    sia.ingest_arrays(songs)
    path = str(tmp_path / "ix.npz")
    sia.save_index(path)
    fresh = _port(device_span_rows=SPAN)
    fresh.catalog = sia.catalog
    monkeypatch.setattr(SIA, "_reconcile_catalog",
                        lambda self: pytest.fail("reconciled"))
    fresh.load_index(path)
    assert fresh._host_stale and fresh._dev_store.n_valid == \
        sia.index.n_hashes


def _build_spanned(cfg, songs):
    sia = _port(device_span_rows=SPAN, config=cfg)
    _device_ingest(sia, songs)
    sia.consolidate_index()
    return sia


def test_spanned_bounds_first_and_blocked_match_default():
    """``test_spanned.py:824``: on a spanned SIA counted as big, the
    big-index policy (decided-first, where the JAX package's test runs
    bounds-first) and the blocked expansion answer as the default path."""
    songs = _songs(6)
    base = _build_spanned(FingerprintConfig(), songs)
    probed = _build_spanned(FingerprintConfig(bounds_probe_min_rows=1,
                                              expand_block_min_capacity=0),
                            songs)
    clip = _clip(songs, 3, start=22050)
    for fn, arg in (("recognize_samples", [clip]), ("recognize_clip", clip)):
        a, b = getattr(base, fn)(arg), getattr(probed, fn)(arg)
        assert _answer(a)[:4] == _answer(b)[:4], fn
        assert _answer(a)[0] == "s3", fn
    ab = base.recognize_batch([clip, songs[0][1][:44100]])
    bb = probed.recognize_batch([clip, songs[0][1][:44100]])
    assert [_answer(x)[:4] for x in ab] == [_answer(x)[:4] for x in bb]


def test_spanned_decide_first_policy_matches_bounds():
    """``test_spanned.py:865``: decided-first, with and without an
    accepted clamp (the port's path in place of bounds-first), agrees with
    JAX's decided-first and bounds-first on the top-1 song and offset on a
    spanned SIA."""
    cfg = FingerprintConfig(match_capacity=1024, match_capacity_fast=256,
                            match_capacity_max=1 << 16,
                            bounds_probe_min_rows=1, sparse_vote_threshold=0)
    songs = _songs(6)
    sia = _build_spanned(cfg, songs)
    ref = _jax(device_span_rows=SPAN, config=cfg)
    _device_ingest(ref, songs, jax_side=True)
    for sid in (2, 5):
        clip = _clip(songs, sid, secs=3.0)
        a = sia.recognize_samples([clip], topn=2)
        sia.config = dataclasses.replace(cfg, decision_escalation=False)
        b = sia.recognize_samples([clip], topn=2)
        sia.config = cfg
        r = ref.recognize_samples([clip], topn=2)
        ref.config = dataclasses.replace(ref.config,
                                         escalation_policy="bounds")
        rb = ref.recognize_samples([clip], topn=2)
        ref.config = dataclasses.replace(ref.config,
                                         escalation_policy="auto")
        assert a["results"][0]["song_name"] == f"s{sid}"
        for key in ("song_name", "offset"):
            assert a["results"][0][key] == b["results"][0][key] \
                == r["results"][0][key] == rb["results"][0][key]


# ---- span-wise files across the packages --------------------------------------
def test_port_spanwise_file_loads_in_jax(tmp_path):
    """The port's span-wise file loads into JAX's SIA(device_span_rows=4096),
    per span and stacked, and answers the same clips the same way."""
    songs = _songs(10)
    sia = _port(device_span_rows=SPAN)
    sia.ingest_arrays(songs)
    path = str(tmp_path / "port.npz")
    sia.save_index(path)
    clips = [_clip(songs, i) for i in (0, 3, 5)]
    want = [_answer(sia.recognize_samples([c])) for c in clips]
    for stacked in (False, True):
        ref = _jax(device_span_rows=SPAN)
        ref.catalog = sia.catalog
        ref.load_index(path, stacked=stacked)
        assert ref._dev_store.is_stacked == stacked
        assert len(ref._dev_store._stacked_valids if stacked
                   else ref._dev_store.spans) >= 2
        assert [_answer(ref.recognize_samples([c])) for c in clips] == want
        _index_equal(ref.index, sia.index)
    flat = _jax()                     # a plain JAX SIA flattens it
    flat.catalog = sia.catalog
    flat.load_index(path)
    assert [_answer(flat.recognize_samples([c])) for c in clips] == want


def test_jax_spanwise_file_loads_onto_the_port_store(tmp_path):
    """A JAX spanned SIA's file (spans that overlap in key range) goes
    straight onto the port's store, rows equal, and answers alike."""
    songs = _songs(6)
    ref = _jax(device_span_rows=SPAN)
    _device_ingest(ref, songs, jax_side=True)
    assert len(ref._dev_store.spans) >= 2
    path = str(tmp_path / "jax.npz")
    ref.save_index(path)
    sia = _port(device_span_rows=SPAN)
    sia.catalog = ref.catalog
    sia.load_index(path)
    store = sia._dev_store
    assert store is not None and not store._unsorted
    _index_equal(sia.index, ref.index)
    clip = _clip(songs, 4)
    assert _answer(sia.recognize_samples([clip])) == \
        _answer(ref.recognize_samples([clip]))


# ---- refusals and the deliberate differences ------------------------------------
def test_span_rows_below_the_minimum_is_refused_on_first_device_use():
    songs = _songs(1)
    for make in (_port, _jax):
        sia = make(device_span_rows=100)       # constructing is fine
        with pytest.raises(ValueError, match="span_rows 100 is below"):
            sia.ingest_arrays(songs)


def test_unpackable_catalog_is_refused():
    """A catalog whose (song, offset) payload passes 32 bits cannot be
    spanned, in either package (the span-wise file packs it in uint32)."""
    from shazam_tpu.index.store import FingerprintIndex as JaxIndex

    from shazam_tpu_torch.index.store import FingerprintIndex

    cols = [np.array([1], np.uint32), np.array([2], np.uint32),
            np.array([3], np.uint32), np.array([1 << 20], np.uint32),
            np.array([5000], np.uint32)]
    port = _port(index=FingerprintIndex(*cols, n_songs=(1 << 20) + 1,
                                        max_offset=5000),
                 device_span_rows=SPAN)
    with pytest.raises(ValueError, match="packed"):
        port._ensure_dev_store()
    ref = _jax(index=JaxIndex(*cols, n_songs=(1 << 20) + 1, max_offset=5000),
               device_span_rows=SPAN)
    with pytest.raises(ValueError, match="packed"):
        ref._ensure_dev_store()


def test_run_longer_than_span_rows_is_accepted():
    """A device run of more than span_rows rows is refused by both
    packages, with JAX's message, and the store keeps no row of it; a
    resident SIA's flat store takes the same run."""
    songs = _songs(2, secs=12.0)
    kw = dict(per_song_hash_capacity=8192, blen=3 << 18)
    errors = []
    for make, jax_side in ((_jax, True), (_port, False)):
        sia = make(device_span_rows=SPAN)
        with pytest.raises(ValueError, match="exceeds span_rows") as e:
            _device_ingest(sia, songs, jax_side=jax_side, **kw)
        assert sia._dev_store.n_valid == 0
        errors.append(str(e.value).split("(")[0])
    assert errors[0] == errors[1]
    single = _port(device_resident=True)
    _device_ingest(single, songs, **kw)
    assert single._dev_store.n_valid > SPAN


def test_early_exit_on_a_spanned_sia_warns_and_runs_the_full_match():
    """Both packages warn with the same text and run the full match."""
    songs = _songs(3)
    clip = _clip(songs, 1)
    got = {}
    for name, make in (("port", _port), ("jax", _jax)):
        sia = make(device_span_rows=SPAN)
        sia.ingest_arrays(songs)
        full = sia.recognize_samples([clip])
        with pytest.warns(UserWarning,
                          match="unavailable for spanned stores") as w:
            out = sia.recognize_samples([clip], early_exit=True)
        assert _answer(out) == _answer(full)
        got[name] = ([str(m.message) for m in w], _answer(out))
    assert got["port"] == got["jax"]


# ---- fsck's spanned branch ------------------------------------------------------
@pytest.fixture
def spanned_sia():
    sia = _port(device_span_rows=SPAN)
    sia.ingest_arrays(_songs(10))
    return sia


def test_healthy_spanned_store_passes(spanned_sia):
    """``tests/test_fsck.py::test_healthy_spanned_store_passes``, with the
    span count of the live rows."""
    from shazam_tpu.tools.fsck import check_integrity as jax_check

    report = check_integrity(spanned_sia)
    assert report["ok"], report
    checks = report["checks"]
    assert checks["store"] == "SpannedDeviceStore"
    assert checks["index_hashes"] == checks["catalog_hashes"]
    assert checks["spans_checked"] == -(-checks["index_hashes"] // SPAN) >= 2
    ref = _jax(device_resident=True, device_span_rows=1 << 16)
    ref.ingest_arrays(_songs(10))
    want = jax_check(ref)
    assert want["ok"] and want["checks"]["store"] == checks["store"]
    assert want["checks"]["index_hashes"] == checks["index_hashes"]


def test_spanned_corruptions_give_jax_errors(spanned_sia):
    store = spanned_sia._dev_store
    span = store.spans[0]
    span.cols[0][[0, 1]] = span.cols[0][[1, 0]].clone()
    span.cols[2][5] = store.n_songs * store.stride + 1
    sid, n = min(spanned_sia.catalog.song_hashes_by_id().items())
    spanned_sia.catalog.update_song_hashes(sid, n + 2)
    report = check_integrity(spanned_sia)
    assert not report["ok"]
    for msg in ("device span key columns are not sorted",
                "packed payload max", "catalog records"):
        assert any(msg in e for e in report["errors"]), (msg, report)


def test_spanned_pending_appends_warn(spanned_sia):
    store = spanned_sia._dev_store
    span = store.active
    n = span.n_valid
    tail = tuple(c[n - 300: n].flip(0).clone() for c in span.cols)
    span.n_valid = span._sorted_rows = n - 300
    span.append_run(tail, 300, store.n_songs, store.max_offset)
    report = check_integrity(spanned_sia)
    assert report["ok"], report
    assert "1 span(s) hold deferred-sort appends" in report["warnings"][0]
    live = sum(s.n_valid > 0 for s in store.spans)
    assert report["checks"]["spans_checked"] == live - 1 >= 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        spanned_sia.index   # finalizes without complaint
    assert check_integrity(spanned_sia)["warnings"] == []
