"""The port across threads: the serving daemon reads the catalog from its
batcher, match and handler threads, and fingerprints on two threads at
once (the batcher's batches and the match thread's solo retries).

- ``SongCatalog`` made on one thread answers on another, as the JAX
  package's does (it probes for a serialized SQLite build).
- K3's look-back scratch: the take -> launch -> commit section
  (``LookBackScratch.launch``, what ``compact`` calls) gives every launch a
  distinct ticket range and epoch under 8 threads, and ends at the
  sequential base and epoch.
- ``Kernel.launches`` counts every launch made from many threads.
- A device-resident SIA's store merges on one thread while others take
  its search view: every view is whole (its ``key_sub`` built from its own
  rows) and stays so after later merges, and the rows end equal to the
  host merge chain.
"""

import threading
import time

import pytest


def _on_thread(fn):
    """fn() on a new thread; its result, or the exception it raised."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — handed to the caller
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "error" in out:
        raise out["error"]
    return out["value"]


def _drive(catalog):
    """Insert on the caller's thread, then read and write from another."""
    sid = catalog.insert_song("song", "ab" * 20, 123)
    catalog.set_song_fingerprinted(sid)

    def other():
        catalog.insert_metadata(sid, track_title="title", artist_name="x")
        songs = [(d["song_id"], d["song_name"], d["total_hashes"])
                 for d in catalog.get_songs()]
        return catalog.counts(), songs, catalog.get_metadata(sid)

    return _on_thread(other)


def test_catalog_crosses_threads_like_jax():
    from shazam_tpu.index.catalog import SongCatalog as JaxCatalog

    from shazam_tpu_torch.index.catalog import SongCatalog, _sqlite_serialized

    if not _sqlite_serialized():
        pytest.skip("this SQLite build is not serialized: both packages keep "
                    "the per-thread check")
    got = _drive(SongCatalog(":memory:"))
    assert got == _drive(JaxCatalog(":memory:"))
    assert got[0] == {"n_songs": 1, "n_hashes": 123}
    assert got[2]["track_title"] == "title"


def test_catalog_methods_match_jax(tmp_path):
    """The catalog methods the daemon, fsck, stats and the CLI call give
    the JAX catalog's answers."""
    from shazam_tpu.index.catalog import SongCatalog as JaxCatalog

    from shazam_tpu_torch.index.catalog import SongCatalog

    csv = tmp_path / "meta.csv"
    csv.write_text("track_id,track_title,artist_name,bogus\n"
                   "1,One,A,x\n2,Two,B,y\nnot_an_id,Z,Z,z\n")
    outs = []
    for cls in (SongCatalog, JaxCatalog):
        c = cls(":memory:")
        ids = [c.insert_song(f"s{i}", f"{i:040x}", 10 * (i + 1))
               for i in range(3)]
        for sid in ids[:2]:
            c.set_song_fingerprinted(sid)
        c.update_song_hashes(ids[1], 77)
        outs.append((c.song_hashes_by_id(), c.song_hash_stats(),
                     c.import_metadata_csv(str(csv)), c.get_metadata(2),
                     c.counts()))
    assert outs[0] == outs[1]
    assert outs[0][2] == 2 and outs[0][1][0] == {"song_name": "s1",
                                                 "total_hashes": 77}


def test_lookback_scratch_launches_are_atomic():
    """8 threads x 50 launches through the section ``compact`` uses, with a
    stub launch that yields mid-section: the ticket ranges are disjoint,
    every epoch is distinct, and base and epoch end where 400 sequential
    launches leave them."""
    from shazam_tpu_torch.ops.cuda.compact import LookBackScratch

    s = LookBackScratch("cpu")
    s.launch(5, 0, lambda *a: None)   # words for 5 tiles: no regrowth below
    seen = []
    lock = threading.Lock()

    def stub(n_blocks):
        def launch(words, base, epoch):
            time.sleep(0)          # hand the GIL over inside the section
            with lock:
                seen.append((base, n_blocks, epoch, words.numel()))
        return launch

    def worker(k):
        for i in range(50):
            n_tiles, n_blocks = 1 + (k + i) % 5, 3 + (k * 7 + i) % 11
            s.launch(n_tiles, n_blocks, stub(n_blocks))

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(seen) == 400
    total = sum(n for _b, n, _e, _w in seen)
    assert s.base == total % (1 << 32) and s.epoch == 401
    assert sorted(r[2] for r in seen) == list(range(2, 402))
    # launches run in epoch order, each starting where the last one ended
    at = 0
    for base, n_blocks, _epoch, _words in sorted(seen, key=lambda r: r[2]):
        assert base == at
        at += n_blocks


def test_kernel_launch_counter_across_threads():
    from shazam_tpu_torch._build import Kernel

    k = Kernel("stub", "shz_stub", [])
    k.__dict__["_fn"] = lambda stream: 0     # a launch that succeeds

    def worker():
        for _ in range(2000):
            k(stream=0)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert k.launches == 16000


def test_store_merges_and_search_views_across_threads():
    import numpy as np
    import torch

    from shazam_tpu_torch.api import SIA
    from shazam_tpu_torch.index.devmerge import search_view_key_sub
    from shazam_tpu_torch.index.store import FingerprintIndex, merge_into

    rng = np.random.default_rng(0)

    def run(n):
        cols = [rng.integers(0, 50, n, dtype=np.uint32),
                rng.integers(0, 1 << 32, n, dtype=np.uint32),
                rng.integers(0, 4, n, dtype=np.uint32),
                rng.integers(0, 30, n, dtype=np.uint32),
                rng.integers(0, 900, n, dtype=np.uint32)]
        order = np.lexsort(cols[::-1])
        return FingerprintIndex(*(c[order] for c in cols), n_songs=30,
                                max_offset=int(cols[4].max()))

    sia = SIA(device="cpu", device_resident=True)
    adds = [run(1500 + 10 * k) for k in range(12)]
    sizes = set(np.cumsum([0] + [a.n_hashes for a in adds]).tolist())
    views, errors = [], []

    def merger():
        for add in adds:
            sia._absorb_addition(add)
            time.sleep(0)

    def reader():
        try:
            for _ in range(30):
                views.append(sia._ensure_device_index())
                time.sleep(0)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=merger)] + [
        threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for v in views:
        n = v.n_rows
        assert n in sizes
        ex = v.key_sub[:n] & 0xFFFF
        assert torch.equal(v.key_sub, search_view_key_sub(
            v.key64, ex, n, v.key64.shape[0]))
        assert bool((v.key64[1:n] >= v.key64[:n - 1]).all())
    host = FingerprintIndex(*(np.zeros(0, np.uint32),) * 5, n_songs=0,
                            max_offset=0)
    for add in adds:
        host = merge_into(host, add)
    got = sia.index
    for name in ("key_hi", "key_lo", "key_ex", "song_id", "offset"):
        assert np.array_equal(getattr(got, name), getattr(host, name)), name
