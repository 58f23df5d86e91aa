"""Port parity for the integrity checker (shazam_tpu_torch/tools/fsck.py)
on the CPU — healthy stores pass, every planted corruption class is
detected. Mirrors ``tests/test_fsck.py``'s host cases; its device-store
cases become the port's ``DeviceIndex`` (the uploaded copy), checked
with reductions on its device. The spanned store has no port yet.

Reference parity: the hand-run integrity SQL
(``fingerprints_queries.sql:1-6``, ``songs_queries.sql:1-11``) and the
``DELETE_UNFINGERPRINTED`` startup purge, promoted to one command.
"""

import pytest
import torch

from shazam_tpu_torch.api import SIA
from shazam_tpu_torch.audio import synth_song
from shazam_tpu_torch.tools.fsck import check_integrity

N_SONGS = 4
DUR = 8.0


def _songs():
    return [(f"track{i:06d}", synth_song(i, duration_s=DUR, seed=11))
            for i in range(N_SONGS)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def built():
    sia = SIA(device="cpu")
    stats = sia.ingest_arrays(_songs(), batch_size=4)
    assert stats["ingested"] == N_SONGS
    return sia


def _copy(built):
    """A fresh SIA over a copy of the built catalog and index (each test
    plants its own corruption)."""
    import copy

    sia = SIA(device="cpu")
    sia.catalog.conn.executescript(
        "\n".join(built.catalog.conn.iterdump()).replace(
            "CREATE TABLE", "CREATE TABLE IF NOT EXISTS"))
    sia.index = copy.deepcopy(built.index)
    return sia


@pytest.fixture()
def host_sia(built):
    return _copy(built)


def test_healthy_host_index_passes(host_sia):
    report = check_integrity(host_sia)
    assert report["ok"], report
    assert not report["errors"]
    assert report["checks"]["index_hashes"] == report["checks"]["catalog_hashes"]
    assert report["checks"]["songs_reconciled"] == N_SONGS


def test_unsorted_keys_detected(host_sia):
    ix = host_sia.index
    # swap the first and last rows of the key columns
    for name in ("key_hi", "key_lo", "key_ex"):
        col = getattr(ix, name)
        col[0], col[-1] = col[-1].copy(), col[0].copy()
    report = check_integrity(host_sia, deep=False)
    assert not report["ok"]
    assert any("not sorted" in e for e in report["errors"])


def test_row_count_mismatch_detected(host_sia):
    # catalog claims more hashes than the index holds for song 0
    sid, want = min(host_sia.catalog.song_hashes_by_id().items())
    host_sia.catalog.update_song_hashes(sid, want + 17)
    report = check_integrity(host_sia)
    assert not report["ok"]
    assert any("disagrees with the catalog" in e or "catalog records" in e
               for e in report["errors"])


def test_out_of_range_song_id_detected(host_sia):
    ix = host_sia.index
    ix.song_id[0] = ix.n_songs + 5
    report = check_integrity(host_sia, deep=False)
    assert not report["ok"]
    assert any("song_id max" in e for e in report["errors"])


def test_catalog_warnings(host_sia):
    conn = host_sia.catalog.conn
    # an unfingerprinted leftover + a duplicate SHA-1
    conn.execute(
        "INSERT INTO songs (song_name, file_sha1, fingerprinted)"
        " VALUES ('partial', 'DEAD', 0)")
    sha = conn.execute(
        "SELECT file_sha1 FROM songs WHERE fingerprinted = 1"
        " LIMIT 1").fetchone()[0]
    conn.execute(
        "INSERT INTO songs (song_name, file_sha1, fingerprinted,"
        " total_hashes) VALUES ('dupe', ?, 1, 0)", (sha,))
    conn.commit()
    report = check_integrity(host_sia)
    assert any("unfingerprinted" in w for w in report["warnings"])
    assert any("duplicate file SHA-1" in w for w in report["warnings"])
    assert any("zero recorded hashes" in w for w in report["warnings"])


@pytest.fixture()
def device_sia(built):
    sia = _copy(built)
    sia._ensure_device_index()
    return sia


def test_healthy_device_store_passes(device_sia):
    report = check_integrity(device_sia)
    assert report["ok"], report
    assert report["checks"]["store"] == "DeviceIndex"
    assert report["checks"]["index_hashes"] == report["checks"]["catalog_hashes"]
    assert report["checks"]["device_rows"] == report["checks"]["index_hashes"]


def test_device_unsorted_keys_detected(device_sia):
    dix = device_sia._device_index
    dix.key64[[0, 1]] = dix.key64[[1, 0]].clone()
    dix.key64[0] = dix.key64[1] + 1
    report = check_integrity(device_sia, deep=False)
    assert not report["ok"]
    assert any("device index key columns are not sorted" in e
               for e in report["errors"])


def test_device_payload_and_padding_detected(device_sia):
    dix = device_sia._device_index
    dix.payload[3] = device_sia.index.n_songs * dix.stride + 1
    dix.key_sub[-1] = 0
    report = check_integrity(device_sia, deep=False)
    assert any("device payload max" in e for e in report["errors"])
    assert any("padding rows are not sentinels" in e
               for e in report["errors"])


def test_device_mismatch_vs_catalog_detected(device_sia):
    sid, want = min(device_sia.catalog.song_hashes_by_id().items())
    device_sia.catalog.update_song_hashes(sid, want + 3)
    report = check_integrity(device_sia)
    assert not report["ok"]
    assert any("catalog records" in e for e in report["errors"])


def test_stale_device_copy_detected(device_sia):
    """An upload that no longer matches the host index is an error."""
    ix = device_sia.index
    device_sia._index = type(ix)(
        ix.key_hi[:-5], ix.key_lo[:-5], ix.key_ex[:-5], ix.song_id[:-5],
        ix.offset[:-5], n_songs=ix.n_songs, max_offset=ix.max_offset)
    report = check_integrity(device_sia, deep=False)
    assert any("stale upload" in e for e in report["errors"])


@pytest.fixture()
def resident_sia(built):
    """A device-resident copy whose store holds the built index plus one
    song merged on the device."""
    sia = _copy(built)
    sia.device_resident = True
    sia.ingest_arrays([("extra", synth_song(9, duration_s=DUR, seed=11))])
    assert sia._dev_store is not None
    return sia


def test_healthy_resident_store_passes(resident_sia):
    report = check_integrity(resident_sia)
    assert report["ok"], report
    assert report["checks"]["store"] == "DeviceIndex"
    assert report["checks"]["resident"] is True
    assert report["checks"]["index_hashes"] == report["checks"]["catalog_hashes"]
    assert report["checks"]["capacity"] == 1 << 16
    assert resident_sia._host_stale   # checked on the device, not synced


def test_resident_pending_appends_warn(resident_sia):
    """Deferred-sort appends: a warning, not an error, and the count
    identity still holds."""
    store = resident_sia._dev_store
    n = store.n_valid
    tail = tuple(c[n - 500: n].flip(0).clone() for c in store.cols)
    store.n_valid = n - 500
    store._sorted_rows = n - 500
    store.append_run(tail, 500, store.n_songs, store.max_offset)
    assert store._unsorted
    report = check_integrity(resident_sia)
    assert report["ok"], report
    assert any("deferred-sort appends" in w for w in report["warnings"])


def test_resident_corruptions_detected(resident_sia):
    store = resident_sia._dev_store
    n = store.n_valid
    store.cols[0][n + 3] = 0                       # a padding row
    store.cols[0][[0, 1]] = store.cols[0][[1, 0]].clone()
    store.cols[2][5] = store.n_songs * store.stride + 1
    resident_sia.catalog.update_song_hashes(
        *(lambda sid, n: (sid, n + 2))(
            *min(resident_sia.catalog.song_hashes_by_id().items())))
    report = check_integrity(resident_sia)
    assert not report["ok"]
    for msg in ("padding rows are not sentinels", "rows are not sorted",
                "payload max", "catalog records"):
        assert any(msg in e for e in report["errors"]), (msg, report)


def test_report_matches_jax(built):
    """The JAX package's fsck on the same songs: the same verdict and
    counts."""
    from shazam_tpu.api import SIA as JaxSIA
    from shazam_tpu.tools.fsck import check_integrity as jax_check

    ref = JaxSIA()
    ref.ingest_arrays(_songs(), batch_size=4)
    got, want = check_integrity(built), jax_check(ref)
    assert got["ok"] and want["ok"]
    for key in ("catalog_songs", "songs_reconciled"):
        assert got["checks"][key] == want["checks"][key]
    assert abs(got["checks"]["index_hashes"] - want["checks"]["index_hashes"]) \
        <= 0.02 * want["checks"]["index_hashes"]
