"""Index/catalog integrity checker (``shazam-tpu-torch fsck``).

The port of ``shazam_tpu/tools/fsck.py``. The reference's integrity story
was hand-run SQL (row counts, orphan deletes — ``fingerprints_queries.sql:1-6``,
``songs_queries.sql:1-11``) plus the ``DELETE_UNFINGERPRINTED`` startup
purge. This is the first-class equivalent: one command that validates
every invariant the matcher relies on and reconciles the index against
the catalog.

Checks (host index, always):

- key columns lexicographically sorted (binary search soundness);
- ``song_id < n_songs`` and ``offset <= max_offset`` (payload packing
  and vote-histogram bounds);
- per-song index row counts equal the catalog's ``total_hashes`` for
  every fingerprinted song (the crash signature ``load_index``
  reconciles — a fingerprinted flag without rows — is an ERROR here);
- index rows belonging to songs the catalog does not know (ERROR).

The device copy (``DeviceIndex``), when uploaded, is checked with
reductions on the device only: its real rows are as many as the host's,
its search keys sorted, its sentinel rows intact and its packed payload
below ``n_songs * stride``.

A device-resident SIA's store (``index/devmerge.DeviceIndex``) takes the
host index's place, as in the JAX package: its rows sorted by (key64, ex,
payload), its sentinel rows intact and its payload below ``n_songs *
stride``, each one reduction on its device, and its rows as many as the
catalog records. Deferred-sort appends still pending are a WARNING (their
order is not checked; the next query sorts them). A spanned SIA's
``SpannedDeviceStore`` is checked span by span (each stacked row of a
consolidated one too) with the JAX package's errors, one read-back for
all of them; ``spans_checked`` counts the non-empty spans without pending
appends, as the JAX package's does.

Catalog-side (always):

- fingerprinted songs with zero recorded hashes (WARNING);
- unfingerprinted leftovers (WARNING — purged on next open);
- duplicate file SHA-1s (WARNING — the resume dedup keys on it).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..index.devmerge import rows_sorted

_INT64_MAX = np.iinfo(np.int64).max


def _lexi_sorted_host(hi, lo, ex) -> bool:
    if len(hi) < 2:
        return True
    a, b = (hi[:-1], lo[:-1], ex[:-1]), (hi[1:], lo[1:], ex[1:])
    ok = (b[0] > a[0]) | ((b[0] == a[0]) & (
        (b[1] > a[1]) | ((b[1] == a[1]) & (b[2] >= a[2]))))
    return bool(np.all(ok))


def _device_checks(dix) -> Dict[str, object]:
    """(sorted, sentinels intact, payload max) of a ``DeviceIndex``, each
    one reduction on its device."""
    n = dix.n_rows
    k64, sub = dix.key64[:n], dix.key_sub[:n]
    # key64 sorted, and key_sub (run start << 16 | ex) sorted too: equal
    # key64 rows share a run start, so this is the lexicographic order
    ok = torch.all(k64[1:] >= k64[:-1]) & torch.all(sub[1:] >= sub[:-1])
    pad = torch.all(dix.key64[n:] == _INT64_MAX) \
        & torch.all(dix.key_sub[n:] == _INT64_MAX)
    p_max = dix.payload[:n].max() if n else dix.payload.new_zeros(())
    s_ok, pad_ok, p_max = torch.stack(
        [ok.to(torch.int64), pad.to(torch.int64), p_max]).tolist()
    return {"sorted": bool(s_ok), "sentinels": bool(pad_ok),
            "payload_max": int(p_max)}


def _store_parts(store):
    """(cols, n_valid, sorted rows) of a flat store, or of every non-empty
    span of a spanned one (its stacked rows when consolidated)."""
    if not getattr(store, "is_spanned", False):
        return [(store.cols, store.n_valid, store._sorted_rows)]
    parts = [(s.cols, s.n_valid, s._sorted_rows) for s in store.spans
             if s.n_valid]
    if store.is_stacked:
        parts += [(tuple(c[i] for c in store._stacked[:3]), nv, nv)
                  for i, nv in enumerate(store._stacked_valids) if nv]
    return parts


def _store_checks(parts) -> Dict[str, object]:
    """(sorted, sentinels intact, payload max) over a store's parts, each
    one reduction on the device and one read-back for all of them;
    deferred-sort appends still pending are not held to the order, the
    rows before them are."""
    flags, maxes = [], []
    for cols, n, sorted_rows in parts:
        flags.append(rows_sorted(*(c[:sorted_rows] for c in cols)))
        flags.append(torch.all(cols[0][n:] == _INT64_MAX)
                     & torch.all(cols[1][n:] == _INT64_MAX))
        maxes.append(cols[2][:n].max() if n else cols[2].new_zeros(()))
    if not parts:
        return {"sorted": True, "sentinels": True, "payload_max": 0}
    host = torch.stack([f.to(torch.int64) for f in flags] + maxes).tolist()
    k = len(flags)
    return {"sorted": all(host[0:k:2]), "sentinels": all(host[1:k:2]),
            "payload_max": max(host[k:])}


def _check_store(store, catalog_total: int, errors: List[str],
                 warnings: List[str], checks: Dict[str, object]) -> None:
    """The device store's branch: the JAX package's store branch, with its
    spanned store's names and errors for a ``SpannedDeviceStore``."""
    spanned = getattr(store, "is_spanned", False)
    checks["store"] = type(store).__name__
    checks["resident"] = True
    checks["index_hashes"] = store.n_valid
    checks["capacity"] = store.capacity
    parts = _store_parts(store)
    pending = sum(sorted_rows < n for _c, n, sorted_rows in parts)
    checks["spans_checked"] = (len(parts) - pending if spanned
                               else int(store._sorted_rows > 0))
    if pending:
        warnings.append(
            f"{pending} span(s) hold deferred-sort appends — queries "
            "require finalize() first (sortedness not checked for those)"
            if spanned else
            "the device store holds deferred-sort appends — queries "
            "finalize them first (their order is not checked)")
    dev = _store_checks(parts)
    if not dev["sorted"]:
        errors.append(("device span key columns are not sorted"
                       if spanned else "device store rows are not sorted")
                      + " (binary search would be unsound)")
    if not dev["sentinels"]:
        errors.append("device store padding rows are not sentinels")
    limit = max(store.n_songs, 1) * store.stride
    if store.n_valid and dev["payload_max"] >= limit:
        errors.append(
            f"{'packed' if spanned else 'device store'} payload max "
            f"{dev['payload_max']} exceeds n_songs*stride "
            f"({max(store.n_songs, 1)}*{store.stride}) — "
            "song id or offset out of range")
    if store.n_valid != catalog_total:
        errors.append(
            f"index holds {store.n_valid} rows but the catalog records "
            f"{catalog_total} — reconcile with load_index or re-ingest the "
            "difference")


def check_integrity(sia, deep: bool = True) -> Dict:
    """Validate ``sia``'s live index + catalog; returns a report dict
    with ``ok`` / ``errors`` / ``warnings`` / ``checks``."""
    errors: List[str] = []
    warnings: List[str] = []
    checks: Dict[str, object] = {}

    catalog_hashes = sia.catalog.song_hashes_by_id()
    songs = {d["song_id"]: d for d in sia.catalog.get_songs()}

    # ---- catalog-side ---------------------------------------------------
    zero = [sid for sid in songs if catalog_hashes.get(sid, 0) == 0]
    if zero:
        warnings.append(
            f"{len(zero)} fingerprinted song(s) with zero recorded hashes "
            f"(ids {zero[:5]}{'...' if len(zero) > 5 else ''})")
    pending = sia.catalog.conn.execute(
        "SELECT COUNT(*) FROM songs WHERE fingerprinted = 0").fetchone()[0]
    if pending:
        warnings.append(f"{pending} unfingerprinted song row(s) — "
                        "purged on next catalog open")
    dup = sia.catalog.conn.execute(
        "SELECT file_sha1, COUNT(*) c FROM songs WHERE fingerprinted = 1 "
        "GROUP BY file_sha1 HAVING c > 1").fetchall()
    if dup:
        warnings.append(
            f"{len(dup)} duplicate file SHA-1(s) among fingerprinted songs "
            "(ingest resume dedups on SHA-1; duplicates suggest a hand-"
            "edited catalog)")
    checks["catalog_songs"] = len(songs)
    catalog_total = sum(catalog_hashes.get(sid, 0) for sid in songs)
    checks["catalog_hashes"] = catalog_total

    store = sia._dev_store
    if store is not None:
        with sia._upload_lock:
            _check_store(store, catalog_total, errors, warnings, checks)
        return {"ok": not errors, "errors": errors, "warnings": warnings,
                "checks": checks}

    # ---- host index -----------------------------------------------------
    ix = sia.index
    checks["store"] = "FingerprintIndex"
    checks["index_hashes"] = ix.n_hashes
    if not _lexi_sorted_host(ix.key_hi, ix.key_lo, ix.key_ex):
        errors.append("index key columns are not sorted "
                      "(binary search would be unsound)")
    if ix.n_hashes:
        if int(ix.song_id.max()) >= max(ix.n_songs, 1):
            errors.append(
                f"song_id max {int(ix.song_id.max())} >= n_songs "
                f"{ix.n_songs}")
        if int(ix.offset.max()) > ix.max_offset:
            errors.append(
                f"offset max {int(ix.offset.max())} > max_offset "
                f"{ix.max_offset} (vote-histogram bounds violated)")
    if ix.n_hashes != catalog_total:
        errors.append(
            f"index holds {ix.n_hashes} rows but the catalog records "
            f"{catalog_total}")
    if deep and ix.n_hashes:
        per_song = np.bincount(
            ix.song_id, minlength=max(ix.n_songs, 1))
        mismatched = []
        for sid, want in catalog_hashes.items():
            got = int(per_song[sid]) if sid < len(per_song) else 0
            if got != want:
                mismatched.append((sid, want, got))
        orphans = [sid for sid in np.nonzero(per_song)[0]
                   if int(sid) not in catalog_hashes]
        if mismatched:
            errors.append(
                f"{len(mismatched)} song(s) whose index row count "
                f"disagrees with the catalog (first: song "
                f"{mismatched[0][0]} catalog={mismatched[0][1]} "
                f"index={mismatched[0][2]})")
        if orphans:
            errors.append(
                f"{len(orphans)} song id(s) present in the index but "
                f"unknown to the catalog (first: {int(orphans[0])})")
        checks["songs_reconciled"] = len(catalog_hashes)

    # ---- device copy ----------------------------------------------------
    dix = sia._device_index
    if dix is not None:
        checks["store"] = "DeviceIndex"
        dev = _device_checks(dix)
        checks["device_rows"] = dix.n_rows
        if dix.n_rows != ix.n_hashes:
            errors.append(
                f"device index holds {dix.n_rows} rows but the host index "
                f"{ix.n_hashes} (a stale upload)")
        if not dev["sorted"]:
            errors.append("device index key columns are not sorted "
                          "(binary search would be unsound)")
        if not dev["sentinels"]:
            errors.append("device index padding rows are not sentinels")
        limit = max(ix.n_songs, 1) * dix.stride
        if dix.n_rows and dev["payload_max"] >= limit:
            errors.append(
                f"device payload max {dev['payload_max']} exceeds "
                f"n_songs*stride ({max(ix.n_songs, 1)}*{dix.stride}) — "
                "song id or offset out of range")

    return {"ok": not errors, "errors": errors, "warnings": warnings,
            "checks": checks}
