"""Host-side song catalog: the non-perf-critical relational state.

Mirrors the reference's ``songs`` + ``METADATA`` tables and their
life-cycle semantics (``mysql_database.py``):

- songs(song_id, song_name, fingerprinted, file_sha1, total_hashes,
  date_created, date_modified) with auto-increment ids
  (``CREATE_SONGS_TABLE``, ``mysql_database.py:32-44``)
- a song is durable only after ``set_song_fingerprinted`` flips the flag;
  ``delete_unfingerprinted()`` on open purges half-ingested songs —
  the reference's crash-recovery protocol (``__init__.py:421-424``,
  ``mysql_database.py:131-134``)
- FMA-style metadata table + ``get_metadata`` (``mysql_database.py:113-119,
  235-255``, ``metadatatable.sql``)

Backed by stdlib sqlite3 (file or in-memory). The schema is the JAX
package's (``shazam_tpu/index/catalog.py``), so a catalog file written by
either package opens in the other; the module is repeated here because the
JAX package's ``index`` package imports JAX on load.
"""

from __future__ import annotations

import sqlite3
from typing import Dict, List, Optional

_SERIALIZED: Optional[bool] = None


def _sqlite_serialized() -> bool:
    """True when the linked SQLite was built THREADSAFE=1 (serialized)."""
    global _SERIALIZED
    if _SERIALIZED is None:
        try:
            probe = sqlite3.connect(":memory:")
            row = probe.execute(
                "SELECT compile_options FROM pragma_compile_options"
                " WHERE compile_options LIKE 'THREADSAFE=%'"
            ).fetchone()
            probe.close()
            _SERIALIZED = bool(row) and row[0] == "THREADSAFE=1"
        except Exception:
            _SERIALIZED = False  # unknown build: keep the loud check
    return _SERIALIZED


class SongCatalog:
    """sqlite3-backed songs/metadata catalog with reference semantics."""

    def __init__(self, path: str = ":memory:"):
        self.path = path
        # A serialized SQLite build (THREADSAFE=1, the default) locks
        # around every connection use, so the connection may cross
        # threads (the HTTP serving daemon answers on a batcher thread
        # while /stats reads from handler threads).  Probe the actual
        # compile option: sqlite3.threadsafety is hardcoded to 1 on
        # Python <= 3.10 regardless of the library build, so gating on
        # it would break serving there.  Non-serialized builds keep the
        # loud per-thread check instead of racing.
        self.conn = sqlite3.connect(
            path, check_same_thread=not _sqlite_serialized())
        self.conn.execute(
            """CREATE TABLE IF NOT EXISTS songs (
                   song_id INTEGER PRIMARY KEY AUTOINCREMENT,
                   song_name TEXT NOT NULL,
                   fingerprinted INTEGER DEFAULT 0,
                   file_sha1 TEXT NOT NULL,
                   total_hashes INTEGER NOT NULL DEFAULT 0,
                   date_created TEXT NOT NULL DEFAULT CURRENT_TIMESTAMP,
                   date_modified TEXT NOT NULL DEFAULT CURRENT_TIMESTAMP
               )"""
        )
        self.conn.execute(
            """CREATE TABLE IF NOT EXISTS metadata (
                   track_id INTEGER PRIMARY KEY,
                   album_title TEXT, album_url TEXT,
                   artist_name TEXT, artist_url TEXT, artist_website TEXT,
                   tags TEXT, track_genres TEXT, track_title TEXT,
                   track_url TEXT
               )"""
        )
        self.conn.commit()

    # ---- reference API surface ----
    def delete_unfingerprinted(self) -> None:
        """Purge songs whose ingest never completed (DELETE_UNFINGERPRINTED)."""
        self.conn.execute("DELETE FROM songs WHERE fingerprinted = 0")
        self.conn.commit()

    def insert_song(self, song_name: str, file_sha1: str, total_hashes: int) -> int:
        cur = self.conn.execute(
            "INSERT INTO songs (song_name, file_sha1, total_hashes) VALUES (?, ?, ?)",
            (song_name, file_sha1.upper(), total_hashes),
        )
        self.conn.commit()
        return int(cur.lastrowid)

    def update_song_hashes(self, song_id: int, total_hashes: int) -> None:
        """Set a song's hash count after the fact (device-side ingest
        learns the deduped count only once the run is built in HBM)."""
        self.conn.execute(
            "UPDATE songs SET total_hashes = ? WHERE song_id = ?",
            (total_hashes, song_id),
        )
        self.conn.commit()

    def set_song_fingerprinted(self, song_id: int) -> None:
        self.conn.execute(
            "UPDATE songs SET fingerprinted = 1, date_modified = CURRENT_TIMESTAMP"
            " WHERE song_id = ?",
            (song_id,),
        )
        self.conn.commit()

    def get_songs(self) -> List[Dict]:
        """All fully fingerprinted songs (SELECT_SONGS semantics)."""
        cur = self.conn.execute(
            "SELECT song_id, song_name, file_sha1, total_hashes, date_created"
            " FROM songs WHERE fingerprinted = 1"
        )
        cols = ["song_id", "song_name", "file_sha1", "total_hashes", "date_created"]
        return [dict(zip(cols, row)) for row in cur.fetchall()]

    def get_song_by_id(self, song_id: int) -> Optional[Dict]:
        cur = self.conn.execute(
            "SELECT song_name, file_sha1, total_hashes FROM songs WHERE song_id = ?",
            (song_id,),
        )
        row = cur.fetchone()
        if row is None:
            return None
        return {"song_name": row[0], "file_sha1": row[1], "total_hashes": row[2]}

    def song_hashes_by_id(self) -> Dict[int, int]:
        cur = self.conn.execute("SELECT song_id, total_hashes FROM songs")
        return {int(r[0]): int(r[1]) for r in cur.fetchall()}

    def fingerprinted_file_hashes(self) -> set:
        """SHA-1 set for ingest resume (load_fingerprinted_audio_hashes)."""
        cur = self.conn.execute(
            "SELECT file_sha1 FROM songs WHERE fingerprinted = 1"
        )
        return {r[0] for r in cur.fetchall()}

    def delete_songs(self, song_ids) -> None:
        """Remove songs from the catalog (reference ``DELETE_SONGS``,
        ``mysql_database.py:136-138``; hash rows cascade via the index
        rebuild in ``SIA.delete_songs``)."""
        self.conn.executemany(
            "DELETE FROM songs WHERE song_id = ?",
            [(int(s),) for s in song_ids],
        )
        self.conn.commit()

    def insert_metadata(self, track_id: int, commit: bool = True,
                        **fields) -> None:
        allowed = [
            "album_title", "album_url", "artist_name", "artist_url",
            "artist_website", "tags", "track_genres", "track_title", "track_url",
        ]
        cols = ["track_id"] + [k for k in allowed if k in fields]
        vals = [track_id] + [fields[k] for k in allowed if k in fields]
        self.conn.execute(
            f"INSERT OR REPLACE INTO metadata ({', '.join(cols)})"
            f" VALUES ({', '.join('?' * len(cols))})",
            vals,
        )
        if commit:
            self.conn.commit()

    def import_metadata_csv(self, path: str) -> int:
        """Bulk-load an FMA-style metadata CSV (reference
        ``metadatatable.sql`` LOAD DATA INFILE). The CSV must have a
        header row naming at least ``track_id``; other recognized columns
        are the metadata table fields. Returns rows imported.

        ONE transaction for the whole file: a commit (journal fsync) per
        row turns the ~106K-track FMA import into minutes, and a crash
        mid-import would leave a partial table instead of an atomic one.
        """
        import csv as _csv

        allowed = {
            "album_title", "album_url", "artist_name", "artist_url",
            "artist_website", "tags", "track_genres", "track_title",
            "track_url",
        }
        n = 0
        try:
            with open(path, newline="", encoding="utf-8",
                      errors="replace") as fh:
                for row in _csv.DictReader(fh):
                    if "track_id" not in row:
                        continue
                    try:
                        tid = int(row["track_id"])
                    except (TypeError, ValueError):
                        continue
                    fields = {k: v for k, v in row.items()
                              if k in allowed and v not in (None, "")}
                    self.insert_metadata(tid, commit=False, **fields)
                    n += 1
        except BaseException:
            self.conn.rollback()
            raise
        self.conn.commit()
        return n

    def get_metadata(self, track_id: int) -> Optional[Dict]:
        """Same projection the reference returns (``mysql_database.py:247-255``)."""
        cur = self.conn.execute(
            "SELECT album_title, artist_name, artist_website, track_genres,"
            " track_title, track_url FROM metadata WHERE track_id = ?",
            (track_id,),
        )
        row = cur.fetchone()
        if row is None:
            return None
        return {
            "track_title": row[4],
            "album_title": row[0],
            "artist_name": row[1],
            "artist_website": row[2],
            "track_genres": row[3],
            "track_url": row[5],
        }

    # ---- stats (database_plot.py / *.sql equivalents) ----
    def song_hash_stats(self) -> List[Dict]:
        cur = self.conn.execute(
            "SELECT song_name, total_hashes FROM songs WHERE fingerprinted = 1"
            " ORDER BY total_hashes DESC"
        )
        return [{"song_name": r[0], "total_hashes": r[1]} for r in cur.fetchall()]

    def counts(self) -> Dict[str, int]:
        n_songs = self.conn.execute(
            "SELECT COUNT(*) FROM songs WHERE fingerprinted = 1"
        ).fetchone()[0]
        n_hashes = self.conn.execute(
            "SELECT COALESCE(SUM(total_hashes), 0) FROM songs WHERE fingerprinted = 1"
        ).fetchone()[0]
        return {"n_songs": int(n_songs), "n_hashes": int(n_hashes)}

    def close(self) -> None:
        self.conn.close()
