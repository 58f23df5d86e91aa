"""Catalog statistics dumper.

A copy of ``shazam_tpu/tools/stats.py``.

Reproduces ``database_plot.py`` (reference ``:100-153``): per-song hash
counts ordered descending -> ``song_hashes.csv``, plus top/bottom-10
summaries and totals (the hand-run queries in ``songs_queries.sql`` /
``fingerprints_queries.sql``).
"""

from __future__ import annotations

import csv
from typing import Dict

from ..index.catalog import SongCatalog


def dump_song_hash_stats(catalog: SongCatalog,
                         csv_path: str = "song_hashes.csv") -> Dict:
    rows = catalog.song_hash_stats()
    with open(csv_path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=["song_name", "total_hashes"])
        writer.writeheader()
        writer.writerows(rows)
    counts = catalog.counts()
    return {
        "csv": csv_path,
        "n_songs": counts["n_songs"],
        "n_hashes": counts["n_hashes"],
        "avg_hashes_per_song": (
            counts["n_hashes"] / counts["n_songs"] if counts["n_songs"] else 0.0
        ),
        "top10": rows[:10],
        "bottom10": rows[-10:],
    }
