"""Corpus hygiene checker.

A copy of ``shazam_tpu/tools/sanity.py``.

Reproduces ``check_songs_sanity.py`` (reference ``:120-139``): every
corpus file must decode and be at least ``record_seconds`` long;
failures are logged to ``songs_deleted.csv`` and (optionally, like the
reference's ``os.remove``) deleted.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Sequence

from ..audio.io import read


def check_corpus_sanity(
    files: Sequence[str],
    record_seconds: float = 5.0,
    delete: bool = False,
    log_path: str = "songs_deleted.csv",
) -> Dict:
    """Validate decode + duration for every file; returns a summary."""
    bad: List[Dict] = []
    for path in files:
        reason = None
        try:
            channels, fs, _sha = read(path)
            duration = len(channels[0]) / fs if channels else 0.0
            if duration < record_seconds:
                reason = f"too_short:{duration:.2f}s"
        except Exception as exc:  # undecodable
            reason = f"decode_error:{type(exc).__name__}"
        if reason:
            bad.append({"file": path, "reason": reason})
            if delete:
                try:
                    os.remove(path)
                except OSError:
                    pass

    if bad:
        with open(log_path, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=["file", "reason"])
            writer.writeheader()
            writer.writerows(bad)

    return {"checked": len(files), "bad": len(bad), "deleted": bad if delete else [],
            "log": log_path if bad else None, "bad_files": bad}
