"""Host-side result assembly: reference-shaped match dictionaries.

Builds the exact result records the reference emits
(``recognizer.py:313-336``): song name/id, hash counts, the two
confidence ratios, the offset and its seconds conversion
(``offset / Fs * wsize * wratio``, ``recognizer.py:318``).

Host-only numpy, the same as ``shazam_tpu/match/align.py``; repeated here
because the JAX package's ``match`` package imports JAX on load.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np

from ..config import DEFAULT_CONFIG, FingerprintConfig
from ..profiling import spanned

# reference field names (recognizer.py:40-58)
SONG_ID = "song_id"
SONG_NAME = "song_name"
INPUT_HASHES = "input_total_hashes"
FINGERPRINTED_HASHES = "fingerprinted_hashes_in_db"
HASHES_MATCHED = "hashes_matched_in_input"
INPUT_CONFIDENCE = "input_confidence"
FINGERPRINTED_CONFIDENCE = "fingerprinted_confidence"
OFFSET = "offset"
OFFSET_SECS = "offset_seconds"
FIELD_FILE_SHA1 = "file_sha1"


class MatchResult(NamedTuple):
    results: List[Dict]
    total_matches: int
    overflowed: bool
    # True when the expansion budget excluded runs (n_dropped > 0): the
    # top-1 song/offset may still be provably exact (the early-accept
    # certificate — see RawMatch), but HASHES_MATCHED / vote-count /
    # n_ranked style fields are LOWER BOUNDS, not the full-expansion
    # counts the reference reports. Serving clients use this to tell
    # bounded counts from exact ones.
    partial_counts: bool = False


@spanned("sia.align")
def align_results(
    raw,
    queried_hashes: int,
    catalog=None,
    config: FingerprintConfig = DEFAULT_CONFIG,
    match_capacity: Optional[int] = None,
) -> MatchResult:
    """Convert a device RawMatch into reference-shaped result dicts.

    :param raw: host ``RawMatch`` (``match.lookup.raw_to_host``).
    :param queried_hashes: number of unique (hash, offset) pairs queried
        (reference passes ``len(hashes)``, ``recognizer.py:389``).
    :param catalog: optional ``SongCatalog`` for names/sha1/total_hashes.
    """
    top_songs = np.asarray(raw.top_songs)
    top_deltas = np.asarray(raw.top_deltas)
    top_votes = np.asarray(raw.top_votes)
    row_counts = np.asarray(raw.row_counts)
    total = int(raw.total_rows)
    n_ranked = int(raw.n_ranked)
    cap = match_capacity or config.match_capacity
    overflowed = total > cap
    # n_dropped > 0 <=> the expansion budget excluded runs, so count
    # fields are lower bounds (early-accepted clamps report a fitting
    # capacity and read overflowed=False — this flag still marks them)
    partial = int(raw.n_dropped) > 0

    results = []
    for rank in range(min(len(top_songs), n_ranked)):
        sid = int(top_songs[rank])
        votes = int(top_votes[rank])
        if votes <= 0:
            break
        matched = int(row_counts[rank])
        song = catalog.get_song_by_id(sid) if catalog is not None else None
        song_name = song["song_name"] if song else str(sid)
        song_hashes = song["total_hashes"] if song else None
        record = {
            SONG_ID: sid,
            SONG_NAME: song_name,
            INPUT_HASHES: queried_hashes,
            FINGERPRINTED_HASHES: song_hashes,
            HASHES_MATCHED: matched,
            INPUT_CONFIDENCE: round(matched / queried_hashes, 2) if queried_hashes else 0.0,
            FINGERPRINTED_CONFIDENCE: (
                round(matched / song_hashes, 2) if song_hashes else None
            ),
            OFFSET: int(top_deltas[rank]),
            OFFSET_SECS: config.frames_to_seconds(int(top_deltas[rank])),
            FIELD_FILE_SHA1: song["file_sha1"] if song else None,
        }
        results.append(record)
    return MatchResult(results, total, overflowed, partial)
