"""Query preparation: channel fingerprints -> padded host query arrays.

The reference builds a Python set of (hash, offset) pairs across channels
(``recognizer.py:378-382``) and a hash -> offsets mapper
(``recognizer.py:237-242``). Here that becomes: dedup on the host (numpy
sort-unique over the 80-bit keys + offset), flag the first pair of every
distinct hash (the dedup-row-count unit), and pad to a power-of-two
length, as the JAX package's ``match/prepare.py`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from ..ops.fingerprint import Fingerprints, union_pairs


class QueryPairs(NamedTuple):
    hi: np.ndarray      # uint32 (Q,)
    lo: np.ndarray      # uint32 (Q,)
    ex: np.ndarray      # uint32 (Q,)
    t: np.ndarray       # uint32 (Q,)
    valid: np.ndarray   # bool   (Q,)
    first: np.ndarray   # bool   (Q,) first pair of its distinct hash
    n_pairs: int        # true unique pair count


def _bucket(n: int, minimum: int = 1024) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def prepare_query(fps: Sequence[Fingerprints], pad_to: int | None = None) -> QueryPairs:
    """Dedup + pad the fingerprints of one or more channels."""
    hi, lo, ex, t = union_pairs(fps)
    first = np.ones(len(hi), bool)  # first pair of each distinct hash
    first[1:] = ~((hi[1:] == hi[:-1]) & (lo[1:] == lo[:-1])
                  & (ex[1:] == ex[:-1]))

    n = len(hi)
    cap = pad_to if pad_to is not None else _bucket(max(n, 1))
    if n > cap:
        raise ValueError(f"query has {n} pairs > pad_to={cap}")
    pad = cap - n
    return QueryPairs(
        hi=np.pad(hi, (0, pad)),
        lo=np.pad(lo, (0, pad)),
        ex=np.pad(ex, (0, pad)),
        t=np.pad(t, (0, pad)),
        valid=np.pad(np.ones(n, bool), (0, pad)),
        first=np.pad(first, (0, pad)),
        n_pairs=n,
    )


def q_frames_for_max_offset(max_offset: int, floor: int = 1024) -> int:
    """Smallest power-of-two delta window strictly covering a query's max
    frame offset (>= floor): THE sizing rule of the vote histogram."""
    frames = floor
    while frames <= max_offset:
        frames *= 2
    return frames
