"""The plain reference's stereo query: the set union of the channels'
(hash, offset) pairs.

The reference's one-shot recognizer (``recognizer.py:355-382``) records
its clip in stereo, fingerprints each channel and queries the Python set
of the (hash, offset) pairs of all of them (``recognizer.py:377-382``):
a pair heard on both channels is one pair of the query. Here each row of
a (C, N) clip is a channel; ``match.match`` answers the union over the
whole catalog. Plain torch; imports nothing of the program.
"""

from __future__ import annotations

import torch


def union_rows(fp, x: torch.Tensor, n_valid: int):
    """(C, >= n_valid) channel samples -> (key, t1) of the unique pairs
    of every channel's rows, sorted by (key, t1), as ``match.match``
    takes a query. ``fp`` is a ``fingerprint.Fingerprinter``."""
    _, key, t1 = fp.rows(x, n_valid)
    comp = torch.unique((key << 20) | t1)     # t1 < 2^20, key < 2^31
    return comp >> 20, comp & ((1 << 20) - 1)
