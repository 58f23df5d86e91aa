"""The plain reference match: the reference's ``align_matches`` vote and
rank over a catalog of pair rows, in plain torch.

Semantics of ``recognizer.py:222-338`` as the repository's test oracle
states them (``tests/oracle/oracle.py``, ``oracle_align``): the query is
the set of unique (hash, offset) pairs; every catalog row that shares a
query hash votes once for (song, row offset - query offset) per query
offset of that hash; a song's answer is its most voted delta, ties to
the smallest delta; songs rank by votes, ties to the smallest song id.
``hashes_matched`` of a song counts its rows hit by a distinct query hash;
``total`` counts every (query pair, row) match.
"""

from __future__ import annotations

import torch


class Catalog:
    """Catalog pair rows (song, triple key, offset), sorted by key."""

    def __init__(self, songs, keys, offsets):
        order = torch.argsort(keys, stable=True)
        self.keys = keys[order]
        self.songs = songs[order]
        self.offsets = offsets[order]

    @classmethod
    def concat(cls, parts):
        return cls(*(torch.cat([p[i] for p in parts]) for i in range(3)))


def match(cat: Catalog, q_keys: torch.Tensor, q_offs: torch.Tensor):
    """Answer one query of unique (key, offset) pairs. Returns a dict:
    song, offset (frames), votes, hashes_matched (of the top song), total,
    pairs; song is None when no row matches."""
    lb = torch.searchsorted(cat.keys, q_keys, side="left")
    ub = torch.searchsorted(cat.keys, q_keys, side="right")
    lens = ub - lb
    total = int(lens.sum())
    out = {"song": None, "offset": None, "votes": 0, "hashes_matched": 0,
           "total": total, "pairs": int(q_keys.numel())}
    if total == 0:
        return out
    pair = torch.repeat_interleave(torch.arange(len(lens), device=lens.device),
                                   lens)
    start = torch.cumsum(lens, 0) - lens
    row = lb[pair] + (torch.arange(total, device=lens.device) - start[pair])
    sid = cat.songs[row]
    delta = cat.offsets[row] - q_offs[pair]
    # (song, delta) vote bins
    dmin = int(delta.min())
    span = int(delta.max()) - dmin + 1
    bins, votes = torch.unique(sid * span + (delta - dmin),
                               return_counts=True)
    b_sid = bins // span
    best = torch.zeros(int(b_sid.max()) + 1, dtype=votes.dtype,
                       device=votes.device).scatter_reduce(
        0, b_sid, votes, "amax")
    top_votes = int(best.max())
    top = int(torch.nonzero(best == top_votes)[0])       # smallest song id
    at_top = (b_sid == top) & (votes == top_votes)
    top_delta = int((bins[at_top] % span).min()) + dmin  # smallest delta
    # rows of the top song hit by a distinct query key: count each row
    # once per distinct key, i.e. only through the key's first pair
    first = torch.ones_like(q_keys, dtype=torch.bool)
    first[1:] = q_keys[1:] != q_keys[:-1]       # q_keys sorted
    hit = first[pair] & (sid == top)
    out.update(song=top, offset=top_delta, votes=top_votes,
               hashes_matched=int(hit.sum()))
    return out
