"""On-device ingest: a sorted, deduped addition run built where the
fingerprints are.

The port of ``shazam_tpu/index/devingest.py``. Host ingest downloads each
batch's fingerprints, dedups and sorts them per song on the host and
merges them there. ``device_sorted_run`` keeps the whole addition on the
device instead:

    Fingerprints batch (B, L)
      -> payload song * stride + offset per lane, padding lanes set to the
         sentinel (after every real row in every column)
      -> one lexicographic sort over (key64, ex, payload)
      -> neighbour-equality dedup: the reference's per-song channel
         set-union of (hash, offset) pairs (``__init__.py:254-266``), since
         equal rows can only come from one song (the payload holds its id)
      -> the surviving rows packed to the front in order (a prefix sum
         and one scatter: the run is already sorted)

and ``index/devmerge.DeviceIndex.merge_device_run`` or ``append_run``
absorbs the run. Host traffic per batch: the (B,) song ids up, and the
run length, per-row song counts and the overflow flag down in one read.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .devmerge import SENTINEL, Cols, empty_cols, lexsort_rows
from .search import query_key64


def device_sorted_run(hi: torch.Tensor, lo: torch.Tensor, ex: torch.Tensor,
                      t1: torch.Tensor, valid: torch.Tensor,
                      sids: torch.Tensor, *, stride: int, addition_cap: int
                      ) -> Tuple[Cols, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """A ``DeviceIndex``-layout addition run from a Fingerprints batch.

    :param hi, lo, ex, t1, valid: (B, L) columns of ``fingerprint_batch*``
        (several rows may be one song's channels: they union here).
    :param sids: (B,) catalog song id per row.
    :param stride: the store's payload stride, above every offset (the
        caller runs ``DeviceIndex._ensure_layout`` first).
    :param addition_cap: the run's row capacity (clamped to B * L).
    :returns: (cols, n_run, counts, overflowed): cols is the sorted
        (key64, ex, payload) run padded with sentinel rows to
        ``addition_cap``; n_run its real rows; counts[i] the deduped rows
        of row i's song (every row of a song reports the song's total);
        overflowed is set when the valid lanes exceed ``addition_cap``,
        and then the run is incomplete and must not be merged. All four
        stay on the device.
    """
    bsz, lanes = hi.shape
    cap = min(addition_cap, bsz * lanes)
    device = hi.device
    sids = sids.to(device=device, dtype=torch.int64)
    flat_valid = valid.reshape(-1)
    key64 = torch.where(flat_valid, query_key64(hi, lo).reshape(-1), SENTINEL)
    exs = torch.where(flat_valid, ex.reshape(-1).to(torch.int64), SENTINEL)
    pay = torch.where(flat_valid,
                      (sids[:, None] * stride + t1.to(torch.int64)).reshape(-1),
                      SENTINEL)
    order = lexsort_rows(key64, exs, pay)[:cap]
    n_valid_total = flat_valid.sum()
    overflowed = n_valid_total > cap

    # valid lanes lead after the sort, so the first cap rows hold them all
    # whenever overflowed is False
    k, e, p = key64[order], exs[order], pay[order]
    dup = torch.zeros(len(order), dtype=torch.bool, device=device)
    dup[1:] = (k[1:] == k[:-1]) & (e[1:] == e[:-1]) & (p[1:] == p[:-1])
    live = (e != SENTINEL) & ~dup
    n_run = live.sum()

    # per-row song counts: one bincount over the batch's distinct songs
    songs, row_song = torch.unique(sids, return_inverse=True)
    slot = torch.searchsorted(songs, torch.where(live, p // stride, 0))
    per_song = torch.bincount(torch.where(live, slot, len(songs)),
                              minlength=len(songs) + 1)
    counts = per_song[row_song]

    # the live rows, already in order, packed to the front
    dest = torch.where(live, torch.cumsum(live, 0) - 1, cap)
    cols = empty_cols(cap + 1, device)
    for out, col in zip(cols, (k, e, p)):
        out[dest] = col
    return tuple(c[:cap] for c in cols), n_run, counts, overflowed
