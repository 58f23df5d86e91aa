"""Apriori early-exit matching.

The port of ``shazam_tpu/match/apriori.py``, after the reference's
early-termination matcher (``recognizer_apriori.py:245-310``): the query
pairs are matched in batches; after each batch the partial per-song
results are ranked and the sweep stops once the leader has more than
twice the runner-up's matched rows (``:303``: ``if top1/2 > top2:
break``). The leader and runner-up are the top two songs by aligned votes
(ties to the smaller song id, as ``lax.top_k``), compared by their dedup
row counts.

Both variants search every lane once, then expand each batch at
``match_capacity`` and add its votes into a dense (n_songs, delta_range)
int32 histogram and per-song row counts on the device
(``lookup.accumulate_votes``); the accumulated histogram is ranked once
(``lookup.rank_votes``). The histogram only exists under
``config.sparse_vote_threshold``, where ``SIA`` takes early exit.

- ``match_query_apriori`` reads the stop test back after every batch, as
  the JAX package's host loop does.
- ``match_query_apriori_ondevice`` keeps the stop test on the device: a
  batch launched after the stop adds nothing (a device-side flag gates
  its votes, totals and count), so the results equal the host loop's
  batch for batch, and the host reads the flag only after batches 1, 2,
  4, 8, ... to stop launching. At most as many batches run past the stop
  as ran before it, and a sweep of n batches syncs about log2(n) times
  instead of n. (The JAX package runs the sweep as one ``lax.while_loop``
  program, which eager PyTorch has no counterpart for.)

The JAX package's ``head`` and ``offset_stride`` arguments are not here,
as in the port's other matchers: the store view carries the stride, and
the bucket head is not ported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..index.search import lexi_bounds
from ..index.store import DeviceIndex
from .lookup import (RawMatch, _desc, _zero, accumulate_votes, check_vote_key,
                     expand_stack, rank_votes, raw_to_host)
from .prepare import QueryPairs


def _sweep(index: DeviceIndex, q: QueryPairs, *, n_songs: int,
           delta_min: int, delta_range: int, match_capacity: int, topn: int,
           batch_size: int, read_every_batch: bool
           ) -> Tuple[RawMatch, int, bool]:
    """The batched sweep with the 2x-leader stop, read back after every
    batch or after batches 1, 2, 4, ...; returns (host RawMatch,
    batches used, clamped)."""
    check_vote_key(n_songs, delta_range)
    dev = index.key64.device
    # batch over the true pair count: a batch of padding learns nothing
    n = max(int(q.n_pairs), 1)
    n_batches = max(1, -(-n // batch_size))
    lanes = n_batches * batch_size

    def up(col, dtype):
        a = np.asarray(col)[:n]
        return torch.from_numpy(np.pad(a, (0, lanes - len(a))).astype(dtype)
                                ).to(dev).view(n_batches, batch_size)

    q_hi, q_lo, q_ex, q_t = (up(getattr(q, c), np.int64)
                             for c in ("hi", "lo", "ex", "t"))
    q_valid, q_first = up(q.valid, bool), up(q.first, bool)
    lb, ub = lexi_bounds(index, q_hi, q_lo, q_ex, q_valid)

    hist = torch.zeros((n_songs, delta_range), dtype=torch.int32, device=dev)
    rows_hist = torch.zeros(n_songs, dtype=torch.int32, device=dev)
    total, n_dropped, used = _zero(hist), _zero(hist), _zero(hist)
    clamped = torch.zeros((), dtype=torch.bool, device=dev)
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    for b in range(n_batches):
        sid, delta, p, valid, t, nd = (a[0] for a in expand_stack(
            index, lb[b: b + 1], ub[b: b + 1], q_t[b: b + 1],
            q_valid[b: b + 1], match_capacity=match_capacity))
        live = ~stop
        accumulate_votes(hist, rows_hist, sid, delta, q_first[b][p], valid,
                         delta_min=delta_min, live=live)
        total += t * live
        n_dropped += nd * live
        used += live.to(torch.int64)
        clamped |= (t > match_capacity) & live
        # the reference's margin rule on the partial result: the vote-ranked
        # top-2 songs' dedup row counts, the leader's halved still ahead
        top2 = rows_hist[_desc(hist.max(1).values)[1][:2]].to(torch.int64)
        runner = top2[1] if n_songs > 1 else _zero(hist)
        stop |= top2[0] > 2 * runner
        if b + 1 < n_batches and (read_every_batch or not b & (b + 1)):
            if bool(stop):
                break
    raw = rank_votes(hist, rows_hist, total, delta_min=delta_min, topn=topn,
                     n_dropped=n_dropped)
    host, (used_h, clamped_h) = raw_to_host(raw, used, clamped)
    return host, used_h, bool(clamped_h)


def match_query_apriori(index: DeviceIndex, q: QueryPairs, *, n_songs: int,
                        delta_min: int, delta_range: int,
                        match_capacity: int = 65536, topn: int = 2,
                        batch_size: int = 1024) -> Tuple[RawMatch, int, bool]:
    """Batched match with the 2x-leader early exit, the stop test read back
    after every batch.

    Returns (host RawMatch, batches_used, clamped). ``total_rows`` is the
    true match count accumulated over the batches used; ``clamped`` is
    True iff a single batch expanded past ``match_capacity`` (the only
    way votes are dropped here: the accumulated total may pass the
    capacity on a multi-batch query, so callers must not infer overflow
    from it). With no early exit the result equals the full match; with
    one it reflects the partial scan, as the reference's apriori mode.
    """
    return _sweep(index, q, n_songs=n_songs, delta_min=delta_min,
                  delta_range=delta_range, match_capacity=match_capacity,
                  topn=topn, batch_size=batch_size, read_every_batch=True)


def match_query_apriori_ondevice(index: DeviceIndex, q: QueryPairs, *,
                                 n_songs: int, delta_min: int,
                                 delta_range: int,
                                 match_capacity: int = 65536, topn: int = 2,
                                 batch_size: int = 1024
                                 ) -> Tuple[RawMatch, int, bool]:
    """``match_query_apriori`` with the stop test kept on the device: the
    same returns, batch for batch, with the flag read back only after
    batches 1, 2, 4, ... (see the module docstring)."""
    return _sweep(index, q, n_songs=n_songs, delta_min=delta_min,
                  delta_range=delta_range, match_capacity=match_capacity,
                  topn=topn, batch_size=batch_size, read_every_batch=False)
