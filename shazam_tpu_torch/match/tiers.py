"""The capacity-tier policy of every match: one owner of each dispatch
decision, and the one escalation ladder.

A match expands at most ``match_capacity`` vote slots (a *tier*); the
tiers grow from ``config.match_capacity_fast`` x4, then x2 from
``match_tier_fine_from``, up to ``match_capacity_max``. What a dispatch
at a tier runs depends only on the config, the index and the tier:

- ``match_tiers``: the tier list, and ``fit``: the first tier that holds
  a count, else the last;
- ``is_sparse`` / ``rank_for``: the dense histogram up to
  ``sparse_vote_threshold`` vote bins, past it the sort or scan rank by
  ``vote_rank``;
- ``expand_block``: the blocked expansion's width for an index and a
  tier;
- ``big_index``: a store of at least ``bounds_probe_min_rows`` real rows,
  where the first dispatch is made at the decide tier (``DecideTier``)
  and keeps its search bounds;
- ``decided``: the provably-exact accept of a clamped answer.

``escalate`` is the ladder every single-query match climbs: the first
dispatch, the accept of a clamp that is decided, one re-dispatch at the
tier the exact count fits (reusing the first dispatch's search bounds),
and the row-by-row fallback after the blocked expansion's run budget
dropped runs.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..config import FingerprintConfig
from ..index.store import DeviceIndex


def match_tiers(config: FingerprintConfig,
                min_capacity: Optional[int] = None) -> List[int]:
    """The capacity tiers, smallest first; with ``min_capacity``, those
    that hold it (the last tier when none does)."""
    caps = [config.match_capacity_fast, config.match_capacity]
    if caps[0] >= caps[1]:
        caps = caps[1:]
    while caps[-1] < config.match_capacity_max:
        step = 2 if caps[-1] >= config.match_tier_fine_from else 4
        caps.append(min(caps[-1] * step, config.match_capacity_max))
    if min_capacity is not None:
        caps = [c for c in caps if c >= min_capacity] or caps[-1:]
    return caps


def fit(caps: List[int], count: int) -> int:
    """The first tier that holds ``count`` rows, else the last."""
    return next((c for c in caps if c >= count), caps[-1])


def is_sparse(n_songs: int, delta_range: int, threshold: int) -> bool:
    """Past ``threshold`` (song, delta) vote bins the dense histogram
    gives way to the sparse ranks."""
    return n_songs * delta_range > threshold


def rank_for(config: FingerprintConfig, cap: int, sparse: bool) -> str:
    """The rank of a dispatch at tier ``cap``: "dense" unless ``sparse``,
    else ``vote_rank``, whose "auto" is the sort rank at the fast tier and
    the scan rank above it. (The JAX package's "auto" takes its pruned
    rank at the fast tier, a TPU choice; every rank gives the same
    answer.)"""
    if not sparse:
        return "dense"
    if config.vote_rank == "auto":
        return "sort" if cap <= config.match_capacity_fast else "scan"
    return config.vote_rank


def expand_block(config: FingerprintConfig, index, cap: int) -> int:
    """``config.expand_block`` where a dispatch at tier ``cap`` takes the
    blocked expansion, else 0: from ``expand_block_min_capacity`` on (below
    it the run budget's 2 * expand_block_runs * B slots outweigh the tier),
    on a flat index or a stacked spanned one whose rows split into whole
    blocks; never per span (no blocked variant there, as in the JAX
    package)."""
    blk = config.expand_block
    if (not blk or cap < config.expand_block_min_capacity
            or not isinstance(index, DeviceIndex)):
        return 0
    return blk if index.payload.shape[-1] % blk == 0 else 0


def big_index(config: FingerprintConfig, index) -> bool:
    """The store holds at least ``bounds_probe_min_rows`` real rows (0:
    never): a flat or stacked view's, or the spans' together. Real rows,
    not the capacity the JAX package reads: a device store's reserved
    capacity must not change how a clip is matched."""
    rows = config.bounds_probe_min_rows
    if not rows:
        return False
    if isinstance(index, DeviceIndex):
        return index.n_rows >= rows
    return sum(view.n_rows for view in index) >= rows


def decided(raw, config: FingerprintConfig):
    """The margin test of a capacity-clamped answer: a host ``RawMatch``
    (a bool), or a batch's (B, ...) arrays (a (B,) bool array). True where
    the answer is provably the full one: every excluded run adds at most
    one vote to any (song, delta) bin, so a top-1 margin over the
    strongest challenger larger than the excluded-run count cannot be
    overturned. Never, with ``decision_escalation`` off."""
    margin = (np.asarray(raw.top_votes)[..., 0].astype(np.int64)
              - raw.runner_votes > raw.n_dropped)
    return margin & config.decision_escalation


class DecideTier:
    """The decide tier of one SIA and its self-tuning counter: over each
    ``decide_adapt_window`` decided-first dispatches, an undecided share
    above 1/2 raises the tier one step (corpora with long hyper-common
    runs need a larger run budget before margins certify), never past
    ``decide_adapt_max`` unless ``decide_capacity`` asks for more.

    A batch records each of its clips; ``escalate`` records its one
    decided-first dispatch. ``recognize_clip``'s single pass reaches
    ``escalate`` only when it is continued (clamped, not decided), so the
    window counts such a pass as one undecided attempt and never counts a
    pass that was decided or fitted. A clip's query holds every lane of
    its fingerprint, so a clip past any width is recorded the same way."""

    def __init__(self):
        self._window = [0, 0]   # [attempts, undecided] of this window
        self._boost = 0

    def cap(self, config: FingerprintConfig, caps: List[int]) -> int:
        """The decided-first dispatch tier: ``decide_capacity`` (0: the
        ``match_capacity`` tier) raised by the accumulated boost."""
        want = config.decide_capacity or config.match_capacity
        idx = next((i for i, c in enumerate(caps) if c >= want),
                   len(caps) - 1)
        idx = min(idx + self._boost, len(caps) - 1)
        while (idx > 0 and caps[idx] > config.decide_adapt_max
               and caps[idx] > want):
            idx -= 1
        return caps[idx]

    def record(self, config: FingerprintConfig, attempts: int,
               undecided: int) -> None:
        """Count decided-first dispatches and the undecided among them."""
        w = config.decide_adapt_window
        if not w:
            return
        self._window[0] += attempts
        self._window[1] += undecided
        if self._window[0] >= w:
            a, u = self._window
            self._window = [0, 0]
            if u * 2 > a:
                self._boost += 1

    def state(self) -> Tuple[Tuple[int, int], int]:
        """((attempts, undecided) of the current window, boost)."""
        return tuple(self._window), self._boost

    def stats(self, config: FingerprintConfig) -> dict:
        """The daemon's ``/stats`` keys once the tier has raised itself,
        so that an operator can pin it across restarts; else empty."""
        if not self._boost:
            return {}
        return {"decide_boost": self._boost,
                "decide_tier": self.cap(config, match_tiers(config))}


def escalate(run, caps: List[int], config: FingerprintConfig, *,
             decide: Optional[DecideTier] = None, first=None):
    """The capacity ladder of one query. Returns (host RawMatch, the
    capacity ``align_results`` reads).

    ``run(cap, blk=None, bounds=None, with_bounds=False)`` dispatches at
    tier ``cap`` (``blk``: None for ``expand_block``'s width, 0 for row
    by row; ``bounds``: an earlier search's, reused) and returns the host
    RawMatch, its clamp signal (the exact total on a flat store, the
    largest per-span count on a spanned one) and, ``with_bounds``, its
    search bounds, else None.

    The first dispatch is ``first``, (tier, RawMatch, clamp signal,
    bounds), made already by the caller (``recognize_clip``'s single
    pass), else one at the first tier, or on a big index (``decide``) at
    the decide tier, keeping its bounds; ``decide`` records whether it
    was decided. A clamp that is ``decided`` is accepted; else the query
    runs once more at the tier its clamp signal fits, with those bounds,
    and a blocked run-budget drop that no tier cures runs again row by
    row. The capacity returned is ``max(total_rows, cap)`` when every row
    voted or the clamp is decided (the answer reads as unaffected by
    capacity), else ``cap``, so ``align_results`` flags the overflow."""
    if first is not None:
        cap, raw, clamp, bounds = first
    elif decide is not None:
        cap = decide.cap(config, caps)
        raw, clamp, bounds = run(cap, with_bounds=True)
    else:
        cap = caps[0]
        raw, clamp, bounds = run(cap)
    clamped = clamp > cap or raw.n_dropped > 0
    accept = clamped and decided(raw, config)
    if decide is not None:
        decide.record(config, 1, int(clamped and not accept))
    if clamped and not accept:
        if clamp > cap and fit(caps, clamp) != cap:
            cap = fit(caps, clamp)
            raw, clamp, _ = run(cap, bounds=bounds)
        if raw.n_dropped > 0 and clamp <= cap:
            # more nonempty runs than expand_block_runs: no tier cures
            # that, the row-by-row expansion is the exact fallback
            raw, clamp, _ = run(cap, blk=0, bounds=bounds)
    if accept or (clamp <= cap and raw.n_dropped == 0):
        return raw, max(int(raw.total_rows), cap)
    return raw, cap
