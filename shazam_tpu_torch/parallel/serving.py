"""Distributed serving: a sharded catalog engine over a process group.

The port of ``shazam_tpu/parallel/serving.py``: pick a sharding regime by
catalog size, hold this rank's shard on its device, and answer queries
prepared by ``match.prepare``.

Regime selection:
- catalogs whose dense vote histogram fits (n_songs * delta_range * 4 B
  <= dense_limit_bytes at ``max_q_frames``) use key-range shards with a
  summed vote histogram (balanced searches);
- larger catalogs use song shards with local voting and a gathered
  candidate merge (``bigcatalog.py``).

Process model. The JAX package has one controller that drives every
device of the mesh; here each rank is a process of its own, and every
match is a collective that all ranks enter with the same query. So at a
world size above 1 only rank 0 takes requests (``ShardedRecognizer``
fingerprints, and the daemon and stream sessions sit, there); before each
match rank 0 broadcasts the prepared query to the other ranks, which run
``ShardedRecognizer.follow``: a loop that receives each query and enters
the same match, until rank 0's ``close`` broadcasts a stop. This is the
counterpart of the single controller, not a feature of its own.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import DEFAULT_CONFIG, FingerprintConfig
from ..index.devmerge import packed_stride_for
from ..match.align import MatchResult, align_results
from ..match import tiers
from ..match.lookup import raw_to_host
from ..match.prepare import QueryPairs, prepare_query, q_frames_for_max_offset
from . import bigcatalog, sharded
from .mesh import make_mesh, rows_device_index

_STOP, _MATCH, _APRIORI = 0, 1, 2
_QUERY_COLUMNS = ("hi", "lo", "ex", "t", "valid", "first")


class ShardedCatalog:
    """A fingerprint index sharded over a mesh's ranks, one shard each.

    Every rank builds it from the same host index and keeps only its own
    rows on its device; ``match`` and ``match_apriori`` are collectives.
    """

    def __init__(
        self,
        index,
        mesh=None,
        config: FingerprintConfig = DEFAULT_CONFIG,
        catalog=None,
        dense_limit_bytes: int = 64 << 20,
        max_q_frames: int = 4096,
    ):
        self.mesh = mesh or make_mesh()
        self.config = config
        self.catalog = catalog
        # only the scalars: the host columns are not kept beside the shard
        self.n_songs = index.n_songs
        self.n_hashes = index.n_hashes
        self.max_offset = index.max_offset
        n_dev, rank = self.mesh.size, self.mesh.rank

        self._max_off = ((index.max_offset // 4096) + 1) * 4096

        # the key-range regime sums a dense (n_songs, delta_range) vote
        # histogram over the group; past `dense_limit_bytes` the by-song
        # regime (local voting over n_songs/n_dev songs and one small
        # gather) is cheaper. Budget at max_q_frames, the longest clip
        # match() accepts, not at the 1024 floor.
        self.max_q_frames = max_q_frames
        dense_bytes = (max(index.n_songs, 1)
                       * self._delta_range_for(max_q_frames) * 4)
        self.regime = "key_range" if dense_bytes <= dense_limit_bytes else "by_song"
        self._stride = packed_stride_for(index.max_offset, index.n_songs)

        # this rank's rows of the JAX package's layouts, taken straight
        # from the sorted index (its padding rows are the search view's
        # sentinels): a contiguous key range, or the songs s % n_dev ==
        # rank renumbered s // n_dev (the index is sorted by key, then
        # song and offset, so the selected rows are already in the
        # layout's order)
        cols = (index.key_hi, index.key_lo, index.key_ex, index.song_id,
                index.offset)
        if self.regime == "key_range":
            per = -(-max(index.n_hashes, 1) // n_dev)
            mine = slice(min(rank * per, index.n_hashes),
                         min((rank + 1) * per, index.n_hashes))
            rows = [c[mine] for c in cols]
        else:
            sel = index.song_id % n_dev == rank
            rows = [c[sel] for c in cols]
            rows[3] = rows[3] // n_dev
            self._n_local = -(-max(index.n_songs, 1) // n_dev)
        self._shards = rows_device_index(*rows, device=self.mesh.device)

    def _delta_range_for(self, q_frames: int) -> int:
        return self._max_off + 2 * q_frames

    def _q_frames_for(self, q: QueryPairs) -> int:
        """Power-of-two window covering the query's max frame offset: long
        queries must not drop low deltas (the reference handles any clip
        length, ``recognizer.py:289-338``)."""
        max_t = int(np.max(q.t[: q.n_pairs])) if q.n_pairs else 0
        return q_frames_for_max_offset(max_t)

    def _window(self, q: QueryPairs):
        q_frames = self._q_frames_for(q)
        if q_frames > self.max_q_frames:
            raise ValueError(
                f"query needs q_frames={q_frames} > max_q_frames="
                f"{self.max_q_frames}: the dense-histogram budget was "
                "sized at construction — raise max_q_frames there")
        return -q_frames, self._delta_range_for(q_frames)

    def match(self, q: QueryPairs, topn: Optional[int] = None) -> MatchResult:
        """Match prepared query pairs; returns reference-shaped results.

        A collective: every rank calls it with the same query. Match
        capacity escalates x4 up to ``config.match_capacity_max`` when a
        tier overflows (every row must vote, the policy of
        ``SIA._match_prepared``); each decision reads summed values only,
        so all ranks take the same branch.
        """
        topn = topn or self.config.topn
        delta_min, delta_range = self._window(q)
        args = [getattr(q, c) for c in _QUERY_COLUMNS]

        cap = self.config.match_capacity
        cap_max = self.config.match_capacity_max
        while True:
            raw = self._match_once(args, topn, delta_min, delta_range, cap)
            total = int(raw.total_rows)
            # judge against the regime's EFFECTIVE bound (per-shard caps
            # summed): a summed total above the nominal cap with every
            # shard under its own cap is exact, not an overflow
            if total <= self._effective_cap(cap) or cap >= cap_max:
                break
            if tiers.decided(raw, self.config):
                # provably-exact early accept. Key-range ranks the summed
                # histogram, so runner_votes is sound; the by-song regime
                # reports a zero margin and always escalates.
                return align_results(
                    raw, q.n_pairs, catalog=self.catalog,
                    config=self.config,
                    match_capacity=max(total, self._effective_cap(cap)))
            while self._effective_cap(cap) < total and cap < cap_max:
                cap *= 4
            cap = min(cap, cap_max)
        return align_results(raw, q.n_pairs, catalog=self.catalog,
                             config=self.config,
                             match_capacity=self._effective_cap(cap))

    def match_apriori(self, q: QueryPairs, topn: Optional[int] = None,
                      batch_size: int = 1024) -> MatchResult:
        """Partial-scan match with the reference's 2x-leader early exit
        (``recognizer_apriori.py:245-310``) on the key-range regime: each
        round is a local search per rank and one histogram sum, and the
        exit skips every later round's (``sharded.sharded_match_apriori``
        has the cost model). The by-song regime has no per-round sum to
        save and runs the full match.
        """
        if self.regime != "key_range":
            return self.match(q, topn=topn)
        topn = topn or self.config.topn
        delta_min, delta_range = self._window(q)
        cap = self.config.match_capacity
        raw, _used, clamped = sharded.sharded_match_apriori(
            self.mesh, self._shards, q, n_songs=max(self.n_songs, 1),
            delta_min=delta_min, delta_range=delta_range,
            match_capacity=cap, topn=topn, batch_size=batch_size)
        # a shard's expansion overflowed: the full match escalates (the
        # partial counts must come from complete rounds)
        if clamped:
            return self.match(q, topn=topn)
        return align_results(
            raw, q.n_pairs, catalog=self.catalog, config=self.config,
            match_capacity=max(int(raw.total_rows), self._effective_cap(cap)))

    def _effective_cap(self, match_capacity: int) -> int:
        eff = (sharded.effective_match_capacity
               if self.regime == "key_range"
               else bigcatalog.effective_match_capacity)
        return eff(match_capacity, self.mesh.size)

    def _match_once(self, args, topn, delta_min, delta_range, cap):
        """One dispatch at capacity ``cap``: a host RawMatch."""
        if self.regime == "key_range":
            raw = sharded.sharded_match_query(
                self.mesh, self._shards, *args,
                n_songs=max(self.n_songs, 1), delta_min=delta_min,
                delta_range=delta_range, match_capacity=cap, topn=topn)
        else:
            raw = bigcatalog.sharded_match_by_song(
                self.mesh, self._shards, self._n_local, self._stride, *args,
                delta_min=delta_min, delta_range=delta_range,
                match_capacity=cap, topn=topn)
        return raw_to_host(raw)[0]

    def stats(self) -> Dict:
        return {
            "regime": self.regime,
            "n_devices": self.mesh.size,
            "n_songs": self.n_songs,
            "n_hashes": self.n_hashes,
            "delta_range": self._delta_range_for(1024),
        }


class ShardedRecognizer:
    """SIA-shaped recognition over a ``ShardedCatalog``.

    The engine ``serve.RecognitionServer`` and ``stream.StreamRecognizer``
    consume (``recognize_samples`` / ``recognize_batch`` /
    ``match_prepared`` / ``get_metadata`` / ``config`` / ``catalog`` /
    ``device``), so the daemon and stream sessions can front a sharded
    catalog: fingerprinting runs an index-less ``SIA`` on the mesh's
    device (K1-K3 on the card), and every match spans the group, so
    ``recognize_batch`` is a loop.

    At a world size above 1 only rank 0 serves: each match first
    broadcasts the prepared query to the other ranks, which must be in
    ``follow()``, and ``close()`` releases them (see the module docstring).
    """

    def __init__(self, cat: ShardedCatalog):
        from ..api import SIA  # lazy: api is a higher layer

        self.cat = cat
        self.config = cat.config
        self.catalog = cat.catalog
        self.device = cat.mesh.device
        self._fp = SIA(config=cat.config, device=self.device)
        # one broadcast + match at a time: the daemon's threads and stream
        # sessions must not interleave collectives
        self._lock = threading.Lock()

    # ---- the serve.RecognitionServer engine surface --------------------
    def _live_n_hashes(self) -> int:
        return self.cat.n_hashes

    def get_metadata(self, track_id: int):
        return self.catalog.get_metadata(track_id) if self.catalog else None

    def recognize_samples(self, channels, topn: Optional[int] = None,
                          early_exit: bool = False,
                          q_pad_to: Optional[int] = None) -> Dict:
        if early_exit and self.cat.regime != "key_range":
            # loud fallback (as SIA): the by-song regime has no
            # partial-scan mode
            warnings.warn(
                "early_exit needs the key-range regime; running a "
                "full match (identical top-1, full-scan vote counts)",
                stacklevel=2)
            early_exit = False
        t0 = time.time()
        channels = [np.asarray(ch) for ch in channels if len(ch)]
        if not channels:
            return {
                "results": [], "total_matches": 0, "overflowed": False,
                "partial_counts": False,
                "input_hashes": 0, "fingerprint_time": 0.0,
                "query_time": 0.0, "align_time": 0.0, "total_time": 0.0,
            }
        fps = [self._fp._fingerprint_channel(ch) for ch in channels]
        q = prepare_query(fps)
        if q_pad_to is not None and q_pad_to > len(q.hi):
            q = prepare_query(fps, pad_to=q_pad_to)
        fingerprint_time = time.time() - t0

        t0 = time.time()
        matched = self._match(q, topn, _APRIORI if early_exit else _MATCH)
        query_time = time.time() - t0
        return {
            "results": matched.results,
            "total_matches": matched.total_matches,
            "overflowed": matched.overflowed,
            "partial_counts": matched.partial_counts,
            "input_hashes": q.n_pairs,
            "fingerprint_time": fingerprint_time,
            "query_time": query_time,
            "align_time": 0.0,
            "total_time": fingerprint_time + query_time,
        }

    def recognize_batch(self, clips, topn: Optional[int] = None,
                        pad_to_pow2: bool = False,
                        q_pad_to: Optional[int] = None):
        return [self.recognize_samples([c], topn=topn, q_pad_to=q_pad_to)
                for c in clips]

    def match_prepared(self, q, topn: Optional[int] = None):
        """Aligned match of an externally prepared query: the hook
        ``stream.StreamRecognizer`` uses, so continuous-listening sessions
        can front a sharded catalog like one-shot recognition does."""
        return self._match(q, topn, _MATCH)

    # ---- the process model ----------------------------------------------
    def _match(self, q: QueryPairs, topn: Optional[int], op: int):
        mesh = self.cat.mesh
        if mesh.rank != 0:
            raise RuntimeError(
                f"rank {mesh.rank} does not take requests: it must run "
                "follow() while rank 0 serves")
        with self._lock:
            if mesh.size > 1:
                self._send(op, topn, q)
            return self._run(op, q, topn)

    def _run(self, op: int, q: QueryPairs, topn: Optional[int]):
        if op == _APRIORI:
            return self.cat.match_apriori(q, topn=topn)
        return self.cat.match(q, topn=topn)

    def _bcast(self, t: torch.Tensor) -> torch.Tensor:
        mesh = self.cat.mesh
        dist.broadcast(t, src=dist.get_global_rank(mesh.group, 0),
                       group=mesh.group)
        return t

    def _send(self, op: int, topn: Optional[int], q) -> None:
        dev = self.cat.mesh.device
        cols = [] if q is None else [np.asarray(getattr(q, c)).astype(np.int64)
                                     for c in _QUERY_COLUMNS]
        n_lanes = len(cols[0]) if cols else 0
        self._bcast(torch.tensor(
            [op, topn or 0, q.n_pairs if q is not None else 0, n_lanes],
            dtype=torch.int64, device=dev))
        if n_lanes:
            self._bcast(torch.from_numpy(np.stack(cols)).to(dev))

    def _receive(self):
        dev = self.cat.mesh.device
        op, topn, n_pairs, n_lanes = self._bcast(
            torch.zeros(4, dtype=torch.int64, device=dev)).tolist()
        if op == _STOP:
            return op, None, None
        cols = self._bcast(torch.zeros((6, n_lanes), dtype=torch.int64,
                                       device=dev)).cpu().numpy()
        q = QueryPairs(*(c.astype(np.uint32) for c in cols[:4]),
                       cols[4].astype(bool), cols[5].astype(bool), n_pairs)
        return op, topn or None, q

    def follow(self) -> Dict:
        """Ranks other than 0: enter every match rank 0 broadcasts, until
        it stops them. Returns {"matches": n, "errors": n}; a match that
        raises raises on rank 0 too (every rank takes the same decisions
        before the first collective), where its caller sees it."""
        if self.cat.mesh.rank == 0:
            raise RuntimeError("rank 0 serves; the other ranks follow it")
        done = {"matches": 0, "errors": 0}
        while True:
            op, topn, q = self._receive()
            if op == _STOP:
                return done
            try:
                self._run(op, q, topn)
                done["matches"] += 1
            except Exception:  # noqa: BLE001 — rank 0 reports it
                done["errors"] += 1

    def close(self) -> None:
        """Rank 0: release the followers (a no-op at a world size of 1)."""
        mesh = self.cat.mesh
        if mesh.rank == 0 and mesh.size > 1:
            with self._lock:
                self._send(_STOP, None, None)
