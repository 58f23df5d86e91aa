"""Public API: ingest + recognition over a flat sorted index.

The port of ``shazam_tpu.api.SIA``'s main path, on an explicit device:

- ``SIA.ingest_arrays``: fingerprint decoded songs in padded batches on the
  device (``fingerprint_batch_fused``: K1 -> K2 -> K3 on CUDA, for the
  configurations ``_fused_ok`` admits; the plain ``fingerprint_batch`` on
  the same device for any other, as the JAX package does), set-union
  each song's channels on the host, record it in the catalog, and merge
  its sorted run into the host index. A song becomes durable only after
  its hashes are merged (the reference's set_song_fingerprinted rule).
- ``SIA.recognize_clip``: one mono clip through fingerprint, on-device
  dedup, match and rank with a single read-back, falling back to
  ``recognize_samples`` (two passes, capacity tiers) when a static
  capacity overflowed and the clamped answer is not provably exact.
- Past ``config.sparse_vote_threshold`` vote bins both paths take the
  sparse ranks (``config.vote_rank``), and on indexes of at least
  ``config.bounds_probe_min_rows`` rows the big-index escalation policy
  (``config.escalation_policy``): decided-first, one dispatch at the
  decide tier that keeps its search bounds for a fitted re-dispatch, or
  bounds-first, an exact-total probe and one fitted dispatch.
- ``save_index``/``load_index``: the JAX package's flat ``.npz`` format.

Not ported yet: the device-resident and spanned stores, the unique-view
search, batch/serve, streaming, apriori.

Shapes are bucketed (padded to the next 2^18-sample multiple), as in the
JAX package, so both packages see the same frame counts.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import DEFAULT_CONFIG, FingerprintConfig
from .device import resolve_device
from .index.catalog import SongCatalog
from .index.store import DeviceIndex, FingerprintIndex, build_index, merge_into
from .match.align import align_results
from .match.lookup import match_by_rank, query_total, raw_to_host
from .match.ondevice import fingerprint_probe_on_device, recognize_on_device
from .match.prepare import prepare_query, q_frames_for_max_offset
from .ops.fingerprint import (Fingerprints, fingerprint_batch,
                              fingerprint_batch_fused, union_pairs)

MAX_PEAK_CAPACITY = 1 << 22


def _fused_ok(config: FingerprintConfig) -> bool:
    """The kernels (K1 -> K2 -> K3) cover the reference configuration,
    whose window and peak radius they are compiled for; anything else
    takes the plain pipeline, with the same semantics."""
    return (
        config.window_size == 4096
        and config.window_size % config.hop == 0
        and config.peak_neighborhood_size == 10
        and config.amp_min > 0
    )


def _bucket_len(n: int, step: int = 1 << 18) -> int:
    """Round up to a multiple of 2^18 samples (~5.9 s @ 44.1 kHz)."""
    return -(-max(n, 1) // step) * step


class SIA:
    """Sistema Identificador de Audio on PyTorch.

    One object owns the config, the device, the song catalog (host
    sqlite) and the fingerprint index (host numpy, uploaded to the device
    on first query after each change). The device is the card unless
    ``device="cpu"`` asks for the CPU; without a card, ``"cuda"`` raises.
    """

    def __init__(self, config: FingerprintConfig = DEFAULT_CONFIG,
                 catalog_path: str = ":memory:",
                 index: Optional[FingerprintIndex] = None, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.catalog = SongCatalog(catalog_path)
        self.catalog.delete_unfingerprinted()  # reference crash recovery
        self.index = index or build_index([], n_songs=0)
        self._max_off = 0
        # self-tuning decide tier (config.decide_adapt_window): [attempts,
        # undecided] over the current window, and the accumulated boost
        self._decide_stats = [0, 0]
        self._decide_boost = 0

    @property
    def index(self) -> FingerprintIndex:
        return self._index

    @index.setter
    def index(self, ix: FingerprintIndex) -> None:
        self._index = ix
        self._device_index: Optional[DeviceIndex] = None

    # ------------------------------------------------------------------ #
    # ingest
    # ------------------------------------------------------------------ #
    def ingest_arrays(self, named_samples: Sequence[Tuple[str, np.ndarray]],
                      batch_size: int = 8,
                      song_peak_capacity: Optional[int] = None,
                      verbose: bool = False) -> Dict:
        """Ingest decoded mono songs: [(name, samples int16/f32)].

        Dedup (resume) uses the SHA-1 of the raw sample bytes as the
        "file" hash, as the JAX package does.
        """
        known = self.catalog.fingerprinted_file_hashes()
        pending = []
        skipped = 0
        for name, samples in named_samples:
            arr = np.asarray(samples)
            sha = hashlib.sha1(arr.tobytes()).hexdigest().upper()
            if sha in known:
                skipped += 1
                continue
            pending.append((name, sha, [arr]))
        return self._ingest_pending(
            pending, n_inputs=len(named_samples), skipped=skipped,
            batch_size=batch_size, song_peak_capacity=song_peak_capacity,
            verbose=verbose)

    def _ingest_pending(self, pending: List[Tuple[str, str, List[np.ndarray]]],
                        n_inputs: int, skipped: int, batch_size: int,
                        song_peak_capacity: Optional[int],
                        verbose: bool) -> Dict:
        t_start = time.time()
        peak_cap = song_peak_capacity or max(self.config.peak_capacity, 16384)
        stats = {"files": n_inputs, "skipped": skipped, "ingested": 0,
                 "hashes": 0, "overflowed": []}

        chan_meta: List[Tuple[int, int]] = []  # (song_idx, n_samples)
        chan_data: List[np.ndarray] = []
        for si, (_f, _sha, channels) in enumerate(pending):
            for ch in channels:
                chan_meta.append((si, len(ch)))
                chan_data.append(ch)
        by_bucket: Dict[int, List[int]] = {}
        for ci, ch in enumerate(chan_data):
            by_bucket.setdefault(_bucket_len(len(ch)), []).append(ci)

        song_fps: Dict[int, List[Fingerprints]] = {}
        for blen, chan_ids in sorted(by_bucket.items()):
            for base in range(0, len(chan_ids), batch_size):
                ids = chan_ids[base:base + batch_size]
                # int16 sources upload as int16 (half the bytes) and are
                # cast to f32 on the device, exactly
                all_int = all(chan_data[ci].dtype == np.int16 for ci in ids)
                batch = np.zeros((len(ids), blen),
                                 np.int16 if all_int else np.float32)
                n_valid = np.zeros(len(ids), np.int32)
                for row, ci in enumerate(ids):
                    batch[row, : len(chan_data[ci])] = chan_data[ci]
                    n_valid[row] = len(chan_data[ci])
                x = torch.from_numpy(batch).to(self.device).to(torch.float32)
                nv = torch.from_numpy(n_valid).to(self.device)
                fp = self._fingerprint(x, nv, peak_cap)
                fp = Fingerprints(*(a.cpu() for a in fp))
                for row, ci in enumerate(ids):
                    si = chan_meta[ci][0]
                    one = Fingerprints(*(a[row] for a in fp))
                    if int(one.n_peaks) > peak_cap:
                        # peak-capacity overflow: the same path
                        # again at twice the capacity, this channel alone
                        fp2 = self._fingerprint(
                            x[row:row + 1], nv[row:row + 1], 2 * peak_cap)
                        one = Fingerprints(*(a[0].cpu() for a in fp2))
                        stats["fallbacks"] = stats.get("fallbacks", 0) + 1
                        if int(one.n_peaks) > 2 * peak_cap:
                            stats["overflowed"].append(pending[si][0])
                    song_fps.setdefault(si, []).append(one)

        new_entries = []
        for si, (f, sha, _channels) in enumerate(pending):
            hi, lo, ex, t1 = union_pairs(song_fps.get(si, []))
            song_name = os.path.splitext(os.path.basename(f))[0]
            sid = self.catalog.insert_song(song_name, sha, int(hi.size))
            new_entries.append((sid, hi, lo, ex, t1))
            stats["ingested"] += 1
            stats["hashes"] += int(hi.size)
            if verbose:
                print(f"ingested {song_name}: {hi.size} hashes (song_id={sid})")

        if new_entries:
            n_songs = max(e[0] for e in new_entries) + 1
            addition = build_index(new_entries,
                                   n_songs=max(n_songs, self.index.n_songs))
            self.index = merge_into(self.index, addition)
            for sid, *_rest in new_entries:
                self.catalog.set_song_fingerprinted(sid)

        stats["seconds"] = time.time() - t_start
        return stats

    # ------------------------------------------------------------------ #
    # recognition
    # ------------------------------------------------------------------ #
    def _ensure_device_index(self) -> DeviceIndex:
        if self._device_index is None:
            self._device_index = self.index.device_arrays(self.device)
            # histogram window base: covers the longest song, rounded up
            # so catalog growth keeps the same window
            self._max_off = ((self.index.max_offset // 4096) + 1) * 4096
        return self._device_index

    def _fp_kwargs(self, peak_capacity: Optional[int] = None) -> Dict:
        c = self.config
        return dict(
            fs=c.sample_rate, wsize=c.window_size, hop=c.hop,
            amp_min=c.amp_min, radius=c.peak_neighborhood_size,
            fan_value=c.fan_value, min_dt=c.min_hash_time_delta,
            max_dt=c.max_hash_time_delta,
            peak_capacity=(c.peak_capacity if peak_capacity is None
                           else peak_capacity),
        )

    def _fingerprint(self, x: torch.Tensor, nv: torch.Tensor,
                     peak_capacity: int) -> Fingerprints:
        """Fingerprints of a (B, N) batch: the kernels where ``_fused_ok``
        admits the config, the plain pipeline otherwise."""
        fp_fn = (fingerprint_batch_fused if _fused_ok(self.config)
                 else fingerprint_batch)
        return fp_fn(x, nv, **self._fp_kwargs(peak_capacity=peak_capacity))

    def _delta_params_for(self, n_samples: int) -> Tuple[int, int]:
        """(delta_min, delta_range) of the vote histogram for a query."""
        n_frames = max(
            (n_samples - self.config.window_size) // self.config.hop + 1, 1)
        q_frames = q_frames_for_max_offset(n_frames - 1)
        return -q_frames, self._max_off + 2 * q_frames

    def _n_songs(self) -> int:
        return max(self.index.n_songs, 1)

    def _to_device(self, samples: np.ndarray):
        """(1, bucketed) f32 clip and its (1,) valid length on the device."""
        padded = np.zeros(_bucket_len(len(samples)), np.float32)
        padded[: len(samples)] = samples
        return (torch.from_numpy(padded).to(self.device)[None, :],
                torch.tensor([len(samples)], dtype=torch.int32,
                             device=self.device))

    def _fingerprint_channel(self, samples: np.ndarray) -> Fingerprints:
        """One channel's fingerprints at the smallest capacity that holds
        all its peaks (x2 per retry; every retry takes the same path)."""
        x, nv = self._to_device(samples)
        cap = self.config.peak_capacity
        while True:
            fp = self._fingerprint(x, nv, cap)
            n = int(fp.n_peaks[0])
            if n <= cap or cap >= MAX_PEAK_CAPACITY:
                return Fingerprints(*(a[0] for a in fp))
            while cap < n and cap < MAX_PEAK_CAPACITY:
                cap *= 2

    def recognize_samples(self, channels: Sequence[np.ndarray],
                          topn: Optional[int] = None) -> Dict:
        """Recognize decoded audio channels (two passes: fingerprint, then
        host dedup + match with capacity tiers).

        Returns the reference's result schema plus fingerprint/query/align
        stage times (``recognizer_test.py:607-610``).
        """
        t0 = time.time()
        channels = [np.asarray(ch) for ch in channels if len(ch)]
        if not channels:
            return {
                "results": [], "total_matches": 0, "overflowed": False,
                "partial_counts": False, "input_hashes": 0,
                "fingerprint_time": 0.0, "query_time": 0.0,
                "align_time": 0.0, "total_time": 0.0,
            }
        fps = [self._fingerprint_channel(ch) for ch in channels]
        q = prepare_query(fps)
        fingerprint_time = time.time() - t0

        t0 = time.time()
        raw, cap_used = self._match_prepared(
            q, n_samples=max(len(ch) for ch in channels), topn=topn)
        query_time = time.time() - t0

        t0 = time.time()
        matched = align_results(raw, q.n_pairs, catalog=self.catalog,
                                config=self.config, match_capacity=cap_used)
        align_time = time.time() - t0
        return {
            "results": matched.results,
            "total_matches": matched.total_matches,
            "overflowed": matched.overflowed,
            "partial_counts": matched.partial_counts,
            "input_hashes": q.n_pairs,
            "fingerprint_time": fingerprint_time,
            "query_time": query_time,
            "align_time": align_time,
            "total_time": fingerprint_time + query_time + align_time,
        }

    def _match_prepared(self, q, n_samples: int, topn: Optional[int] = None):
        """Match prepared query pairs with capacity tiers; returns (host
        RawMatch, capacity actually used).

        The fast tier covers typical queries; a clamped result is kept when
        provably exact (``_decided``), else the query re-runs once at the
        tier its exact total fits. Past ``sparse_vote_threshold`` the
        sparse ranks replace the dense histogram, and on big indexes
        (``bounds_probe_min_rows``) the escalation policy decides the
        first dispatch: decided-first runs at the decide tier and keeps its
        search bounds, bounds-first probes the exact total and dispatches
        once at the tier it fits. Either way a re-dispatch reuses the
        bounds instead of searching again.
        """
        index = self._ensure_device_index()
        delta_min, delta_range = self._delta_params_for(n_samples)
        n_songs = self._n_songs()
        q_dev = [torch.from_numpy(a.astype(np.int64)).to(self.device)
                 for a in (q.hi, q.lo, q.ex, q.t)]
        q_dev += [torch.from_numpy(a).to(self.device) for a in (q.valid, q.first)]
        caps = self._match_tiers()
        use_sparse = n_songs * delta_range > self.config.sparse_vote_threshold
        eblk = self._expand_block_for(index)
        bounds = None   # an earlier search's (lb, ub), on the device

        def run(cap, blk=None, with_bounds=False):
            out = match_by_rank(
                index, *q_dev,
                rank=self._rank_for(cap) if use_sparse else "dense",
                n_songs=n_songs, delta_min=delta_min,
                delta_range=delta_range, match_capacity=cap,
                topn=topn or self.config.topn,
                n_candidates=self.config.rank_candidates,
                expand_block=(self._eblk_for_cap(eblk, cap) if blk is None
                              else blk),
                expand_runs=self.config.expand_block_runs, bounds=bounds,
                with_bounds=with_bounds)
            if with_bounds:
                raw, lb, ub = out
                return raw_to_host(raw)[0], (lb, ub)
            return raw_to_host(out)[0]

        total = None
        big = use_sparse and self._big_index(index)
        if big and self._decide_first():
            cap = self._decide_cap(caps)
            raw, bounds = run(cap, with_bounds=True)
            clamped = raw.total_rows > cap or raw.n_dropped > 0
            self._decide_record(1, int(clamped and not self._decided(raw)))
        elif big:
            total_d, lb, ub = query_total(index, q_dev[0], q_dev[1],
                                          q_dev[2], q_dev[4], with_bounds=True)
            total = int(total_d)
            bounds = (lb, ub)
            cap = next((c for c in caps if c >= total), caps[-1])
            raw = run(cap)
        else:
            cap = caps[0]
            raw = run(cap)
        if total is None:
            total = int(raw.total_rows)  # exact even when clamped
        if total > cap or raw.n_dropped > 0:
            # n_dropped > 0 with total <= cap comes only from the blocked
            # expansion's nonempty-run budget (expand_block_runs)
            if self._decided(raw):
                return raw, max(total, cap)
            if total > cap:
                fit = next((c for c in caps if c >= total), caps[-1])
                if fit != cap:      # not already at the last tier
                    cap = fit
                    raw = run(cap)
            if eblk and raw.n_dropped > 0 and total <= cap:
                # more nonempty runs than expand_block_runs: no tier cures
                # that, the row-by-row expansion is the exact fallback
                raw = run(cap, blk=0)
        return raw, cap

    def _big_index(self, index: DeviceIndex) -> bool:
        """The index is at least ``bounds_probe_min_rows`` rows (0: never),
        where the escalation policy chooses the first dispatch."""
        rows = self.config.bounds_probe_min_rows
        return bool(rows) and self._index_rows(index) >= rows

    def _decide_first(self) -> bool:
        pol = self.config.escalation_policy
        return pol == "decide" or (pol == "auto"
                                   and self.config.decision_escalation)

    def _rank_for(self, cap: int) -> str:
        """config.vote_rank for a capacity tier: "auto" is sort at the fast
        tier and scan above it. (The JAX package's "auto" takes the pruned
        rank at the fast tier, a TPU choice; every rank gives the same
        answer, and on the H100 the pruned rank's eager form runs the sort
        rank as well, for its fallback.)"""
        v = self.config.vote_rank
        if v == "auto":
            return ("sort" if cap <= self.config.match_capacity_fast
                    else "scan")
        return v

    def _eblk_for_cap(self, eblk: int, cap: int) -> int:
        """Blocked expansion only from expand_block_min_capacity on: below
        it the run budget's 2 * expand_block_runs * B slots outweigh the
        tier's own capacity."""
        return eblk if cap >= self.config.expand_block_min_capacity else 0

    @staticmethod
    def _index_rows(index: DeviceIndex) -> int:
        """Row capacity of the device index (real and padding rows)."""
        return int(index.payload.shape[0])

    def _expand_block_for(self, index: DeviceIndex) -> int:
        """config.expand_block where the device rows split into whole
        blocks (they are padded to a multiple of 512), else 0."""
        blk = self.config.expand_block
        return blk if blk and self._index_rows(index) % blk == 0 else 0

    def _decided(self, raw) -> bool:
        """True iff a capacity-clamped host RawMatch is provably the full
        answer: every excluded run adds <= 1 vote to any (song, delta)
        bin, so a top-1 margin over the strongest challenger larger than
        the excluded-run count cannot be overturned."""
        if not self.config.decision_escalation:
            return False
        return (int(raw.top_votes[0]) - int(raw.runner_votes)
                > int(raw.n_dropped))

    def _match_tiers(self) -> List[int]:
        caps = [self.config.match_capacity_fast, self.config.match_capacity]
        if caps[0] >= caps[1]:
            caps = caps[1:]
        while caps[-1] < self.config.match_capacity_max:
            step = 2 if caps[-1] >= self.config.match_tier_fine_from else 4
            caps.append(min(caps[-1] * step, self.config.match_capacity_max))
        return caps

    def _decide_cap(self, caps: List[int]) -> int:
        """The decided-first dispatch tier: config.decide_capacity (0: the
        match_capacity tier) raised by the boost ``_decide_record`` has
        accumulated, never past decide_adapt_max unless asked for."""
        want = self.config.decide_capacity or self.config.match_capacity
        idx = next((i for i, c in enumerate(caps) if c >= want),
                   len(caps) - 1)
        idx = min(idx + self._decide_boost, len(caps) - 1)
        while (idx > 0 and caps[idx] > self.config.decide_adapt_max
               and caps[idx] > want):
            idx -= 1
        return caps[idx]

    def _decide_record(self, attempts: int, undecided: int) -> None:
        """Self-tuning decide tier: over each decide_adapt_window of
        decided-first dispatches, an undecided share above 1/2 raises the
        tier one step (corpora with long hyper-common runs need a larger
        run budget before margins certify)."""
        w = self.config.decide_adapt_window
        if not w:
            return
        self._decide_stats[0] += attempts
        self._decide_stats[1] += undecided
        if self._decide_stats[0] >= w:
            a, u = self._decide_stats
            self._decide_stats = [0, 0]
            if u * 2 > a:
                self._decide_boost += 1

    def recognize_clip(self, samples: np.ndarray,
                       topn: Optional[int] = None) -> Dict:
        """Lowest-latency recognition of one mono clip.

        Fingerprint, on-device dedup, match and rank run on the device
        with one read-back at the end; results equal
        ``recognize_samples([samples])``. A clip that overflows the peak
        capacity or the query lanes, or whose match clamped without being
        provably decided, goes to ``recognize_samples``. On a big index
        (sparse ranks and ``bounds_probe_min_rows``) decided-first runs
        the same single pass at the decide tier; bounds-first goes to
        ``_recognize_clip_probed``.
        """
        t0 = time.time()
        samples = np.asarray(samples)
        blen = _bucket_len(len(samples))
        if (blen - self.config.window_size) // self.config.hop + 1 > 1 << 16:
            # > ~51 min: the on-device dedup packs offsets into 16 bits
            return self.recognize_samples([samples], topn=topn)
        index = self._ensure_device_index()
        delta_min, delta_range = self._delta_params_for(len(samples))
        n_songs = self._n_songs()
        # dedup-sort + search cost is linear in query lanes: a 5 s clip
        # yields ~1-2K unique pairs
        q_cap = 2048 if len(samples) <= 6 * self.config.sample_rate else 4096
        one_cap = self.config.match_capacity_fast
        if (n_songs * delta_range > self.config.sparse_vote_threshold
                and self._big_index(index)):
            if not self._decide_first():
                return self._recognize_clip_probed(
                    samples, index, n_songs=n_songs, delta_min=delta_min,
                    delta_range=delta_range, q_cap=q_cap, topn=topn, t0=t0)
            one_cap = self._decide_cap(self._match_tiers())
        x, nv = self._to_device(samples)
        raw, n_pairs, n_peaks, n_hashes = recognize_on_device(
            x, nv, index, **self._fp_kwargs(),
            use_fused=_fused_ok(self.config), n_songs=n_songs,
            delta_min=delta_min, delta_range=delta_range,
            match_capacity=one_cap, topn=topn or self.config.topn,
            query_capacity=q_cap,
            rank_candidates=self.config.rank_candidates,
            sparse_threshold=self.config.sparse_vote_threshold,
            vote_rank=self._rank_for(one_cap),
            expand_block=self._eblk_for_cap(self._expand_block_for(index),
                                            one_cap),
            expand_runs=self.config.expand_block_runs)
        raw, (n_pairs, n_peaks, n_hashes) = raw_to_host(
            raw, n_pairs, n_peaks, n_hashes)
        device_time = time.time() - t0
        if (n_peaks > self.config.peak_capacity
                or ((raw.total_rows > one_cap or raw.n_dropped > 0)
                    and not self._decided(raw))
                or n_hashes > q_cap):
            return self.recognize_samples([samples], topn=topn)
        return self._clip_result(raw, n_pairs, max(raw.total_rows, one_cap),
                                 device_time)

    def _recognize_clip_probed(self, samples: np.ndarray,
                               index: DeviceIndex, *, n_songs: int,
                               delta_min: int, delta_range: int, q_cap: int,
                               topn: Optional[int], t0: float) -> Dict:
        """Bounds-first recognition of one clip on a big index: fingerprint
        + dedup + exact-total probe, one read-back, then one match at the
        tier the total fits, on the query still on the device and with the
        probe's search bounds."""
        x, nv = self._to_device(samples)
        q_dev, *counts, lb, ub = fingerprint_probe_on_device(
            x, nv, index, **self._fp_kwargs(),
            use_fused=_fused_ok(self.config), query_capacity=q_cap)
        counts = torch.stack([c.to(torch.int64) for c in counts]).cpu()
        n_pairs, n_peaks, n_hashes, total = (int(v) for v in counts)
        if n_peaks > self.config.peak_capacity or n_hashes > q_cap:
            # capacity overflow (peaks or query lanes): the two-pass path
            # escalates those capacities
            return self.recognize_samples([samples], topn=topn)

        caps = self._match_tiers()
        cap = next((c for c in caps if c >= total), caps[-1])
        eblk = self._expand_block_for(index)

        def run(blk):
            # n_candidates=0: "pruned" takes the sort rank here, as in the
            # JAX package's probed path
            return raw_to_host(match_by_rank(
                index, *q_dev, rank=self._rank_for(cap), n_songs=n_songs,
                delta_min=delta_min, delta_range=delta_range,
                match_capacity=cap, topn=topn or self.config.topn,
                n_candidates=0, expand_block=blk,
                expand_runs=self.config.expand_block_runs,
                bounds=(lb, ub)))[0]

        raw = run(self._eblk_for_cap(eblk, cap))
        if raw.n_dropped > 0 and not self._decided(raw) and total <= cap:
            # a run-budget drop: the row-by-row expansion is the exact
            # fallback (total > cap is a clamp at the last tier, which the
            # align capacity below reports)
            raw = run(0)
        device_time = time.time() - t0
        # max(total, cap) reads "unaffected by capacity": only for an exact
        # (or provably decided) result; a last-tier clamp keeps cap so
        # align_results flags the overflow
        exact = total <= cap and raw.n_dropped == 0
        align_cap = max(total, cap) if exact or self._decided(raw) else cap
        return self._clip_result(raw, n_pairs, align_cap, device_time)

    def _clip_result(self, raw, n_pairs: int, align_cap: int,
                     device_time: float) -> Dict:
        t0 = time.time()
        matched = align_results(raw, n_pairs, catalog=self.catalog,
                                config=self.config, match_capacity=align_cap)
        align_time = time.time() - t0
        return {
            "results": matched.results,
            "total_matches": matched.total_matches,
            "overflowed": matched.overflowed,
            "partial_counts": matched.partial_counts,
            "input_hashes": n_pairs,
            "fingerprint_time": device_time,  # the device pass(es)
            "query_time": 0.0,
            "align_time": align_time,
            "total_time": device_time + align_time,
        }

    # ------------------------------------------------------------------ #
    # catalog maintenance and persistence
    # ------------------------------------------------------------------ #
    def get_metadata(self, track_id: int):
        return self.catalog.get_metadata(track_id)

    def delete_songs(self, song_ids: Sequence[int]) -> int:
        """Remove songs from the catalog AND the index (reference
        ``DELETE_SONGS`` + ON DELETE CASCADE); returns hash rows removed."""
        ids = set(int(s) for s in song_ids)
        self.catalog.delete_songs(ids)
        return self._drop_song_rows(ids)

    def _drop_song_rows(self, ids) -> int:
        ix = self.index
        keep = ~np.isin(ix.song_id, list(ids))
        removed = int((~keep).sum())
        if removed:
            offset = ix.offset[keep]
            self.index = FingerprintIndex(
                ix.key_hi[keep], ix.key_lo[keep], ix.key_ex[keep],
                ix.song_id[keep], offset, n_songs=ix.n_songs,
                max_offset=int(offset.max()) if len(offset) else 0)
        return removed

    def save_index(self, path: str) -> None:
        """Persist the index as the flat sorted ``.npz`` both packages read."""
        self.index.save(path)

    def load_index(self, path: str) -> None:
        """Load a flat ``.npz`` index, then restore the catalog invariant
        (fingerprinted flag <=> hash rows present)."""
        self.index = FingerprintIndex.load(path)
        self._reconcile_catalog()

    def _reconcile_catalog(self) -> None:
        """Purge catalog songs without index rows (a crash between the
        sqlite flag and an index save) and drop index rows of songs the
        catalog no longer has (an unsaved delete)."""
        ids_present = (set(np.unique(self.index.song_id).tolist())
                       if self.index.n_hashes else set())
        catalog_ids = {d["song_id"] for d in self.catalog.get_songs()}
        missing = [sid for sid in catalog_ids if sid not in ids_present]
        if missing:
            self.catalog.delete_songs(missing)
        orphans = ids_present - catalog_ids
        if orphans:
            self._drop_song_rows(orphans)
