"""Public API: ingest + recognition over a flat sorted index.

The port of ``shazam_tpu.api.SIA``'s main path, on an explicit device:

- ``SIA.ingest_arrays``: fingerprint decoded songs in padded batches on the
  device (``fingerprint_batch_fused``: K1 -> K2 -> K3 on CUDA), set-union
  each song's channels on the host, record it in the catalog, and merge
  its sorted run into the host index. A song becomes durable only after
  its hashes are merged (the reference's set_song_fingerprinted rule).
- ``SIA.recognize_clip``: one mono clip through fingerprint, on-device
  dedup, dense match and rank with a single read-back, falling back to
  ``recognize_samples`` (two passes, capacity tiers) when a static
  capacity overflowed and the clamped answer is not provably exact.
- ``save_index``/``load_index``: the JAX package's flat ``.npz`` format.

Not ported yet: the sparse/pruned vote ranks past
``config.sparse_vote_threshold`` (calls raise NotImplementedError there),
the device-resident and spanned stores, batch/serve, streaming, apriori.

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
from .match.lookup import match_query, raw_to_host
from .match.ondevice import recognize_on_device
from .match.prepare import prepare_query, q_frames_for_max_offset
from .ops.fingerprint import Fingerprints, fingerprint_batch_fused, union_pairs

MAX_PEAK_CAPACITY = 1 << 22


def _bucket_len(n: int, step: int = 1 << 18) -> int:
    """Round up to a multiple of 2^18 samples (~5.9 s @ 44.1 kHz)."""
    return -(-max(n, 1) // step) * step


class SIA:
    """Sistema Identificador de Audio on PyTorch.

    One object owns the config, the device, the song catalog (host
    sqlite) and the fingerprint index (host numpy, uploaded to the device
    on first query after each change).
    """

    def __init__(self, config: FingerprintConfig = DEFAULT_CONFIG,
                 catalog_path: str = ":memory:",
                 index: Optional[FingerprintIndex] = None, device="cpu"):
        self.config = config
        self.device = resolve_device(device)
        self.catalog = SongCatalog(catalog_path)
        self.catalog.delete_unfingerprinted()  # reference crash recovery
        self.index = index or build_index([], n_songs=0)
        self._max_off = 0

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
                fp = fingerprint_batch_fused(
                    x, nv, **self._fp_kwargs(peak_capacity=peak_cap))
                fp = Fingerprints(*(a.cpu() for a in fp))
                for row, ci in enumerate(ids):
                    si = chan_meta[ci][0]
                    one = Fingerprints(*(a[row] for a in fp))
                    if int(one.n_peaks) > peak_cap:
                        # peak-capacity overflow: the same kernel path
                        # again at twice the capacity, this channel alone
                        fp2 = fingerprint_batch_fused(
                            x[row:row + 1], nv[row:row + 1],
                            **self._fp_kwargs(peak_capacity=2 * peak_cap))
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

    def _delta_params_for(self, n_samples: int) -> Tuple[int, int]:
        """(delta_min, delta_range) of the vote histogram for a query."""
        n_frames = max(
            (n_samples - self.config.window_size) // self.config.hop + 1, 1)
        q_frames = q_frames_for_max_offset(n_frames - 1)
        return -q_frames, self._max_off + 2 * q_frames

    def _dense_n_songs(self, delta_range: int) -> int:
        n_songs = max(self.index.n_songs, 1)
        if n_songs * delta_range > self.config.sparse_vote_threshold:
            raise NotImplementedError(
                f"{n_songs} songs x {delta_range} delta bins exceeds "
                f"sparse_vote_threshold {self.config.sparse_vote_threshold}: "
                "the sparse vote matchers are not ported yet")
        return n_songs

    def _to_device(self, samples: np.ndarray):
        """(1, bucketed) f32 clip and its (1,) valid length on the device."""
        padded = np.zeros(_bucket_len(len(samples)), np.float32)
        padded[: len(samples)] = samples
        return (torch.from_numpy(padded).to(self.device)[None, :],
                torch.tensor([len(samples)], dtype=torch.int32,
                             device=self.device))

    def _fingerprint_channel(self, samples: np.ndarray) -> Fingerprints:
        """One channel's fingerprints at the smallest capacity that holds
        all its peaks (x2 per retry; every retry is the same kernel path)."""
        x, nv = self._to_device(samples)
        cap = self.config.peak_capacity
        while True:
            fp = fingerprint_batch_fused(
                x, nv, **self._fp_kwargs(peak_capacity=cap))
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
        """Dense match of prepared query pairs with capacity tiers; returns
        (host RawMatch, capacity actually used).

        The fast tier covers typical queries; a clamped result is kept when
        provably exact (``_decided``), else the query re-runs once at the
        tier its exact total fits.
        """
        index = self._ensure_device_index()
        delta_min, delta_range = self._delta_params_for(n_samples)
        n_songs = self._dense_n_songs(delta_range)
        q_dev = [torch.from_numpy(a.astype(np.int64)).to(self.device)
                 for a in (q.hi, q.lo, q.ex, q.t)]
        q_dev += [torch.from_numpy(a).to(self.device) for a in (q.valid, q.first)]
        caps = self._match_tiers()

        def run(cap):
            raw, _ = raw_to_host(match_query(
                index, *q_dev, n_songs=n_songs, delta_min=delta_min,
                delta_range=delta_range, match_capacity=cap,
                topn=topn or self.config.topn))
            return raw

        cap = caps[0]
        raw = run(cap)
        total = int(raw.total_rows)  # exact even when clamped
        if total > cap or raw.n_dropped > 0:
            if self._decided(raw):
                return raw, max(total, cap)
            fit = next((c for c in caps if c >= total), caps[-1])
            if fit != cap:
                cap = fit
                raw = run(cap)
        return raw, cap

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

    def recognize_clip(self, samples: np.ndarray,
                       topn: Optional[int] = None) -> Dict:
        """Lowest-latency recognition of one mono clip.

        Fingerprint, on-device dedup, match and rank run on the device
        with one read-back at the end; results equal
        ``recognize_samples([samples])``. A clip that overflows the peak
        capacity or the query lanes, or whose fast-tier match clamped
        without being provably decided, goes to ``recognize_samples``.
        """
        t0 = time.time()
        samples = np.asarray(samples)
        blen = _bucket_len(len(samples))
        if (blen - self.config.window_size) // self.config.hop + 1 > 1 << 16:
            # > ~51 min: the on-device dedup packs offsets into 16 bits
            return self.recognize_samples([samples], topn=topn)
        index = self._ensure_device_index()
        delta_min, delta_range = self._delta_params_for(len(samples))
        n_songs = self._dense_n_songs(delta_range)
        # dedup-sort + search cost is linear in query lanes: a 5 s clip
        # yields ~1-2K unique pairs
        q_cap = 2048 if len(samples) <= 6 * self.config.sample_rate else 4096
        one_cap = self.config.match_capacity_fast
        x, nv = self._to_device(samples)
        raw, n_pairs, n_peaks, n_hashes = recognize_on_device(
            x, nv, index, **self._fp_kwargs(), n_songs=n_songs,
            delta_min=delta_min, delta_range=delta_range,
            match_capacity=one_cap, topn=topn or self.config.topn,
            query_capacity=q_cap,
            sparse_threshold=self.config.sparse_vote_threshold)
        raw, (n_pairs, n_peaks, n_hashes) = raw_to_host(
            raw, n_pairs, n_peaks, n_hashes)
        device_time = time.time() - t0
        if (n_peaks > self.config.peak_capacity
                or ((raw.total_rows > one_cap or raw.n_dropped > 0)
                    and not self._decided(raw))
                or n_hashes > q_cap):
            return self.recognize_samples([samples], topn=topn)

        t0 = time.time()
        matched = align_results(
            raw, n_pairs, catalog=self.catalog, config=self.config,
            match_capacity=max(raw.total_rows, one_cap))
        align_time = time.time() - t0
        return {
            "results": matched.results,
            "total_matches": matched.total_matches,
            "overflowed": matched.overflowed,
            "partial_counts": matched.partial_counts,
            "input_hashes": n_pairs,
            "fingerprint_time": device_time,  # one device pass
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
