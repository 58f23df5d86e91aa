"""Public API: ingest + recognition over a flat sorted index.

The port of ``shazam_tpu.api.SIA``'s main path, on an explicit device:

- ``SIA.ingest_arrays``: fingerprint decoded songs in padded batches on the
  device (``fingerprint_batch_fused``: K1 -> K2 -> K3 on CUDA, for the
  configurations ``_fused_ok`` admits; the plain ``fingerprint_batch`` on
  the same device for any other, as the JAX package does), set-union
  each song's channels on the host, record it in the catalog, and merge
  its sorted run into the host index. A song becomes durable only after
  its hashes are merged (the reference's set_song_fingerprinted rule).
- ``SIA.recognize_clip``: one mono or stereo clip through fingerprint,
  on-device dedup of every lane the fingerprint holds, match and rank
  with a single read-back; a clamped answer that is not provably exact
  goes on through the capacity tiers from the query still on the device,
  and a peak overflow (or a clip past the dedup's 16-bit offsets) falls
  back to ``recognize_samples`` (two passes, capacity tiers).
- Every dispatch decision (the tiers, the rank, the blocked expansion,
  the big-index test, the margin test, the decide tier) and the one
  capacity ladder live in ``match/tiers.py``. Past
  ``config.sparse_vote_threshold`` vote bins every path takes the sparse
  sort or scan rank (``config.vote_rank``), and on indexes of at least
  ``config.bounds_probe_min_rows`` rows decide-first escalation: one
  dispatch at the decide tier that keeps its search bounds for a fitted
  re-dispatch.
- ``SIA.ingest_files`` / ``ingest_directory``: streaming ingest of audio
  files. A header probe plans (file, channel) rows by bucket; the host
  decodes batch k+1 while the device fingerprints batch k; a song is
  recorded when its last channel comes back, and finished songs merge
  into the index every ``merge_chunk_hashes`` hashes. Files at another
  sample rate are resampled to ``config.sample_rate`` (``resample=True``)
  or rejected. ``ingest_channels`` ingests one song from decoded
  channels.
- ``SIA.recognize_file``: decode (and resample), then
  ``recognize_samples``.
- ``SIA.recognize_batch`` = ``prepare_batch`` (all clips fingerprinted as
  one batch) + ``match_prepared_batch`` (one batched match dispatch,
  ``match/batched.py``, then per-clip escalation and alignment): per-clip
  results equal ``recognize_samples`` on each clip alone.
- ``save_index``/``load_index``: the JAX package's flat ``.npz`` format;
  ``load_index`` also reads its span-wise files, flattened on the host.
- ``SIA(device_span_rows=N)``: the index in ``index/devmerge.
  SpannedDeviceStore``, spans of N rows on the device; every match
  searches all spans (the ladder of ``_match_tiered``,
  ``_recognize_clip_spanned``, the batch through
  ``match_queries_batched_spanned``); ``consolidate_index`` stacks the
  spans into the serving layout (closed to ingest); ``save_index`` /
  ``load_index(stacked=...)`` write and read the span-wise file.
- ``recognize_samples`` / ``recognize_file(early_exit=True)``: the
  reference's apriori early exit (``match/apriori.py``) under
  ``sparse_vote_threshold``; past it, or on a spanned SIA, a warning and
  the full match, as in the JAX package.
- ``SIA(device_resident=True)``: the index lives in a device store
  (``index/devmerge.DeviceIndex``) that absorbs every addition on the
  device, so ingest makes no host merge and queries no re-upload; the
  host index is synced from the store only when read (save, stats,
  deletes). ``SIA.ingest_device_batch`` ingests a (B, N) batch already on
  the device: fingerprints, the sorted deduped run
  (``index/devingest.py``) and the merge never leave it.

The serving daemon (``serve.py``) and streaming recognition
(``stream.py``, ``stream_device.py``) sit on top of this class. Not ported
yet: the unique-view search and the bucket head.

Shapes are bucketed (padded to the next 2^18-sample multiple), as in the
JAX package, so both packages see the same frame counts.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
import warnings
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .audio.io import find_files, probe, read, unique_file_hash
from .audio.resample import resample_channels
from .config import DEFAULT_CONFIG, FingerprintConfig
from .device import resolve_device
from .index.catalog import SongCatalog
from .index.devingest import device_sorted_run
from .index.devmerge import (DeviceIndex as DeviceStore, SpannedDeviceStore,
                             capacity_for, is_spanned_file, load_spanned_flat,
                             packed_stride_for)
from .index.store import DeviceIndex, FingerprintIndex, build_index, merge_into
from .match.align import align_results
from .match.apriori import match_query_apriori_ondevice
from .match.batched import (batched_raw_to_host, match_queries_batched,
                            match_queries_batched_spanned)
from .match.lookup import (RawMatch, _is_stacked, match_by_rank,
                           match_query_sparse_spanned, raw_to_host)
from .match import tiers
from .match.ondevice import recognize_on_device, recognize_on_device_spanned
from .match.prepare import QueryPairs, prepare_query, q_frames_for_max_offset
from .ops.fingerprint import (Fingerprints, fingerprint_batch,
                              fingerprint_batch_fused, fused_takes,
                              union_pairs)
from .profiling import annotate, span, spanned

MAX_PEAK_CAPACITY = 1 << 22
# channels recognize_clip fingerprints in its one pass (stereo)
MAX_CLIP_CHANNELS = 2
QUERY_COLUMNS = ("hi", "lo", "ex", "t", "valid", "first")
# the JAX package's 4 GB guard of a whole-batch re-dispatch (its hashed
# candidate table plus six expansion arrays per clip), kept so that both
# packages make the same dispatch decisions
BATCH_GUARD_BYTES = 4 << 30


class _PreparedBatch(NamedTuple):
    """``SIA.prepare_batch`` output, host-resident: everything
    ``match_prepared_batch`` needs."""

    clips: List[np.ndarray]        # original clips (retry paths need them)
    queries: List[QueryPairs]      # per-row queries (align needs n_pairs)
    stack: Dict[str, np.ndarray]   # padded (B, q_cap) query columns
    peak_over: set                 # clip ids whose peaks overflowed
    topn: Optional[int]
    match_capacity: Optional[int]  # base-tier override
    fingerprint_time: float


def _start_download(fp: Fingerprints):
    """Start one device->host copy of a batch's fingerprints. On the card
    it lands in pinned memory behind the work already queued, and the
    host goes on; ``_finish_download`` waits for it."""
    bsz, lanes = fp.hi.shape
    flat = torch.cat([
        torch.stack([fp.hi, fp.lo, fp.ex, fp.t1,
                     fp.valid.to(torch.int64)]).reshape(-1),
        fp.n_peaks.to(torch.int64)])
    if flat.device.type != "cuda":
        return flat, None, (bsz, lanes)
    host = torch.empty(flat.shape, dtype=torch.int64, pin_memory=True)
    host.copy_(flat, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done, (bsz, lanes)


@spanned("sia.readback")
def _finish_download(pending) -> Fingerprints:
    """The host Fingerprints of a ``_start_download``."""
    host, done, (bsz, lanes) = pending
    if done is not None:
        done.synchronize()
    cols = host[: 5 * bsz * lanes].view(5, bsz, lanes)
    return Fingerprints(cols[0], cols[1], cols[2], cols[3], cols[4].bool(),
                        host[5 * bsz * lanes:].to(torch.int32))


def _pad_rows(channels: Sequence[np.ndarray], blen: int):
    """(len(channels), blen) zero-padded batch and valid lengths: int16
    when every channel is int16 (half the upload; the cast to float32 on
    the device is exact), else float32."""
    all_int = all(ch.dtype == np.int16 for ch in channels)
    batch = np.zeros((len(channels), blen), np.int16 if all_int else np.float32)
    n_valid = np.zeros(len(channels), np.int32)
    for row, ch in enumerate(channels):
        batch[row, : len(ch)] = ch
        n_valid[row] = len(ch)
    return batch, n_valid


def _fused_ok(config: FingerprintConfig) -> bool:
    """The kernels (K1 -> K2 -> K3) cover the reference configuration,
    whose window and peak radius they are compiled for; anything else
    takes the plain pipeline, with the same semantics."""
    return fused_takes(config.window_size, config.hop,
                       config.peak_neighborhood_size, config.amp_min)


def _bucket_len(n: int, step: int = 1 << 18) -> int:
    """Round up to a multiple of 2^18 samples (~5.9 s @ 44.1 kHz)."""
    return -(-max(n, 1) // step) * step


class SIA:
    """Sistema Identificador de Audio on PyTorch.

    One object owns the config, the device, the song catalog (host
    sqlite) and the fingerprint index (host numpy, uploaded to the device
    on first query after each change). The device is the card unless
    ``device="cpu"`` asks for the CPU; without a card, ``"cuda"`` raises.
    Audio files at another sample rate are polyphase-resampled to
    ``config.sample_rate`` (``resample=True``) or rejected with a
    ``ValueError`` (``resample=False``).

    ``device_resident=True`` keeps the index in a device store
    (``index/devmerge.DeviceIndex``) that absorbs every ingest on the
    device; ``device_reserve_hashes`` preallocates its capacity. The host
    index is then synced from the store when read.
    ``device_span_rows=N`` implies it and makes the SIA spanned, as in the
    JAX package: the store is a ``SpannedDeviceStore`` of N-row spans,
    built on first device use (spans under 4,096 rows and catalogs whose
    payload does not pack into uint32 are refused then), ``save_index``
    writes and ``load_index`` reads its span-wise files, and
    ``consolidate_index`` stacks it for serving.

    The parameters are the JAX package's, in its order; ``device`` is the
    port's own.
    """

    def __init__(self, config: FingerprintConfig = DEFAULT_CONFIG,
                 catalog_path: str = ":memory:",
                 index: Optional[FingerprintIndex] = None,
                 device_resident: bool = False,
                 device_reserve_hashes: int = 0, device_span_rows: int = 0,
                 resample: bool = True, *, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.resample = resample
        self.catalog = SongCatalog(catalog_path)
        self.catalog.delete_unfingerprinted()  # reference crash recovery
        self.device_resident = device_resident or bool(device_span_rows)
        self.device_reserve_hashes = device_reserve_hashes
        self.device_span_rows = device_span_rows
        self.index = index or build_index([], n_songs=0)
        self._max_off = 0
        # the decide tier of decide-first dispatches and its self-tuning
        # state (config.decide_adapt_window)
        self.decide = tiers.DecideTier()
        # the serving daemon's batcher and match threads may both reach
        # the first query after a change (one of them uploads the index),
        # and a device store's merges and search-view rebuilds must not
        # interleave: both happen under this lock (reentrant: the index
        # property syncs under it, inside sections that hold it)
        self._upload_lock = threading.RLock()

    @property
    def index(self) -> FingerprintIndex:
        """The host index; a device-resident SIA syncs it from the store
        when an ingest has changed the store since the last read."""
        if self._host_stale:
            with self._upload_lock:
                if self._host_stale:
                    self._index = self._dev_store.to_host()
                    self._host_stale = False
        return self._index

    @index.setter
    def index(self, ix: FingerprintIndex) -> None:
        """Replace the host index; any device copy or store is dropped and
        rebuilt from it on the next query."""
        self._index = ix
        self._host_stale = False
        self._dev_store: Optional[DeviceStore] = None
        self._device_index: Optional[DeviceIndex] = None

    def _live_n_songs(self) -> int:
        """Catalog size of the live index, without syncing a store."""
        store = self._dev_store
        return store.n_songs if store is not None else self._index.n_songs

    def _live_n_hashes(self) -> int:
        """Rows of the live index, without syncing a store."""
        store = self._dev_store
        return store.n_valid if store is not None else self._index.n_hashes

    @property
    def _is_spanned(self) -> bool:
        return bool(self.device_resident and self.device_span_rows)

    def _ensure_dev_store(self):
        """The device store (a ``SpannedDeviceStore`` when spanned), built
        from the host index on first use."""
        with self._upload_lock:
            if self._dev_store is None:
                if self._is_spanned:
                    self._dev_store = SpannedDeviceStore.from_host(
                        self.index, span_rows=self.device_span_rows,
                        reserve=self.device_reserve_hashes,
                        device=self.device)
                else:
                    self._dev_store = DeviceStore.from_host(
                        self.index, reserve=self.device_reserve_hashes,
                        device=self.device)
            return self._dev_store

    def _absorb_addition(self, addition: FingerprintIndex) -> None:
        """Merge a sorted addition run into the live index: on the host
        (``merge_into``; the device copy is uploaded again on the next
        query), or, device-resident, into the store on the device."""
        with self._upload_lock:
            if self.device_resident:
                self._ensure_dev_store().merge(addition)
                self._host_stale = True
            else:
                self.index = merge_into(self.index, addition)

    # ------------------------------------------------------------------ #
    # ingest
    # ------------------------------------------------------------------ #
    def ingest_directory(self, path: str,
                         extensions: Sequence[str] = (".wav",),
                         limit: Optional[float] = None, batch_size: int = 8,
                         song_peak_capacity: Optional[int] = None,
                         verbose: bool = False, *,
                         merge_chunk_hashes: int = 4_000_000) -> Dict:
        """Fingerprint every matching file under ``path`` into the index,
        in sorted path order. Resumable: files whose SHA-1 is already
        fingerprinted are skipped (reference ``__init__.py:344-349``)."""
        files = sorted(p for p, _ in find_files(path, list(extensions)))
        return self.ingest_files(
            files, limit=limit, batch_size=batch_size,
            song_peak_capacity=song_peak_capacity, verbose=verbose,
            merge_chunk_hashes=merge_chunk_hashes)

    def ingest_files(self, files: Sequence[str], limit: Optional[float] = None,
                     batch_size: int = 8,
                     song_peak_capacity: Optional[int] = None,
                     verbose: bool = False,
                     merge_chunk_hashes: int = 4_000_000) -> Dict:
        """Streaming ingest of audio files: host memory stays O(batch).

        Decode and fingerprinting overlap (the host decodes batch k+1
        while the device runs batch k), and the index absorbs finished
        songs in sorted-run merges (``merge_into``) every
        ``merge_chunk_hashes`` hashes. ``limit`` keeps the first seconds
        of each file. Stats: ``files``, ``skipped`` (already ingested, by
        file SHA-1), ``ingested``, ``hashes``, ``overflowed`` (files with
        a channel past twice the peak capacity), ``merges``,
        ``peak_pending_channels`` (decoded channels not yet collected),
        ``fallbacks`` (channels retried alone, when any) and ``seconds``.
        """
        known = self.catalog.fingerprinted_file_hashes()
        todo: List[Tuple[str, str]] = []
        for f in files:
            sha = unique_file_hash(f)
            if sha not in known:
                todo.append((f, sha))
        return self._ingest_stream(
            todo, n_inputs=len(files), skipped=len(files) - len(todo),
            limit=limit, batch_size=batch_size,
            song_peak_capacity=song_peak_capacity,
            merge_chunk_hashes=merge_chunk_hashes, verbose=verbose)

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

    def ingest_channels(self, name: str, channels: Sequence[np.ndarray],
                        batch_size: int = 8,
                        song_peak_capacity: Optional[int] = None) -> Dict:
        """Ingest one song from decoded channels (per-channel fingerprints
        set-unioned, reference ``recognizer.py:377-382``); the dedup key
        is the SHA-1 of the channel bytes. ``name`` is treated like a
        file's basename (its extension is stripped)."""
        chans = [np.asarray(c) for c in channels if len(c)]
        if not chans:
            raise ValueError("no non-empty channels to ingest")
        h = hashlib.sha1()
        for c in chans:
            h.update(c.tobytes())
        sha = h.hexdigest().upper()
        if sha in self.catalog.fingerprinted_file_hashes():
            return {"files": 1, "skipped": 1, "ingested": 0, "hashes": 0,
                    "overflowed": [], "merges": 0}
        return self._ingest_pending(
            [(name, sha, chans)], n_inputs=1, skipped=0,
            batch_size=batch_size, song_peak_capacity=song_peak_capacity,
            verbose=False)

    def ingest_device_batch(self, names: Sequence[str], samples: torch.Tensor,
                            n_valid_samples: Sequence[int],
                            shas: Optional[Sequence[str]] = None,
                            song_peak_capacity: Optional[int] = None,
                            per_song_hash_capacity: int = 32768,
                            group_cap: int = 8,
                            defer_sort: bool = False) -> Dict:
        """Ingest a (B, blen) float32 batch of audio already on the SIA's
        device (``device_resident=True`` only; a tensor on another device
        raises). Fingerprints, the sorted deduped addition run
        (``index/devingest.py``) and the merge stay on the device; the host
        sends the (B,) song ids and reads back the run length, per-song
        counts, the overflow flag and the peak counts once per run. Rows
        with the same name are the channels of one song (their set-union
        is the run's dedup).

        ``shas`` are the resume keys, by default the SHA-1 of each name;
        rows whose key is already fingerprinted are skipped. A row whose
        peaks pass the capacity is masked out of the first run; with
        ``group_cap < 12`` the over-capacity rows run again at twice the
        capacity, cycle-padded to B rows, and with ``group_cap >= 12`` they
        are dropped. (In the JAX package ``group_cap`` also sizes its
        compaction kernel's tables; the port's K3 counts exactly, so here
        it chooses only between that retry and the drop.) A row still over
        capacity is reported in ``overflowed`` and left unfingerprinted,
        to be purged on the next open. ``defer_sort`` appends each run
        (``DeviceIndex.append_run``) and sorts on the next query or save,
        instead of merging it now. Stats keys are the JAX package's.
        """
        if not self.device_resident:
            raise ValueError("ingest_device_batch requires "
                             "SIA(device_resident=True)")
        if not isinstance(samples, torch.Tensor) or samples.device != self.device:
            raise ValueError(
                f"samples must be a tensor on {self.device} (got "
                f"{getattr(samples, 'device', type(samples).__name__)})")
        t_start = time.time()
        bsz = int(samples.shape[0])
        if len(names) != bsz or len(n_valid_samples) != bsz:
            raise ValueError("names / n_valid_samples must match batch")
        if shas is None:
            shas = [hashlib.sha1(n.encode()).hexdigest().upper()
                    for n in names]
        stats = {"files": len(set(names)), "skipped": 0, "ingested": 0,
                 "hashes": 0, "overflowed": [], "merges": 0}
        known = self.catalog.fingerprinted_file_hashes()
        keep = [i for i, s in enumerate(shas) if s.upper() not in known]
        stats["skipped"] = stats["files"] - len({names[i] for i in keep})
        if not keep:
            stats["seconds"] = time.time() - t_start
            return stats
        if len(keep) != bsz:
            samples = samples[torch.tensor(keep, device=self.device)]
            names = [names[i] for i in keep]
            shas = [shas[i] for i in keep]
            n_valid_samples = [n_valid_samples[i] for i in keep]
            bsz = len(keep)
        n_valid_samples = [int(n) for n in n_valid_samples]
        nv = torch.tensor(n_valid_samples, dtype=torch.int32,
                          device=self.device)
        peak_cap = self._peak_cap(song_peak_capacity)
        fp = self._fingerprint(samples, nv, peak_cap)

        # catalog rows first: the run's payloads carry the real song ids
        sid_of_name: Dict[str, int] = {}
        for name, sha in zip(names, shas):
            if name not in sid_of_name:
                sid_of_name[name] = self.catalog.insert_song(name, sha, 0)
        row_sids = np.asarray([sid_of_name[n] for n in names], np.int64)
        # the stride covers the largest offset the rows can have
        wsize, hop = self.config.window_size, self.config.hop
        bound_off = max(max((n - wsize) // hop + 1 for n in n_valid_samples),
                        0)
        song_totals: Dict[int, int] = {}

        with self._upload_lock:
            n_songs_new = max(int(row_sids.max()) + 1, self._live_n_songs())
            store = self._ensure_dev_store()
            max_off = max(store.max_offset, bound_off)
            if not packed_stride_for(max_off, n_songs_new):
                raise ValueError(
                    "catalog too large for the packed payload layout; "
                    "use the host ingest path (ingest_arrays/ingest_files)")
            store._ensure_layout(max_off)

            def run_and_merge(one_fp, sids, keep_rows):
                """One addition run of ``one_fp``'s rows where
                ``keep_rows`` (a (B,) device mask), absorbed into the
                store; returns the rows' peak counts."""
                valid = one_fp.valid & keep_rows[:, None]
                cap = capacity_for(valid.shape[0] * per_song_hash_capacity)
                cols, n_run, counts, overflowed = device_sorted_run(
                    one_fp.hi, one_fp.lo, one_fp.ex, one_fp.t1, valid,
                    torch.from_numpy(sids).to(self.device),
                    stride=store.stride, addition_cap=cap)
                host = torch.cat([torch.stack([n_run, overflowed.long()]),
                                  counts, one_fp.n_peaks.long()]).cpu()
                n_run, over = int(host[0]), bool(host[1])
                counts = host[2: 2 + len(sids)].numpy()
                if over:
                    raise ValueError(
                        f"device addition run overflowed {cap} rows; raise "
                        "per_song_hash_capacity")
                absorb = store.append_run if defer_sort else store.merge_device_run
                absorb(cols, n_run, n_songs_new, bound_off)
                self._host_stale = True
                stats["merges"] += 1
                stats["hashes"] += n_run
                per_sid = {int(sid): int(c) for sid, c in zip(sids, counts)
                           if c}   # every row of a song reports its total
                for sid, c in per_sid.items():
                    song_totals[sid] = song_totals.get(sid, 0) + c
                return host[2 + len(sids):].numpy()

            n_peaks = run_and_merge(fp, row_sids, fp.n_peaks <= peak_cap)
            over_rows = [i for i in range(bsz) if n_peaks[i] > peak_cap]
            if over_rows:
                # NB a song whose channels split across the two runs gets
                # no cross-run union (its counts add), as in the JAX package
                stats["fallbacks"] = len(over_rows)
                if _fused_ok(self.config) and group_cap >= 12:
                    dead = list(range(len(over_rows)))
                else:
                    retry_rows = (over_rows * bsz)[:bsz]   # cycle-pad to B
                    idx = torch.tensor(retry_rows, device=self.device)
                    retry_fp = self._fingerprint(samples[idx], nv[idx],
                                                 2 * peak_cap)
                    pad = torch.arange(bsz, device=self.device) >= len(over_rows)
                    retry_n = run_and_merge(
                        retry_fp, row_sids[retry_rows],
                        (retry_fp.n_peaks <= 2 * peak_cap) & ~pad)
                    dead = [j for j in range(len(over_rows))
                            if retry_n[j] > 2 * peak_cap]
                stats["overflowed"] = [names[over_rows[j]] for j in dead]

        dead_names = set(stats["overflowed"])
        for name, sid in sid_of_name.items():
            if name in dead_names:
                continue   # unfingerprinted: purged on the next open
            self.catalog.update_song_hashes(sid, song_totals.get(sid, 0))
            self.catalog.set_song_fingerprinted(sid)
            stats["ingested"] += 1
        stats["seconds"] = time.time() - t_start
        return stats

    def _peak_cap(self, song_peak_capacity: Optional[int]) -> int:
        return song_peak_capacity or max(self.config.peak_capacity, 16384)

    def _upload(self, batch: np.ndarray) -> torch.Tensor:
        """A host batch on the device as float32 (int16 uploads as int16
        and is cast there). On the card the copy is staged through pinned
        memory and does not block the host."""
        t = torch.from_numpy(batch)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True).to(torch.float32)

    def _launch_batch(self, batch: np.ndarray, n_valid: np.ndarray,
                      peak_cap: int):
        """Upload and fingerprint a padded batch and start its read-back;
        ``_collect_batch`` takes the result."""
        x = self._upload(batch)
        nv = torch.from_numpy(n_valid).to(self.device)
        fp = self._fingerprint(x, nv, peak_cap)
        return _start_download(fp), x, nv

    def _collect_batch(self, launched, peak_cap: int, stats: Dict,
                       names: Sequence[str]) -> List[Fingerprints]:
        """Each row's host Fingerprints. A row whose peaks overflowed is
        fingerprinted again alone at twice the capacity; past that, its
        name goes to ``stats["overflowed"]``."""
        pending, x, nv = launched
        fp = _finish_download(pending)
        out = []
        for row, name in enumerate(names):
            one = Fingerprints(*(a[row] for a in fp))
            if int(one.n_peaks) > peak_cap:
                fp2 = self._fingerprint(x[row:row + 1], nv[row:row + 1],
                                        2 * peak_cap)
                one = Fingerprints(*(a[0].cpu() for a in fp2))
                stats["fallbacks"] = stats.get("fallbacks", 0) + 1
                if int(one.n_peaks) > 2 * peak_cap:
                    stats["overflowed"].append(name)
            out.append(one)
        return out

    def _merge_songs(self, entries) -> None:
        """Merge finished songs' (sid, hi, lo, ex, t1) runs into the index,
        then mark them fingerprinted (durable only after the merge: the
        reference's set_song_fingerprinted rule)."""
        n_songs = max(max(e[0] for e in entries) + 1, self._live_n_songs())
        self._absorb_addition(build_index(entries, n_songs=n_songs))
        for sid, *_rest in entries:
            self.catalog.set_song_fingerprinted(sid)

    def _record_song(self, f: str, sha: str, fps: List[Fingerprints],
                     stats: Dict, verbose: bool):
        """Channel union and catalog row of one song; its index entry."""
        hi, lo, ex, t1 = union_pairs(fps)
        song_name = os.path.splitext(os.path.basename(f))[0]
        sid = self.catalog.insert_song(song_name, sha, int(hi.size))
        stats["ingested"] += 1
        stats["hashes"] += int(hi.size)
        if verbose:
            print(f"ingested {song_name}: {hi.size} hashes (song_id={sid})")
        return sid, hi, lo, ex, t1

    def _ingest_pending(self, pending: List[Tuple[str, str, List[np.ndarray]]],
                        n_inputs: int, skipped: int, batch_size: int,
                        song_peak_capacity: Optional[int],
                        verbose: bool) -> Dict:
        t_start = time.time()
        peak_cap = self._peak_cap(song_peak_capacity)
        stats = {"files": n_inputs, "skipped": skipped, "ingested": 0,
                 "hashes": 0, "overflowed": []}

        chan_song: List[int] = []
        chan_data: List[np.ndarray] = []
        for si, (_f, _sha, channels) in enumerate(pending):
            for ch in channels:
                chan_song.append(si)
                chan_data.append(ch)
        by_bucket: Dict[int, List[int]] = {}
        for ci, ch in enumerate(chan_data):
            by_bucket.setdefault(_bucket_len(len(ch)), []).append(ci)

        song_fps: Dict[int, List[Fingerprints]] = {}
        for blen, chan_ids in sorted(by_bucket.items()):
            for base in range(0, len(chan_ids), batch_size):
                ids = chan_ids[base:base + batch_size]
                batch, n_valid = _pad_rows([chan_data[ci] for ci in ids], blen)
                fps = self._collect_batch(
                    self._launch_batch(batch, n_valid, peak_cap), peak_cap,
                    stats, [pending[chan_song[ci]][0] for ci in ids])
                for ci, one in zip(ids, fps):
                    song_fps.setdefault(chan_song[ci], []).append(one)

        new_entries = [self._record_song(f, sha, song_fps.get(si, []), stats,
                                         verbose)
                       for si, (f, sha, _channels) in enumerate(pending)]
        if new_entries:
            self._merge_songs(new_entries)
        stats["seconds"] = time.time() - t_start
        return stats

    def _ingest_stream(self, todo: List[Tuple[str, str]], *, n_inputs: int,
                       skipped: int, limit: Optional[float], batch_size: int,
                       song_peak_capacity: Optional[int],
                       merge_chunk_hashes: int, verbose: bool) -> Dict:
        """The JAX package's ``_ingest_stream``, with its order: songs get
        ids as their last channel comes back (buckets by length, rows in
        file order within a bucket), then the files decoded eagerly."""
        t_start = time.time()
        peak_cap = self._peak_cap(song_peak_capacity)
        fs_cfg = self.config.sample_rate
        stats = {"files": n_inputs, "skipped": skipped, "ingested": 0,
                 "hashes": 0, "overflowed": [], "merges": 0,
                 "peak_pending_channels": 0}

        # plan by header probes only: (file, channel, frames) rows per
        # bucket; files the probe cannot size (non-WAV, or at another rate,
        # whose resampled length the plan cannot bucket) decode eagerly
        rows_by_bucket: Dict[int, List[Tuple[int, int, int]]] = {}
        song_expect: List[int] = []    # channels outstanding per song
        unknown: List[int] = []
        for si, (f, _sha) in enumerate(todo):
            info = probe(f)
            if info is not None and info[1] != fs_cfg:
                if not self.resample:
                    raise ValueError(
                        f"{f}: sample rate {info[1]} != config {fs_cfg}")
                info = None
            if info is None:
                unknown.append(si)
                song_expect.append(-1)
                continue
            n_ch, fs, frames = info
            if limit is not None:
                frames = min(frames, int(limit * fs))
            song_expect.append(n_ch)
            rows_by_bucket.setdefault(_bucket_len(frames), []).extend(
                (si, c, frames) for c in range(n_ch))

        song_fps: Dict[int, List[Fingerprints]] = {}
        chunk: List = []               # finished songs awaiting a merge
        counts = {"hashes": 0, "channels": 0}   # pending in chunk / flight

        def decode_rows(rows, blen):
            """One file's channels at a time, each cut to its planned
            frames."""
            decoded: Dict[str, List[np.ndarray]] = {}
            chans = []
            for si, c, frames in rows:
                f = todo[si][0]
                if f not in decoded:
                    decoded.clear()
                    decoded[f] = read(f, limit)[0]
                chans.append(decoded[f][c][:frames])
            return _pad_rows(chans, blen)

        def launch(batch, n_valid, rows):
            counts["channels"] += len(rows)
            stats["peak_pending_channels"] = max(
                stats["peak_pending_channels"], counts["channels"])
            return self._launch_batch(batch, n_valid, peak_cap), rows

        def maybe_merge(force=False):
            if chunk and (force or counts["hashes"] >= merge_chunk_hashes):
                self._merge_songs(chunk)
                chunk.clear()
                counts["hashes"] = 0
                stats["merges"] += 1

        def collect(inflight):
            launched, rows = inflight
            fps = self._collect_batch(launched, peak_cap, stats,
                                      [todo[si][0] for si, _c, _n in rows])
            for (si, _c, _n), one in zip(rows, fps):
                song_fps.setdefault(si, []).append(one)
                counts["channels"] -= 1
                song_expect[si] -= 1
                if song_expect[si] == 0:
                    entry = self._record_song(*todo[si], song_fps.pop(si),
                                              stats, verbose)
                    chunk.append(entry)
                    counts["hashes"] += int(entry[1].size)
            maybe_merge()

        # stream: batch k is collected only after batch k+1 was decoded
        # and launched, so decode overlaps the device's work
        inflight = None
        for blen in sorted(rows_by_bucket):
            rows = rows_by_bucket[blen]
            for base in range(0, len(rows), batch_size):
                part = rows[base:base + batch_size]
                launched = launch(*decode_rows(part, blen), part)
                if inflight is not None:
                    collect(inflight)
                inflight = launched
        if inflight is not None:
            collect(inflight)

        for si in unknown:
            f, _sha = todo[si]
            channels, fs, _ = read(f, limit)
            if fs != fs_cfg:
                if not self.resample:
                    raise ValueError(
                        f"{f}: sample rate {fs} != config {fs_cfg}")
                channels = resample_channels(channels, fs, fs_cfg)
            song_expect[si] = len(channels)
            batch, n_valid = _pad_rows(
                channels, _bucket_len(max(len(ch) for ch in channels)))
            collect(launch(batch, n_valid,
                           [(si, c, int(n)) for c, n in enumerate(n_valid)]))

        maybe_merge(force=True)
        stats["seconds"] = time.time() - t_start
        return stats

    # ------------------------------------------------------------------ #
    # recognition
    # ------------------------------------------------------------------ #
    def _ensure_device_index(self) -> DeviceIndex:
        """The search view on the device: the store's when device-resident,
        else the host index uploaded after its last change."""
        with self._upload_lock:
            if self.device_resident:
                store = self._ensure_dev_store()
                self._max_off = ((store.max_offset // 4096) + 1) * 4096
                return store.query_cols()
            if self._device_index is None:
                self._device_index = self.index.device_arrays(self.device)
                # histogram window base: covers the longest song, rounded
                # up so catalog growth keeps the same window
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

    def _sparse(self, delta_range: int) -> bool:
        """Past ``sparse_vote_threshold`` vote bins: the sparse ranks."""
        return tiers.is_sparse(self._n_songs(), delta_range,
                               self.config.sparse_vote_threshold)

    def _n_songs(self) -> int:
        return max(self._live_n_songs(), 1)

    def _to_device(self, samples: np.ndarray):
        """A (N,) clip, or a (C, N) clip of C channel rows, as one
        (C, bucketed) f32 tensor (C = 1 for mono) and its (C,) valid
        lengths on the device."""
        rows = np.atleast_2d(samples)
        n = rows.shape[1]
        padded = np.zeros((rows.shape[0], _bucket_len(n)), np.float32)
        padded[:, :n] = rows
        return (torch.from_numpy(padded).to(self.device),
                torch.tensor([n] * rows.shape[0], dtype=torch.int32,
                             device=self.device))

    def _fingerprint_channel(self, samples: np.ndarray) -> Fingerprints:
        """One channel's fingerprints at the smallest capacity that holds
        all its peaks (x2 per retry; every retry takes the same path)."""
        x, nv = self._to_device(samples)
        cap = self.config.peak_capacity
        while True:
            fp = self._fingerprint(x, nv, cap)
            with span("sia.readback"):
                n = int(fp.n_peaks[0])
            if n <= cap or cap >= MAX_PEAK_CAPACITY:
                return Fingerprints(*(a[0] for a in fp))
            while cap < n and cap < MAX_PEAK_CAPACITY:
                cap *= 2

    def recognize_samples(self, channels: Sequence[np.ndarray],
                          topn: Optional[int] = None,
                          early_exit: bool = False,
                          q_pad_to: Optional[int] = None) -> Dict:
        """Recognize decoded audio channels (two passes: fingerprint, then
        host dedup + match with capacity tiers).

        Returns the reference's result schema plus fingerprint/query/align
        stage times (``recognizer_test.py:607-610``).

        ``early_exit=True`` matches in batches of query pairs and stops
        once the leader has twice the runner-up's matched hashes, the
        reference's apriori rule (``match/apriori.py``); its counts then
        reflect the partial scan. ``q_pad_to`` raises the query padding
        (never lowers it); results are the same at any padding.
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
        if q_pad_to is not None and q_pad_to > len(q.hi):
            q = prepare_query(fps, pad_to=q_pad_to)
        fingerprint_time = time.time() - t0

        t0 = time.time()
        raw, cap_used = self._match_prepared(
            q, n_samples=max(len(ch) for ch in channels), topn=topn,
            early_exit=early_exit)
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

    def _match_prepared(self, q, n_samples: int, topn: Optional[int] = None,
                        early_exit: bool = False,
                        min_capacity: Optional[int] = None):
        """Match prepared query pairs with capacity tiers; returns (host
        RawMatch, capacity actually used): the query uploaded
        (``_query_to_device``) and matched by ``_match_tiered``.

        ``early_exit``: the apriori match at ``match_capacity`` per batch
        (``match_query_apriori_ondevice``), where the dense histogram it
        accumulates exists, under ``sparse_vote_threshold``; past it, or on
        a spanned SIA, a warning and the full match, as in the JAX package.
        Its accumulated total may pass one batch's capacity without any
        vote dropped, so only a batch that clamped reports the capacity.
        """
        index = self._ensure_device_index()
        delta_min, delta_range = self._delta_params_for(n_samples)
        spanned = self._is_spanned
        if early_exit:
            if spanned or self._sparse(delta_range):
                warnings.warn(
                    "early_exit is unavailable for "
                    + ("spanned stores" if spanned
                       else "catalogs past the sparse-matcher threshold")
                    + "; running a full match (identical top-1, but "
                    "vote counts reflect the full scan, not a partial one)",
                    stacklevel=3)
            else:
                cap = self.config.match_capacity
                raw, _used, clamped = match_query_apriori_ondevice(
                    index, q, n_songs=self._n_songs(), delta_min=delta_min,
                    delta_range=delta_range, match_capacity=cap,
                    topn=topn or self.config.topn)
                return raw, cap if clamped else max(int(raw.total_rows), cap)
        q_dev = self._query_to_device({name: getattr(q, name)
                                       for name in QUERY_COLUMNS})
        return self._match_tiered(index, q_dev, n_samples, topn=topn,
                                  min_capacity=min_capacity)

    def _match_tiered(self, index, q_dev, n_samples: int, *,
                      topn: Optional[int] = None,
                      min_capacity: Optional[int] = None, first=None):
        """The capacity ladder (``tiers.escalate``) of a query already on
        the device (``QUERY_COLUMNS`` order), on the flat store or a
        spanned one; returns (host RawMatch, capacity actually used).

        The flat store dispatches ``match_by_rank`` (the dense histogram,
        past ``sparse_vote_threshold`` the sort or scan rank), its clamp
        signal the exact total. A spanned store searches every span and
        ranks the votes together, always with a sparse rank, as in the
        JAX package (``match_query_sparse_spanned``); each span's
        expansion clamps on its own at the tier, so its clamp signal is
        ``span_max``, the largest per-span count (the total on the
        stacked layout's shared budget), exact even when clamped, and only
        the stacked layout keeps search bounds. On a big index
        (``tiers.big_index``) the first dispatch is decide-first.
        ``min_capacity``: a caller that knows the query's exact total (a
        batch's clamped clip) starts at the tier that fits it, with no
        decide tier. ``first``: a dispatch the caller made already
        (``recognize_clip``'s single pass), as (its tier, its host
        RawMatch, its clamp signal, its search bounds or None); the ladder
        goes on from it as from its own.
        """
        cfg = self.config
        delta_min, delta_range = self._delta_params_for(n_samples)
        caps = tiers.match_tiers(cfg, min_capacity)
        spanned = self._is_spanned
        sparse = spanned or self._sparse(delta_range)
        kw = dict(n_songs=self._n_songs(), delta_min=delta_min,
                  delta_range=delta_range, topn=topn or cfg.topn,
                  expand_runs=cfg.expand_block_runs)

        def run(cap, blk=None, bounds=None, with_bounds=False):
            args = dict(kw, match_capacity=cap, bounds=bounds, expand_block=(
                tiers.expand_block(cfg, index, cap) if blk is None else blk))
            rank = tiers.rank_for(cfg, cap, sparse)
            if spanned:
                raw, span_max, *out = match_query_sparse_spanned(
                    index, *q_dev, vote_rank=rank,
                    with_bounds=with_bounds and _is_stacked(index), **args)
                raw, (span_max,) = raw_to_host(raw, span_max)
                return raw, span_max, tuple(out) or None
            out = match_by_rank(index, *q_dev, rank=rank,
                                with_bounds=with_bounds, **args)
            raw, *out = out if with_bounds else (out,)
            raw = raw_to_host(raw)[0]
            return raw, raw.total_rows, tuple(out) or None

        big = (sparse and min_capacity is None
               and tiers.big_index(cfg, index))
        return tiers.escalate(run, caps, cfg,
                              decide=self.decide if big else None,
                              first=first)

    def _query_to_device(self, cols: Dict[str, np.ndarray]):
        """Query columns (one query or a (B, Q) stack) on the device, in
        ``QUERY_COLUMNS`` order: keys and offsets as int64, masks bool."""
        return [torch.from_numpy(np.asarray(cols[name], np.int64
                                            if name in ("hi", "lo", "ex", "t")
                                            else bool)).to(self.device)
                for name in QUERY_COLUMNS]

    def recognize_clip(self, samples: np.ndarray,
                       topn: Optional[int] = None) -> Dict:
        """Lowest-latency recognition of one clip: mono (N,), or (C, N)
        with C <= 2 channels, a stereo recording.

        Fingerprint (the C rows in one call), on-device dedup of the
        union of their (hash, offset) pairs, match and rank run on the
        device with one read-back at the end; results equal
        ``recognize_samples`` of the clip's channels. The query holds every
        lane of the clip's fingerprint, rows x (fan_value - 1) x
        peak_capacity, so the dedup drops none. A clip whose match clamped
        without being provably decided goes on from the query the pass
        left on the device (``_rematch``); one that overflows the peak
        capacity in any channel, or is longer than the dedup's 16-bit
        offsets, goes to ``recognize_samples``. On a big index (sparse
        ranks and ``bounds_probe_min_rows``) the single pass runs at the
        decide tier and keeps its search bounds for the continuation.
        """
        samples = np.asarray(samples)
        if samples.ndim not in (1, 2) or (
                samples.ndim == 2
                and not 1 <= samples.shape[0] <= MAX_CLIP_CHANNELS):
            raise ValueError(
                f"recognize_clip takes a (N,) clip or a (C, N) clip of 1 to "
                f"{MAX_CLIP_CHANNELS} channels, not shape {samples.shape}; "
                "pass more channels to recognize_samples")
        rows = len(np.atleast_2d(samples))
        with span("sia.recognize_clip", channels=rows):
            return self._recognize_clip(samples, rows, topn)

    def _recognize_clip(self, samples: np.ndarray, rows: int,
                        topn: Optional[int]) -> Dict:
        t0 = time.time()
        n = samples.shape[-1]
        blen = _bucket_len(n)
        cfg = self.config
        if (blen - cfg.window_size) // cfg.hop + 1 > 1 << 16:
            # > ~51 min: the on-device dedup packs offsets into 16 bits
            return self._handoff(samples, topn, "long")
        index = self._ensure_device_index()
        delta_min, delta_range = self._delta_params_for(n)
        n_songs = self._n_songs()
        # every lane of the fingerprint: no clip overflows its own query
        q_cap = rows * (cfg.fan_value - 1) * cfg.peak_capacity
        if self._is_spanned:
            return self._recognize_clip_spanned(
                samples, index, n_songs=n_songs, delta_min=delta_min,
                delta_range=delta_range, q_cap=q_cap, topn=topn, t0=t0)
        sparse = self._sparse(delta_range)
        big = sparse and tiers.big_index(cfg, index)
        one_cap = (self.decide.cap(cfg, tiers.match_tiers(cfg)) if big
                   else cfg.match_capacity_fast)
        x, nv = self._to_device(samples)
        # decide-first keeps its search bounds, as _match_tiered does
        raw, n_pairs, n_peaks, n_hashes, q_dev, bounds = recognize_on_device(
            x, nv, index, **self._fp_kwargs(), use_fused=_fused_ok(cfg),
            n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
            match_capacity=one_cap, topn=topn or cfg.topn,
            query_capacity=q_cap, rank=tiers.rank_for(cfg, one_cap, sparse),
            expand_block=tiers.expand_block(cfg, index, one_cap),
            expand_runs=cfg.expand_block_runs, with_bounds=big)
        raw, (n_pairs, n_peaks, n_hashes) = raw_to_host(
            raw, n_pairs, n_peaks, n_hashes)
        annotate("sia.recognize_clip", lanes=n_hashes, pairs=n_pairs)
        reason = self._handoff_reason(
            n_peaks, (raw.total_rows > one_cap or raw.n_dropped > 0)
            and not tiers.decided(raw, cfg))
        if reason == "undecided":
            return self._rematch(
                index, q_dev, n, first=(one_cap, raw, raw.total_rows, bounds),
                q_cap=q_cap, n_pairs=n_pairs, topn=topn, t0=t0)
        if reason:
            return self._handoff(samples, topn, reason)
        return self._clip_result(raw, n_pairs, max(raw.total_rows, one_cap),
                                 time.time() - t0)

    def _rematch(self, index: DeviceIndex, q_dev, n_samples: int, *, first,
                 q_cap: int, n_pairs: int, topn: Optional[int],
                 t0: float) -> Dict:
        """``recognize_clip``'s continuation from the query its single pass
        left on the device, where the pass's clamped match is not provably
        decided: the tiers go on from the pass's own dispatch, ``first``.
        They are ``recognize_samples``' own, so the result equals it."""
        with span("sia.rematch", reason="undecided"):
            raw, cap = self._match_tiered(index, q_dev, n_samples,
                                          topn=topn, first=first)
            annotate("sia.rematch", query_capacity=q_cap, cap=cap)
            return self._clip_result(raw, n_pairs, cap, time.time() - t0)

    def _handoff_reason(self, n_peaks: int, undecided: bool) -> Optional[str]:
        """Why a clip's single pass cannot answer it, or None: its peaks
        (in any channel) overflowed, or its clamped match is not provably
        decided."""
        if n_peaks > self.config.peak_capacity:
            return "peaks"
        return "undecided" if undecided else None

    def _handoff(self, samples: np.ndarray, topn: Optional[int],
                 reason: str) -> Dict:
        """``recognize_samples`` of the channels of a clip its single pass
        could not answer, ``reason`` naming the test that sent it on."""
        with span("sia.handoff", reason=reason):
            return self.recognize_samples(list(np.atleast_2d(samples)),
                                          topn=topn)

    def _recognize_clip_spanned(self, samples: np.ndarray, dev, *,
                                n_songs: int, delta_min: int,
                                delta_range: int, q_cap: int,
                                topn: Optional[int], t0: float) -> Dict:
        """``recognize_clip`` on a spanned store: one pass at the fast tier
        through every span (``recognize_on_device_spanned``), one
        read-back. A peak overflow, or a clamped span that is not provably
        decided, goes to ``recognize_samples``."""
        fast = self.config.match_capacity_fast
        x, nv = self._to_device(samples)
        raw, *counts = recognize_on_device_spanned(
            x, nv, dev, **self._fp_kwargs(),
            use_fused=_fused_ok(self.config), n_songs=n_songs,
            delta_min=delta_min, delta_range=delta_range,
            match_capacity=fast, topn=topn or self.config.topn,
            query_capacity=q_cap,
            vote_rank=tiers.rank_for(self.config, fast, True))
        raw, (span_max, n_pairs, n_peaks, n_hashes) = raw_to_host(raw, *counts)
        device_time = time.time() - t0
        annotate("sia.recognize_clip", lanes=n_hashes, pairs=n_pairs)
        reason = self._handoff_reason(
            n_peaks, (span_max > fast or raw.n_dropped > 0)
            and not tiers.decided(raw, self.config))
        if reason:
            return self._handoff(samples, topn, reason)
        return self._clip_result(raw, n_pairs, max(raw.total_rows, fast),
                                 device_time)

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

    def recognize_file(self, path: str, limit: Optional[float] = None,
                       topn: Optional[int] = None,
                       early_exit: bool = False) -> Dict:
        """Decode an audio file (resampled to ``config.sample_rate`` when
        ``resample``, else a ``ValueError`` at another rate) and recognize
        its channels with ``recognize_samples``."""
        channels, fs, _sha = read(path, limit)
        if fs != self.config.sample_rate:
            if not self.resample:
                raise ValueError(
                    f"{path}: sample rate {fs} != {self.config.sample_rate}")
            channels = resample_channels(channels, fs, self.config.sample_rate)
        return self.recognize_samples(channels, topn=topn,
                                      early_exit=early_exit)

    def recognize_batch(self, clips: Sequence[np.ndarray],
                        topn: Optional[int] = None, pad_to_pow2: bool = False,
                        q_pad_to: Optional[int] = None,
                        match_capacity: Optional[int] = None) -> List[Dict]:
        """Recognize many mono clips: one fingerprint batch and one match
        dispatch for all of them; per-clip results equal
        ``recognize_samples`` on each clip alone (a clip decided under a
        clamp reports lower-bound matched counts at the batch's tier), with
        the batch's ``batch_*`` times beside the amortized per-clip ones.

        ``pad_to_pow2`` rounds the batch up to a power of two with empty
        rows, which produce no output. ``q_pad_to`` raises the stack's
        query padding (never lowers it). ``match_capacity`` overrides the
        base dispatch tier; results are the same, since per-clip
        escalation still runs. ``prepare_batch`` then
        ``match_prepared_batch``.
        """
        pb = self.prepare_batch(clips, topn=topn, pad_to_pow2=pad_to_pow2,
                                q_pad_to=q_pad_to,
                                match_capacity=match_capacity)
        if pb is None:
            return []
        return self.match_prepared_batch(pb)

    def prepare_batch(self, clips: Sequence[np.ndarray],
                      topn: Optional[int] = None, pad_to_pow2: bool = False,
                      q_pad_to: Optional[int] = None,
                      match_capacity: Optional[int] = None
                      ) -> Optional[_PreparedBatch]:
        """Stage 1 of ``recognize_batch``: fingerprint the clips as one
        padded batch (one read-back) and stack their host queries. A clip
        whose peaks overflowed gets an empty query here and re-runs alone
        through ``recognize_samples`` in stage 2. None for no clips.
        """
        if not len(clips):
            return None
        with span("sia.prepare_batch", clips=len(clips)):
            t0 = time.time()
            n_real = len(clips)
            n_clips = n_real
            if pad_to_pow2:
                n_clips = 1 << (n_real - 1).bit_length()
            clips = [np.asarray(c) for c in clips]
            batch, n_valid = _pad_rows(
                clips + [np.zeros(0, np.float32)] * (n_clips - n_real),
                max(_bucket_len(len(c)) for c in clips))
            fp = _finish_download(self._launch_batch(
                batch, n_valid, self.config.peak_capacity)[0])
            peak_over = {i for i in range(n_real)
                         if int(fp.n_peaks[i]) > self.config.peak_capacity}
            queries = [prepare_query([]) if i in peak_over
                       else prepare_query([Fingerprints(*(a[i] for a in fp))])
                       for i in range(n_clips)]
            with span("query.prepare"):
                q_cap = max(len(q.hi) for q in queries)
                if q_pad_to is not None:
                    q_cap = max(q_cap, q_pad_to)
                stack = {name: np.stack([np.pad(getattr(q, name),
                                                (0, q_cap - len(q.hi)))
                                         for q in queries])
                         for name in QUERY_COLUMNS}

            return _PreparedBatch(
                clips=clips, queries=queries, stack=stack, peak_over=peak_over,
                topn=topn, match_capacity=match_capacity,
                fingerprint_time=time.time() - t0)


    def _batch_match(self, q_dev, n_samples: int, cap: int,
                     topn: Optional[int] = None) -> RawMatch:
        """One batched match dispatch of a (B, Q) query stack on the device
        at tier ``cap``: the dense histogram, or past the threshold the sort
        rank with the blocked expansion where the solo path takes it.
        ``n_samples`` (the batch's longest clip) sizes every clip's delta
        window, as in the JAX package."""
        index = self._ensure_device_index()
        delta_min, delta_range = self._delta_params_for(n_samples)
        sparse = self._sparse(delta_range)
        return match_queries_batched(
            index, *q_dev, rank="sort" if sparse else "dense",
            n_songs=self._n_songs(), delta_min=delta_min,
            delta_range=delta_range, match_capacity=cap,
            topn=topn or self.config.topn,
            expand_block=(tiers.expand_block(self.config, index, cap)
                          if sparse else 0),
            expand_runs=self.config.expand_block_runs)

    def match_prepared_batch(self, pb: _PreparedBatch) -> List[Dict]:
        """Stage 2 of ``recognize_batch``: one batched match dispatch over
        the prepared stack, per-clip escalation, host alignment.

        The base tier is ``config.match_capacity``, as in the JAX package
        (``match_capacity`` overrides it). The solo ladder starts lower, at
        the fast tier, so a clip decided under a clamp at both reports
        lower-bound matched counts taken at different clamps, each at most
        the exact count. On a big index the base tier is the decide tier.
        A clip clamped there is accepted when provably decided
        (``tiers.decided``); when more than half the batch is not, the
        whole batch dispatches again at the tier the largest total fits
        (under the JAX package's 4 GB guard), and the clips still
        undecided re-run alone from the tier their exact total fits
        (``_match_prepared(min_capacity=...)``). The batch ranks with the
        dense histogram or, past ``sparse_vote_threshold``, the sort rank,
        which gives the ``RawMatch`` of every sparse rank. A spanned SIA
        dispatches through ``match_queries_batched_spanned`` (no decide
        tier, as in the JAX package), its clamp signal each clip's
        ``span_max``.
        """
        with span("sia.match_prepared_batch", clips=len(pb.clips)):
            clips, queries, peak_over = pb.clips, pb.queries, pb.peak_over
            n_real = len(clips)
            topn = pb.topn
            n_samples = max(map(len, clips))
            t0 = time.time()
            cfg = self.config
            index = self._ensure_device_index()
            q_dev = self._query_to_device(pb.stack)
            spanned = self._is_spanned
            delta_min, delta_range = self._delta_params_for(n_samples)

            def dispatch(cap):
                """(host RawMatch, per-clip clamp signals)."""
                if not spanned:
                    raw = batched_raw_to_host(self._batch_match(
                        q_dev, n_samples, cap, topn=topn))
                    return raw, raw.total_rows[:n_real]
                raw, span_max = match_queries_batched_spanned(
                    index, *q_dev, n_songs=self._n_songs(),
                    delta_min=delta_min, delta_range=delta_range,
                    match_capacity=cap, topn=topn or cfg.topn,
                    expand_block=tiers.expand_block(cfg, index, cap),
                    expand_runs=cfg.expand_block_runs)
                return (batched_raw_to_host(raw),
                        span_max.cpu().numpy()[:n_real])

            caps = tiers.match_tiers(cfg)
            base_cap = pb.match_capacity or cfg.match_capacity
            # the decide tier, where the caller did not pin the base tier
            decide = (not spanned and pb.match_capacity is None
                      and self._sparse(delta_range)
                      and tiers.big_index(cfg, index))
            if decide:
                base_cap = self.decide.cap(cfg, caps)

            raw, clamp = dispatch(base_cap)
            batch_cap = base_cap
            decided_ids: set = set()
            retried: Dict[int, Tuple] = {}

            def undecided(clamped):
                """The clamped clips whose margin does not decide them."""
                margin_ok = tiers.decided(raw, cfg)[:n_real]
                decided_ids.update(int(i) for i in clamped if margin_ok[i])
                return clamped[~margin_ok[clamped]]

            if caps[-1] > batch_cap:
                over = undecided(np.nonzero(
                    (clamp > batch_cap) | (raw.n_dropped[:n_real] > 0))[0])
                if decide:
                    self.decide.record(cfg, n_real, len(over))
                if len(over) > max(n_real // 2, 1):
                    cand_cap = tiers.fit(caps, int(clamp.max()))
                    m_bits = min(24,
                                 max(18, (cand_cap * 16 - 1).bit_length()))
                    if n_real * ((1 << m_bits) * 4 + 24 * cand_cap) \
                            <= BATCH_GUARD_BYTES:
                        batch_cap = cand_cap
                        raw, clamp = dispatch(batch_cap)
                        # judged against the old dispatch
                        decided_ids.clear()
                        over = undecided(np.nonzero(
                            (clamp > batch_cap)
                            | (raw.n_dropped[:n_real] > 0))[0])
                for i in over:
                    with span("match.solo_retry"):
                        retried[int(i)] = self._match_prepared(
                            queries[i], len(clips[i]), topn=topn,
                            min_capacity=int(clamp[i]))
            query_time = time.time() - t0

            out = []
            for i in range(n_real):
                if i in peak_over:
                    out.append(self._handoff(clips[i], topn, "peaks"))
                    continue
                t0 = time.time()
                if i in retried:
                    one, cap_i = retried[i]
                else:
                    one = RawMatch(*(a[i] for a in raw))
                    # a clip that fit (its clamp signal: the total, or spanned
                    # its largest span), or is provably decided, reads as
                    # unaffected by the capacity
                    cap_i = (max(int(one.total_rows), batch_cap)
                             if int(clamp[i]) <= batch_cap
                             or i in decided_ids else batch_cap)
                res = self._clip_result(one, queries[i].n_pairs, cap_i, 0.0)
                align_time = time.time() - t0
                res.update(
                    fingerprint_time=pb.fingerprint_time / n_real,
                    query_time=query_time / n_real, align_time=align_time,
                    total_time=(pb.fingerprint_time + query_time) / n_real
                    + align_time,
                    batch_fingerprint_time=pb.fingerprint_time,
                    batch_query_time=query_time, batch_size=n_real)
                out.append(res)
            return out

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
        """Rebuild the host index without ``ids``' rows (a device store is
        synced first and dropped, as in the JAX package); rows removed."""
        with self._upload_lock:
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

    def consolidate_index(self) -> None:
        """Stack a spanned store into its serving layout
        (``SpannedDeviceStore.consolidate``): one batched search over the
        spans instead of a loop over them. The store is then closed to
        ingest. Nothing to do on any other SIA."""
        if self._is_spanned:
            with self._upload_lock:
                self._ensure_dev_store().consolidate()

    def save_index(self, path: str) -> None:
        """Persist the index. A spanned SIA's live store writes the JAX
        package's span-wise file (``SpannedDeviceStore.save``: each span's
        rows, no global sort); everything else writes the flat sorted
        ``.npz`` both packages read (a device store is synced to the host
        first)."""
        if isinstance(self._dev_store, SpannedDeviceStore):
            with self._upload_lock:
                self._dev_store.save(path)
            return
        self.index.save(path)

    def load_index(self, path: str, stacked: bool = False) -> None:
        """Load a flat ``.npz`` index or a span-wise one, then restore the
        catalog invariant (fingerprinted flag <=> hash rows present).

        A spanned SIA uploads a span-wise file straight into a store of
        its ``device_span_rows`` (``SpannedDeviceStore.load``: no sort on
        either side; ``stacked=True`` builds the consolidated layout
        directly, closed to ingest) and reconciles the catalog only when
        its hash total differs from the store's rows, as the JAX package
        does; any other SIA flattens the file on the host. A flat file
        into a device-resident SIA is uploaded on the next query."""
        if is_spanned_file(path):
            if self._is_spanned:
                with self._upload_lock:
                    store = SpannedDeviceStore.load(
                        path, span_rows=self.device_span_rows,
                        stacked=stacked, device=self.device)
                    self.index = build_index([], n_songs=0)
                    self._dev_store = store
                    self._host_stale = True
                if self.catalog.counts()["n_hashes"] != store.n_valid:
                    self._reconcile_catalog()   # a torn restart only
                return
            self.index = load_spanned_flat(path)
        else:
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
