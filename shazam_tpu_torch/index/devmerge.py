"""The device-resident fingerprint store: sorted merges that stay on the card.

The port of ``shazam_tpu/index/devmerge.py``'s flat store. Host ingest
merges every sorted addition run into the host index (``merge_into``) and
drops the device copy, so the next query uploads the whole index again.
``DeviceIndex`` here keeps the index on the device instead and absorbs
each addition there:

- ``merge`` / ``merge_device_run``: a rank-scatter merge. Each addition
  row finds its upper rank in the base (a ``searchsorted`` on the 64-bit
  key, then a short binary search over ``(ex, payload)`` inside the key's
  run); the base rows' shifts are the running count of those ranks (one
  ``bincount`` and a ``cumsum``), and one scatter per column places every
  row. Equal rows keep the base first, as ``merge_into`` does; equal full
  rows are interchangeable anyway.
- ``append_run`` + ``finalize``: copy the run behind the valid rows now;
  on the next query, merge or save, sort the appended tail (three stable
  radix sorts, one per column) and rank-merge it into the sorted prefix.
  The rows are identical to a sequence of ``merge_device_run`` calls.

Naming: this class keeps the JAX package's name. The search view it hands
the matchers is ``index/store.DeviceIndex``, the named tuple ``(key64,
key_sub, payload, n_rows, stride)`` that ``FingerprintIndex.device_arrays``
uploads; ``query_cols()`` returns one of those.

Layout. The JAX store keeps uint32 columns and packs ``song * stride +
offset`` into a uint32 payload, with a 5-column unpacked layout for
catalogs whose payload would not fit. The port keeps three int64 columns:
``key64`` (the sign-flipped ``hi << 32 | lo``, as ``index/store.py``),
``ex`` and ``payload = song * stride + offset``, which never needs an
unpacked layout; the stride grows with ``max_offset`` (``_ensure_layout``
repacks the payloads). Capacity is a power of two from 2^16 (``reserve``
preallocates), and rows past ``n_valid`` are sentinels: ``key64`` and
``ex`` at the int64 maximum, which sorts after every real row (real ``ex``
is 16-bit), and payload 0, as ``device_arrays`` pads.

The search view's ``key_sub = run_start << 16 | ex`` holds global row
positions, so every merge, append or finalize invalidates it;
``query_cols()`` rebuilds it on the device (first-of-run flags, a
prefix sum, a scatter and a gather) and caches it until the next change.

Spans. ``SpannedDeviceStore`` is the JAX package's spanned store: the
index as a list of ``DeviceIndex`` spans of exactly ``span_rows`` rows
each. Ingest goes into the last (active) span; a run that does not fit
seals it (its pending appends sorted) and opens a fresh one, so a merge
allocates and moves O(span_rows) whatever the catalog's size, where the
flat store rebuilds every row into new columns. A sealed span never
changes, so its search view is built once and cached; only the active
span's is rebuilt after an ingest. Queries search every span
(``match/lookup.match_query_sparse_spanned``). ``consolidate`` stacks the
spans into (n_spans, span_rows) columns, searched in one batched round and
closed to ingest; ``save`` / ``load`` / ``load_flat`` read and write the
JAX package's span-wise ``.npz`` file.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import store
from .store import FingerprintIndex, atomic_savez, offset_stride_for

SENTINEL = np.iinfo(np.int64).max
MIN_CAPACITY = 1 << 16
_SIGN = np.uint64(1 << 63)

Cols = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # key64, ex, payload


def capacity_for(n: int, floor: int = MIN_CAPACITY) -> int:
    """Power-of-two row capacity for ``n`` rows, at least ``floor``."""
    c = floor
    while c < n:
        c <<= 1
    return c


def packed_stride_for(max_offset: int, n_songs: int) -> int:
    """The JAX package's packing rule (``offset_stride_for(max_offset,
    n_songs)`` of its ``index/store.py``): the power-of-two stride above
    ``max_offset``, or 0 where ``n_songs * stride`` passes 2^32 and its
    uint32 payload cannot hold the song. The port's int64 payload has no
    such limit; ``SIA.ingest_device_batch`` refuses those batches all the
    same, so that both packages accept the same ones."""
    stride = offset_stride_for(max_offset)
    return stride if max(n_songs, 1) * stride <= (1 << 32) else 0


def rows_sorted(key64: torch.Tensor, ex: torch.Tensor,
                payload: torch.Tensor) -> torch.Tensor:
    """A 0-dim bool on the rows' device: are they in (key64, ex, payload)
    order?"""
    k, e, p = key64, ex, payload
    if k.shape[0] < 2:
        return torch.ones((), dtype=torch.bool, device=k.device)
    return torch.all((k[1:] > k[:-1]) | ((k[1:] == k[:-1]) & (
        (e[1:] > e[:-1]) | ((e[1:] == e[:-1]) & (p[1:] >= p[:-1])))))


def empty_cols(cap: int, device) -> Cols:
    """``cap`` sentinel rows."""
    big = torch.full((cap,), SENTINEL, dtype=torch.int64, device=device)
    return big, big.clone(), torch.zeros(cap, dtype=torch.int64,
                                         device=device)


def lexsort_rows(key64: torch.Tensor, ex: torch.Tensor,
                 payload: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts rows by (key64, ex, payload): three
    stable sorts, least significant column first."""
    order = torch.argsort(payload, stable=True)
    order = order[torch.argsort(ex[order], stable=True)]
    return order[torch.argsort(key64[order], stable=True)]


def _upper_ranks(base: Cols, n_base: int, add: Cols, n_add: int) -> torch.Tensor:
    """For each of the first ``n_add`` addition rows, how many of the first
    ``n_base`` base rows are <= it in (key64, ex, payload) order.

    ``searchsorted`` on key64 brackets each row's run of equal keys; a
    binary search over (ex, payload) inside the run finishes it, in as
    many steps as the longest bracket needs (one read-back)."""
    bk, be, bp = (c[:n_base] for c in base)
    ak, ae, ap = (c[:n_add] for c in add)
    lo = torch.searchsorted(bk, ak, side="left")
    hi = torch.searchsorted(bk, ak, side="right")
    width = int((hi - lo).max()) if n_add else 0
    for _ in range(width.bit_length()):
        active = lo < hi
        mid = (lo + hi) // 2
        at = mid.clamp(max=max(n_base - 1, 0))
        me, mp = be[at], bp[at]
        right = (me < ae) | ((me == ae) & (mp <= ap))
        lo = torch.where(active & right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    return lo


def merge_runs(base: Cols, n_base: int, add: Cols, n_add: int,
               cap: int) -> Cols:
    """Stable merge of two sorted runs into ``cap`` rows (sentinel tail).

    An addition row lands at its index plus its upper rank in the base; a
    base row at its index plus the number of addition rows strictly below
    it, which is the number of upper ranks <= its index. Rows equal in
    every column keep the base first. Element-identical to
    ``store.merge_into`` on the valid prefix."""
    device = base[0].device
    out = empty_cols(cap, device)
    if n_add == 0 and n_base == 0:
        return out
    rank = _upper_ranks(base, n_base, add, n_add)
    pos_a = torch.arange(n_add, device=device) + rank
    shift = torch.cumsum(torch.bincount(rank, minlength=n_base + 1), 0)
    pos_b = torch.arange(n_base, device=device) + shift[:n_base]
    for o, b, a in zip(out, base, add):
        o[pos_b] = b[:n_base]
        o[pos_a] = a[:n_add]
    return out


def search_view_key_sub(key64: torch.Tensor, ex: torch.Tensor, n: int,
                        cap: int) -> torch.Tensor:
    """``key_sub = run_start << 16 | ex`` over ``n`` sorted rows, with a
    sentinel tail to ``cap`` rows. Each row's run start is the first row
    of its key64 run: first-of-run flags, their prefix sum (the run's
    number), one scatter of each run's first row into a table by run
    number and one gather back. (``torch.cummax`` over the flagged
    positions gives the same and took 398 ms at 133M rows on the H100.)"""
    out = torch.full((cap,), SENTINEL, dtype=torch.int64, device=key64.device)
    if n:
        k = key64[:n]
        first = torch.ones(n, dtype=torch.bool, device=k.device)
        first[1:] = k[1:] != k[:-1]
        run = torch.cumsum(first, 0) - 1
        starts = torch.empty(n + 1, dtype=torch.int64, device=k.device)
        # rows that start no run write to the spare last slot
        starts[torch.where(first, run, n)] = torch.arange(n, device=k.device)
        out[:n] = starts[run] * (1 << 16) + ex[:n]
    return out


def host_cols(ix: FingerprintIndex, stride: int) -> Tuple[np.ndarray, ...]:
    """A host index's rows as (key64, ex, payload) int64 numpy columns."""
    k = (ix.key_hi.astype(np.uint64) << np.uint64(32)) | ix.key_lo.astype(np.uint64)
    return ((k ^ _SIGN).view(np.int64), ix.key_ex.astype(np.int64),
            ix.song_id.astype(np.int64) * stride + ix.offset.astype(np.int64))


def _upload(host: Tuple[np.ndarray, ...], cap: int, device) -> Cols:
    out = empty_cols(cap, device)
    n = len(host[0])
    for o, h in zip(out, host):
        o[:n] = torch.from_numpy(np.ascontiguousarray(h)).to(device)
    return out


class DeviceIndex:
    """The sorted index held on a device, absorbing additions there.

    The authoritative store of a device-resident ``SIA``: ``to_host``
    gives a ``FingerprintIndex`` for saving and stats, ``query_cols`` the
    matchers' search view (``index/store.DeviceIndex``). Not safe across
    threads by itself: ``SIA`` calls it under its ``_upload_lock``."""

    def __init__(self, cols: Cols, n_valid: int, n_songs: int,
                 max_offset: int, stride: int):
        self.cols = cols
        self.n_valid = int(n_valid)
        self.n_songs = int(n_songs)
        self.max_offset = int(max_offset)
        self.stride = int(stride)
        self._sorted_rows = self.n_valid   # rows past this: pending appends
        self._view: Optional[store.DeviceIndex] = None

    @property
    def _unsorted(self) -> bool:
        """Deferred-sort appends are pending (``finalize`` sorts them)."""
        return self._sorted_rows < self.n_valid

    @property
    def capacity(self) -> int:
        return int(self.cols[0].shape[0])

    @property
    def device(self) -> torch.device:
        return self.cols[0].device

    # ---- construction -------------------------------------------------
    @classmethod
    def from_host(cls, ix: FingerprintIndex, reserve: int = 0,
                  device="cpu") -> "DeviceIndex":
        """Upload a host index into a capacity of at least ``reserve``
        rows (one allocation for a whole ingest instead of one per
        capacity doubling)."""
        stride = ix.offset_stride
        cap = capacity_for(max(ix.n_hashes, reserve, 1))
        return cls(_upload(host_cols(ix, stride), cap, device), ix.n_hashes,
                   ix.n_songs, ix.max_offset, stride)

    # ---- layout ---------------------------------------------------------
    def _grow_to(self, rows: int) -> None:
        """Double the capacity until ``rows`` fit (into new columns, which
        no search view holds yet)."""
        cap = self.capacity
        while cap < rows:
            cap <<= 1
        if cap != self.capacity:
            out = empty_cols(cap, self.device)
            for o, c in zip(out, self.cols):
                o[: self.n_valid] = c[: self.n_valid]
            self.cols = out
            self._view = None

    def _writable(self) -> None:
        """Before a write in place: the columns of a search view already
        handed out are never written (a query may still be reading them),
        so they are copied first. Bulk appends with no query between them
        write in place."""
        if self._view is not None:
            self.cols = tuple(c.clone() for c in self.cols)
            self._view = None

    def _ensure_layout(self, max_offset: int) -> None:
        """Repack the payloads when ``max_offset`` outgrows the stride
        (the int64 payload needs no unpacked layout, whatever the
        catalog's size)."""
        new_stride = offset_stride_for(max_offset)
        if new_stride == self.stride:
            return
        self._writable()
        n = self.n_valid
        p = self.cols[2][:n]
        self.cols[2][:n] = (p // self.stride) * new_stride + p % self.stride
        self.stride = new_stride

    def _changed(self, n_valid: int, n_songs: int, max_offset: int) -> None:
        self.n_valid = n_valid
        self.n_songs = max(self.n_songs, int(n_songs))
        self.max_offset = max(self.max_offset, int(max_offset))
        self._view = None

    # ---- absorbing additions -------------------------------------------
    def merge(self, addition: FingerprintIndex) -> None:
        """Merge a sorted host addition run on the device."""
        if addition.n_hashes == 0:
            return
        self.finalize()
        self._ensure_layout(max(self.max_offset, addition.max_offset))
        add = _upload(host_cols(addition, self.stride), addition.n_hashes,
                      self.device)
        self._merge(add, addition.n_hashes)
        self._changed(self.n_valid + addition.n_hashes, addition.n_songs,
                      addition.max_offset)

    def merge_device_run(self, add_cols: Cols, n_add: int, n_songs: int,
                         max_offset: int) -> None:
        """Merge a sorted run already on the device (``device_sorted_run``
        output), built with this store's current stride: callers run
        ``_ensure_layout`` first. No host traffic but the bracket width."""
        if n_add == 0:
            return
        self.finalize()
        self._merge(add_cols, n_add)
        self._changed(self.n_valid + n_add, n_songs, max_offset)

    def _merge(self, add: Cols, n_add: int) -> None:
        """Rank-merge a sorted run into the (finalized) rows, doubling the
        capacity only when they do not fit (a span always fits)."""
        cap = capacity_for(self.n_valid + n_add, self.capacity)
        self.cols = merge_runs(self.cols, self.n_valid, add, n_add, cap)
        self._sorted_rows = self.n_valid + n_add

    def append_run(self, add_cols: Cols, n_add: int, n_songs: int,
                   max_offset: int) -> None:
        """Deferred-sort ingest: copy the run's rows behind the valid rows;
        ``finalize`` sorts them in on the next query, merge or save."""
        if n_add == 0:
            return
        start = self.n_valid
        self._grow_to(start + n_add)
        self._writable()
        for c, a in zip(self.cols, add_cols):
            c[start: start + n_add] = a[:n_add]
        self._changed(start + n_add, n_songs, max_offset)

    def finalize(self) -> None:
        """Sort pending appends into place (no-op when sorted): the tail
        is sorted alone, then rank-merged into the sorted prefix."""
        if not self._unsorted:
            return
        head, n = self._sorted_rows, self.n_valid
        tail = tuple(c[head:n] for c in self.cols)
        order = lexsort_rows(*tail)
        tail = tuple(c[order] for c in tail)
        self.cols = merge_runs(self.cols, head, tail, n - head, self.capacity)
        self._sorted_rows = n
        self._view = None

    # ---- consumption ----------------------------------------------------
    def query_cols(self) -> store.DeviceIndex:
        """The matchers' search view (``index/store.DeviceIndex``), its
        ``key_sub`` rebuilt after any change and cached until the next."""
        self.finalize()
        if self._view is None:
            key64, ex, payload = self.cols
            self._view = store.DeviceIndex(
                key64, search_view_key_sub(key64, ex, self.n_valid,
                                           self.capacity),
                payload, self.n_valid, self.stride)
        return self._view

    def _host_rows(self):
        """The sorted rows on the host (pending appends sorted in first):
        (hi, lo, ex) uint32 and the int64 payload."""
        self.finalize()
        key64, ex, payload = (c[: self.n_valid].cpu().numpy()
                              for c in self.cols)
        k = key64.view(np.uint64) ^ _SIGN
        return ((k >> np.uint64(32)).astype(np.uint32),
                (k & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                ex.astype(np.uint32), payload)

    def to_host(self) -> FingerprintIndex:
        """The rows as a host ``FingerprintIndex`` (pending appends are
        sorted in first)."""
        hi, lo, ex, payload = self._host_rows()
        return FingerprintIndex(
            hi, lo, ex, (payload // self.stride).astype(np.uint32),
            (payload % self.stride).astype(np.uint32),
            n_songs=self.n_songs, max_offset=self.max_offset)


# ---- spans ----------------------------------------------------------------
def _run_pow2(n: int) -> int:
    """Smallest power of two >= ``n``, at least 1,024: the length a run is
    trimmed to before it goes into a span, as in the JAX package."""
    return capacity_for(n, 1024)


def _stack_row(big: torch.Tensor, col: torch.Tensor, i: int) -> torch.Tensor:
    """Copy one span's column into row ``i`` of a stacked column."""
    big[i].copy_(col)
    return big


def _span_host_cols(hi, lo, ex, pp) -> Tuple[np.ndarray, ...]:
    """A span-wise file's uint32 (hi, lo, ex, pp) rows as the store's
    (key64, ex, payload) int64 columns (the payload keeps the saved
    stride)."""
    k = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((k ^ _SIGN).view(np.int64), ex.astype(np.int64),
            pp.astype(np.int64))


class SpannedDeviceStore:
    """The index as bounded sorted spans on a device: the JAX package's
    ``SpannedDeviceStore``, over a list of this module's ``DeviceIndex``
    spans, each of exactly ``span_rows`` rows.

    A flat ``DeviceIndex`` rebuilds every row into new columns on each
    merge and doubles its capacity as it grows, so its transients and its
    merge time grow with the catalog. Here ingest goes into the active
    (last) span; a run that does not fit seals it and opens a fresh one.
    No merge touches more than one span, so its time and memory are
    O(span_rows) whatever the catalog's size. Queries search every span
    and count the votes together (``match/lookup``'s spanned matchers).

    It has the flat store's ingest surface (``stride``, ``n_valid``,
    ``n_songs``, ``max_offset``, ``_ensure_layout``, ``append_run``,
    ``merge_device_run``, ``merge``, ``finalize``, ``query_cols``,
    ``to_host``). The catalog's (song, offset) payload must pack into the
    uint32 ``pp`` column of the span-wise file. Not safe across threads by
    itself: ``SIA`` calls it under its ``_upload_lock``."""

    is_spanned = True
    _COL_NAMES = ("hi", "lo", "ex", "pp")

    def __init__(self, span_rows: int, n_songs: int = 0, max_offset: int = 0,
                 stride: int = 1, device="cpu"):
        if span_rows < MIN_CAPACITY // 16:
            raise ValueError(f"span_rows {span_rows} is below the minimum "
                             f"{MIN_CAPACITY // 16}")
        if stride == 0:
            raise ValueError("SpannedDeviceStore requires the packed "
                             "4-column layout (stride > 0)")
        self.span_rows = int(span_rows)
        self.n_songs = int(n_songs)
        self.max_offset = int(max_offset)
        self.stride = int(stride)
        self._device = torch.device(device)
        self.spans: List[DeviceIndex] = [self._new_span()]
        # consolidate(): (key64, ex, payload, key_sub), each (n_spans,
        # span_rows), and the stacked search view over them
        self._stacked: Optional[Tuple[torch.Tensor, ...]] = None
        self._stacked_valids: List[int] = []
        self._stacked_view: Optional[store.DeviceIndex] = None
        self.host_staged = 0   # consolidations finished through the host

    # ---- construction -------------------------------------------------
    @classmethod
    def from_host(cls, ix: FingerprintIndex, span_rows: int, reserve: int = 0,
                  device="cpu") -> "SpannedDeviceStore":
        """Upload a host index cut into contiguous sorted spans.
        ``reserve`` is taken for ``DeviceIndex.from_host``'s signature and
        unused: a span's capacity is fixed."""
        if ix.n_hashes and not packed_stride_for(ix.max_offset, ix.n_songs):
            raise ValueError(
                "SpannedDeviceStore requires the packed payload layout; "
                "use DeviceIndex / the by-song sharded regime instead")
        stride = ix.offset_stride
        out = cls(span_rows, ix.n_songs, ix.max_offset, stride, device)
        cols = host_cols(ix, stride)
        for start in range(0, ix.n_hashes, span_rows):
            part = tuple(c[start: start + span_rows] for c in cols)
            span = DeviceIndex(_upload(part, span_rows, out.device),
                               len(part[0]), ix.n_songs, ix.max_offset, stride)
            if out.spans[-1].n_valid == 0:
                out.spans[-1] = span
            else:
                out.spans.append(span)
        return out

    # ---- shared-surface properties ------------------------------------
    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def n_valid(self) -> int:
        return sum(self._stacked_valids) + sum(s.n_valid for s in self.spans)

    @property
    def capacity(self) -> int:
        """Rows the spans hold, real and sentinel."""
        n_spans = len(self._stacked_valids) + len(self.spans)
        return n_spans * self.span_rows

    @property
    def is_stacked(self) -> bool:
        return self._stacked is not None

    @property
    def active(self) -> DeviceIndex:
        return self.spans[-1]

    @property
    def _unsorted(self) -> bool:
        """A span holds deferred-sort appends (``finalize`` sorts them)."""
        return any(s._unsorted for s in self.spans)

    def _new_span(self) -> DeviceIndex:
        return DeviceIndex(empty_cols(self.span_rows, self.device), 0,
                           self.n_songs, self.max_offset, self.stride)

    def _seal_active(self) -> None:
        """Sort the active span into its final order and open a fresh one."""
        self.active.finalize()
        self.spans.append(self._new_span())

    def _ensure_layout(self, max_offset: int, n_songs: int = 0) -> None:
        """Repack every span when catalog growth changes the stride:
        queries assume one stride across the spans."""
        n_songs = max(self.n_songs, int(n_songs))
        max_offset = max(self.max_offset, int(max_offset))
        new_stride = packed_stride_for(max_offset, n_songs)
        if new_stride == 0:
            raise ValueError(
                f"catalog ({n_songs} songs x offset {max_offset}) exceeds "
                "the packed uint32 payload; spanned device residency "
                "cannot hold it — use the by-song sharded regime")
        if self.is_stacked and new_stride != self.stride:
            raise ValueError(
                "store is consolidated; a layout change (stride "
                f"{self.stride} -> {new_stride}) cannot be applied to "
                "the stacked arrays")
        for s in self.spans:
            s.n_songs = max(s.n_songs, n_songs)
            s.max_offset = max(s.max_offset, max_offset)
            s._ensure_layout(max_offset)
        self.stride = new_stride
        self.n_songs = n_songs
        self.max_offset = max_offset

    # ---- ingest --------------------------------------------------------
    def _fit_or_roll(self, need_rows: int) -> DeviceIndex:
        """The span a run of ``need_rows`` rows goes into: the active one,
        or a fresh one when it does not fit there."""
        if self.is_stacked:
            raise ValueError(
                "store is consolidated (stacked serving layout); "
                "re-opening for ingest is not supported — keep the "
                "per-span layout while the catalog is still growing")
        if need_rows > self.span_rows:
            raise ValueError(
                f"one addition run ({need_rows} rows incl. padding) "
                f"exceeds span_rows {self.span_rows}; raise span_rows or "
                "split the batch")
        if self.active.n_valid + need_rows > self.span_rows:
            self._seal_active()
        return self.active

    def _absorbed(self, span: DeviceIndex) -> None:
        self.n_songs = max(self.n_songs, span.n_songs)
        self.max_offset = max(self.max_offset, span.max_offset)

    def append_run(self, add_cols: Cols, n_add: int, n_songs: int,
                   max_offset: int) -> None:
        """Deferred-sort ingest into the active span (``DeviceIndex.
        append_run``). The run is trimmed to a power of two (at least
        1,024 rows) and takes that much room, as the JAX package's padded
        copy does, so both packages roll their spans at the same runs."""
        if n_add == 0:
            return
        self._ensure_layout(max_offset, n_songs)
        run_len = min(_run_pow2(n_add), add_cols[0].shape[0])
        span = self._fit_or_roll(run_len)
        span.append_run(add_cols, n_add, self.n_songs, self.max_offset)
        self._absorbed(span)

    def merge_device_run(self, add_cols: Cols, n_add: int, n_songs: int,
                         max_offset: int) -> None:
        """Rank-merge a sorted device run into the active span: only its
        ``n_add`` real rows take room."""
        if n_add == 0:
            return
        self._ensure_layout(max_offset, n_songs)
        span = self._fit_or_roll(n_add)
        span.merge_device_run(add_cols, n_add, self.n_songs, self.max_offset)
        self._absorbed(span)

    def merge(self, addition: FingerprintIndex) -> None:
        """Absorb a sorted host addition, in pieces of ``span_rows // 2``
        rows."""
        if addition.n_hashes == 0:
            return
        self._ensure_layout(addition.max_offset, addition.n_songs)
        chunk = self.span_rows // 2
        for start in range(0, addition.n_hashes, chunk):
            sl = slice(start, start + chunk)
            piece = FingerprintIndex(
                addition.key_hi[sl], addition.key_lo[sl],
                addition.key_ex[sl], addition.song_id[sl],
                addition.offset[sl], n_songs=self.n_songs,
                max_offset=self.max_offset)
            span = self._fit_or_roll(piece.n_hashes)
            span.merge(piece)
            self._absorbed(span)

    def finalize(self) -> None:
        for s in self.spans:
            s.finalize()

    # ---- consumption ---------------------------------------------------
    def query_cols(self):
        """The matchers' search views: a tuple of per-span
        ``index/store.DeviceIndex`` views (each sealed span's built once
        and cached; an empty store still gives one), or, consolidated, one
        view whose columns are (n_spans, span_rows) with span-local
        ``key_sub`` positions."""
        if self.is_stacked:
            return self._stacked_view
        self.finalize()
        live = [s for s in self.spans if s.n_valid > 0] or self.spans[-1:]
        return tuple(s.query_cols() for s in live)

    def _live_spans(self) -> List[DeviceIndex]:
        """Each non-empty span as a ``DeviceIndex``, per span or stacked
        (a stacked row's columns are views of the stacked ones)."""
        self.finalize()
        if self.is_stacked:
            return [DeviceIndex(tuple(c[i] for c in self._stacked[:3]), nv,
                                self.n_songs, self.max_offset, self.stride)
                    for i, nv in enumerate(self._stacked_valids) if nv > 0]
        return [s for s in self.spans if s.n_valid > 0]

    def to_host(self) -> FingerprintIndex:
        """One globally sorted host index: each span's rows, concatenated
        and lexsorted on the host (equal rows are interchangeable, so this
        is the flat store's index row for row)."""
        parts = [s.to_host() for s in self._live_spans()]
        if not parts:
            return FingerprintIndex(
                *(np.zeros(0, np.uint32) for _ in range(5)),
                n_songs=self.n_songs, max_offset=self.max_offset)
        cat = [np.concatenate([getattr(p, f) for p in parts])
               for f in ("key_hi", "key_lo", "key_ex", "song_id", "offset")]
        order = np.lexsort((cat[4], cat[3], cat[2], cat[1], cat[0]))
        return FingerprintIndex(*(a[order] for a in cat),
                                n_songs=self.n_songs,
                                max_offset=self.max_offset)

    # ---- the span-wise file ------------------------------------------
    def save(self, path: str) -> None:
        """Write the JAX package's span-wise file: an uncompressed npz of
        ``spanned_meta = [span_rows, stride, n_songs, max_offset]`` (int64)
        and, per non-empty span, its valid rows as ``s{i:05d}_hi|lo|ex|pp``
        uint32 columns (``pp = song * stride + offset``). No global sort:
        each span is sorted, which is all the format asks."""
        arrays = {"spanned_meta": np.array(
            [self.span_rows, self.stride, self.n_songs, self.max_offset],
            np.int64)}
        for i, span in enumerate(self._live_spans()):
            hi, lo, ex, payload = span._host_rows()
            for name, col in zip(self._COL_NAMES,
                                 (hi, lo, ex, payload.astype(np.uint32))):
                arrays[f"s{i:05d}_{name}"] = col
        atomic_savez(path, compress=False, **arrays)

    @classmethod
    def load(cls, path: str, span_rows: int = 0, stacked: bool = False,
             device="cpu") -> "SpannedDeviceStore":
        """A store from a span-wise file, upload only: each saved span is
        cut into spans of ``span_rows`` rows (default: as saved; a cut of
        a sorted span is sorted), and nothing is sorted on either side.
        ``stacked=True`` builds ``consolidate``'s layout straight from the
        file, so the per-span columns never exist on the device; like any
        consolidated store it is closed to ingest."""
        with np.load(path) as z:
            saved_rows, stride, n_songs, max_off = (
                int(x) for x in z["spanned_meta"])
            span_rows = span_rows or saved_rows
            out = cls(span_rows, n_songs, max_off, max(stride, 1), device)
            pieces = []   # one per device span: its host rows
            i = 0
            while f"s{i:05d}_hi" in z:
                cols = _span_host_cols(*(np.asarray(z[f"s{i:05d}_{n}"])
                                         for n in cls._COL_NAMES))
                for start in range(0, len(cols[0]), span_rows):
                    pieces.append(tuple(c[start: start + span_rows]
                                        for c in cols))
                i += 1
        dev = out.device
        if stacked and pieces:
            n = len(pieces)
            big = tuple(torch.full((n, span_rows), fill, dtype=torch.int64,
                                   device=dev)
                        for fill in (SENTINEL, SENTINEL, 0))
            for r, piece in enumerate(pieces):
                for b, h in zip(big, piece):
                    b[r, : len(h)] = torch.from_numpy(h).to(dev)
            valids = [len(p[0]) for p in pieces]
            key_sub = torch.empty((n, span_rows), dtype=torch.int64,
                                  device=dev)
            for r, nv in enumerate(valids):
                key_sub[r] = search_view_key_sub(big[0][r], big[1][r], nv,
                                                 span_rows)
            out._set_stacked((*big, key_sub), valids)
            return out
        out.spans = [DeviceIndex(_upload(p, span_rows, dev), len(p[0]),
                                 n_songs, max_off, out.stride)
                     for p in pieces] or [out._new_span()]
        return out

    @staticmethod
    def load_flat(path: str) -> FingerprintIndex:
        """A span-wise file as one sorted host index, without the device."""
        return load_spanned_flat(path)

    # ---- the stacked serving layout --------------------------------------
    def _set_stacked(self, cols: Tuple[torch.Tensor, ...],
                     valids: List[int]) -> None:
        key64, _ex, payload, key_sub = cols
        self._stacked = tuple(cols)
        self._stacked_valids = list(valids)
        self._stacked_view = store.DeviceIndex(key64, key_sub, payload,
                                               sum(valids), self.stride)
        self.spans = []

    def consolidate(self) -> None:
        """Stack the spans into (n_spans, span_rows) serving columns:
        key64, ex, payload and the spans' search views' ``key_sub``.

        Column by column: the stacked column is allocated first, the
        spans' rows are copied in, and after a sync the spans' sources of
        that column are released, so the device holds the catalog and
        one stacked column at most. When the device runs out of memory
        (``torch.cuda.OutOfMemoryError``), the remaining columns are
        staged through host memory (each span's column downloaded and
        released, then the stacked one uploaded), which is counted in
        ``host_staged`` and printed. Any other fault rolls back to the
        per-span layout whole. Closed to ingest afterwards."""
        if self.is_stacked:
            return
        self.finalize()
        live = [s for s in self.spans if s.n_valid > 0] or self.spans[-1:]
        # every column's sources, the search views' key_sub included;
        # only this list holds them from here on, so a column is freed
        # once its entries are dropped
        srcs = [[*s.cols, s.query_cols().key_sub] for s in live]
        for s in live:
            s.cols, s._view = None, None
        stacked: List[torch.Tensor] = []
        oom = False
        try:
            self._consolidate_columns(srcs, stacked)
        except torch.cuda.OutOfMemoryError:
            oom = True
        except BaseException:
            self._restore_spans(live, srcs, stacked)
            raise
        if oom:
            # outside the except block: its traceback would keep the
            # failed stacked column alive through the host pass
            print(f"SpannedDeviceStore.consolidate: device memory ran out "
                  f"after {len(stacked)} of {len(srcs[0])} stacked columns; "
                  "staging the rest through host memory", file=sys.stderr,
                  flush=True)
            try:
                self._consolidate_via_host(srcs, stacked)
            except BaseException:
                self._restore_spans(live, srcs, stacked)
                raise
            self.host_staged += 1
        self._set_stacked(tuple(stacked), [s.n_valid for s in live])

    def _consolidate_columns(self, srcs, stacked) -> None:
        n = len(srcs)
        for c in range(len(srcs[0])):
            big = torch.empty((n, self.span_rows), dtype=torch.int64,
                              device=self.device)
            for i, row in enumerate(srcs):
                big = _stack_row(big, row[c], i)
            # a fault surfaces at the sync: release the sources only after
            if big.is_cuda:
                torch.cuda.synchronize(big.device)
            stacked.append(big)
            for row in srcs:
                row[c] = None

    def _consolidate_via_host(self, srcs, stacked) -> None:
        """The columns not stacked yet, staged through host memory: each
        span's column downloaded and released, then the stacked column
        uploaded. The device never holds more than the catalog."""
        for c in range(len(stacked), len(srcs[0])):
            rows = []
            try:
                for row in srcs:
                    rows.append(row[c].cpu())
                    row[c] = None
                stacked.append(torch.stack(rows).to(self.device))
            except BaseException:
                for row, h in zip(srcs, rows):
                    if row[c] is None:
                        row[c] = h.to(self.device)
                raise

    def _restore_spans(self, live, srcs, stacked) -> None:
        """Put the per-span layout back after a fault: a released source
        comes back from its stacked copy (row i of stacked column c is
        span i's column c), each stacked column downloaded whole and
        freed before its rows go up again, so that the restore needs no
        more device memory than the catalog."""
        for c in range(len(stacked)):
            if any(row[c] is None for row in srcs):
                host = stacked[c].cpu()
                stacked[c] = None
                for i, row in enumerate(srcs):
                    if row[c] is None:
                        row[c] = host[i].to(self.device)
        for s, row in zip(live, srcs):
            s.cols = tuple(row[:3])
            s._view = None


def is_spanned_file(path: str) -> bool:
    """True when ``path`` is a span-wise ``.npz`` (the JAX package's
    ``SpannedDeviceStore.save``), not the flat ``FingerprintIndex`` one."""
    try:
        with np.load(path) as z:
            return "spanned_meta" in z
    except Exception:   # noqa: BLE001 — not an npz we can read: not spanned
        return False


def load_spanned_flat(path: str) -> FingerprintIndex:
    """A span-wise file as ONE sorted host index (the JAX package's
    ``SpannedDeviceStore.load_flat``): each span's valid rows, their
    packed payloads decoded with the saved stride, concatenated and
    lexsorted."""
    with np.load(path) as z:
        stride, n_songs, max_off = (int(x) for x in z["spanned_meta"][1:])
        parts = {n: [] for n in SpannedDeviceStore._COL_NAMES}
        i = 0
        while f"s{i:05d}_hi" in z:
            for n in parts:
                parts[n].append(np.asarray(z[f"s{i:05d}_{n}"]))
            i += 1
    cat = {n: (np.concatenate(p) if p else np.zeros(0, np.uint32))
           for n, p in parts.items()}
    stride = np.uint32(max(stride, 1))
    sid = (cat["pp"] // stride).astype(np.uint32)
    off = (cat["pp"] & (stride - np.uint32(1))).astype(np.uint32)
    order = np.lexsort((off, sid, cat["ex"], cat["lo"], cat["hi"]))
    return FingerprintIndex(
        cat["hi"][order].astype(np.uint32), cat["lo"][order].astype(np.uint32),
        cat["ex"][order].astype(np.uint32), sid[order], off[order],
        n_songs=n_songs, max_offset=max_off)
