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

Spans. The JAX package's ``SpannedDeviceStore`` holds the index as many
bounded sorted spans, because its TPU worker killed long device programs
and its HBM was 16 GB. On an 80 GB card one flat store holds the
reference's largest deployment (436,682,654 rows), so the port keeps the
spans' API and file format over this flat store: ``save_spanned`` writes
the sorted rows in the span-wise format, ``load_spanned`` uploads such a
file straight into a store (the device sorts it only when its spans
overlap, as the JAX package's do), ``load_spanned_flat`` flattens one on
the host, and ``check_spanned`` refuses what ``SpannedDeviceStore``
refuses.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import store
from .store import FingerprintIndex, atomic_savez, offset_stride_for

SENTINEL = np.iinfo(np.int64).max
MIN_CAPACITY = 1 << 16
_SIGN = np.uint64(1 << 63)
_SPAN_COLUMNS = ("hi", "lo", "ex", "pp")

Cols = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # key64, ex, payload


def capacity_for(n: int) -> int:
    """Power-of-two row capacity for ``n`` rows, at least 2^16."""
    c = MIN_CAPACITY
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


def check_spanned(span_rows: int, n_songs: int, max_offset: int,
                  n_rows: int) -> None:
    """Refuse what the JAX package's ``SpannedDeviceStore`` refuses, with
    its errors: spans under ``MIN_CAPACITY // 16`` rows, and a non-empty
    catalog whose (song, offset) payload does not pack into the uint32
    ``pp`` column of the span-wise file."""
    if span_rows < MIN_CAPACITY // 16:
        raise ValueError(f"span_rows {span_rows} is below the minimum "
                         f"{MIN_CAPACITY // 16}")
    if n_rows and not packed_stride_for(max_offset, n_songs):
        raise ValueError(
            f"catalog ({n_songs} songs x offset {max_offset}) exceeds the "
            "packed uint32 payload; a spanned store requires the packed "
            "payload layout")


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
        """Rank-merge a sorted run into the (finalized) rows."""
        cap = capacity_for(max(self.capacity, self.n_valid + n_add))
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


# ---- the JAX package's span-wise file format ------------------------------
def save_spanned(dstore: DeviceIndex, path: str, span_rows: int) -> None:
    """Write a store in the span-wise format of the JAX package's
    ``SpannedDeviceStore.save``: an uncompressed npz of ``spanned_meta =
    [span_rows, stride, n_songs, max_offset]`` (int64) and
    ``s{i:05d}_hi|lo|ex|pp`` uint32 columns (``pp = song * stride +
    offset``), the sorted rows cut into chunks of ``span_rows`` rows, the
    last one partial. Every chunk is sorted, which is all the format asks
    of a span; here their concatenation is sorted too."""
    hi, lo, ex, payload = dstore._host_rows()
    check_spanned(span_rows, dstore.n_songs, dstore.max_offset, len(hi))
    pp = payload.astype(np.uint32)   # packable, checked above
    arrays = {"spanned_meta": np.array(
        [span_rows, dstore.stride, dstore.n_songs, dstore.max_offset],
        np.int64)}
    for i, start in enumerate(range(0, len(hi), span_rows)):
        for name, col in zip(_SPAN_COLUMNS, (hi, lo, ex, pp)):
            arrays[f"s{i:05d}_{name}"] = col[start: start + span_rows]
    atomic_savez(path, compress=False, **arrays)


def load_spanned(path: str, device, reserve: int = 0) -> DeviceIndex:
    """A span-wise file straight into a device store, with no host sort:
    the spans' rows are uploaded one behind the other (payloads repacked
    when the store's stride differs from the saved one), and only when
    their concatenation is not sorted, as where the JAX package's spans
    overlap in key range, does the device sort it (``finalize``)."""
    spans = []
    with np.load(path) as z:
        stride, n_songs, max_off = (int(x) for x in z["spanned_meta"][1:])
        while f"s{len(spans):05d}_hi" in z:
            spans.append([np.asarray(z[f"s{len(spans):05d}_{n}"])
                          for n in _SPAN_COLUMNS])
    n = sum(len(cols[0]) for cols in spans)
    out = empty_cols(capacity_for(max(n, reserve, 1)), device)
    start = 0
    for hi, lo, ex, pp in spans:
        k = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
        for o, h in zip(out, ((k ^ _SIGN).view(np.int64), ex.astype(np.int64),
                              pp.astype(np.int64))):
            o[start: start + len(h)] = torch.from_numpy(h).to(device)
        start += len(hi)
    loaded = DeviceIndex(out, n, n_songs, max_off, max(stride, 1))
    loaded._ensure_layout(max_off)
    if not bool(rows_sorted(*(c[:n] for c in out))):
        loaded._sorted_rows = 0
        loaded.finalize()
    return loaded


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
        parts = {n: [] for n in _SPAN_COLUMNS}
        i = 0
        while f"s{i:05d}_hi" in z:
            for n in _SPAN_COLUMNS:
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
