"""Sorted fingerprint index: host numpy store + its device search layout.

The catalog's hash rows live as five parallel uint32 numpy arrays sorted
lexicographically by (key_hi, key_lo, key_ex, song_id, offset), the JAX
package's ``FingerprintIndex`` (same fields, same sort, same ``.npz``
file, so an index saved by either package loads in the other). Index
construction and merging are host work done once per ingest; queries
read ``device_arrays(device)``.

The device layout carries what the search needs as int64 columns
(``DeviceIndex``): the 80-bit keys become a sign-flipped 64-bit
``(hi, lo)`` key plus a run-refined ``ex`` key, so ``torch.searchsorted``
finds exact lexicographic bounds (see ``index/search.py``), and the
payload packs ``song_id * stride + offset`` into one column. Capacity is
rounded up to a multiple of 512 with sentinel rows that no real key
equals (``FingerprintIndex.device_arrays`` of the JAX package pads the
same way).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Iterable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

CAPACITY_MULTIPLE = 512
_SIGN = np.uint64(1 << 63)
_INT64_MAX = np.iinfo(np.int64).max


def offset_stride_for(max_offset: int) -> int:
    """Power-of-two payload stride above ``max_offset``: the packed payload
    is ``song_id * stride + offset`` and decodes with // and %."""
    stride = 1
    while stride <= max_offset:
        stride <<= 1
    return stride


class DeviceIndex(NamedTuple):
    """The index on a device, sized to a multiple of 512 rows."""

    key64: torch.Tensor    # int64 (cap,) (hi << 32 | lo) ^ 2^63, sorted
    key_sub: torch.Tensor  # int64 (cap,) run_start << 16 | ex, sorted
    payload: torch.Tensor  # int64 (cap,) song_id * stride + offset
    n_rows: int            # real rows; the rest are sentinels
    stride: int            # payload stride (power of two)


def search_keys(hi: np.ndarray, lo: np.ndarray, ex: np.ndarray):
    """Sorted (hi, lo, ex) rows -> (key64, key_sub) int64 numpy columns.

    ``key64`` flips the sign bit of the unsigned 64-bit (hi, lo) key so
    signed order equals unsigned order; ``key_sub`` puts each row's ex
    after the index of the first row sharing its key64, which keeps it
    globally sorted and makes a within-run ex search one searchsorted.
    """
    k = ((hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64))
    key64 = (k ^ _SIGN).view(np.int64)
    n = len(k)
    first = np.ones(n, bool)
    first[1:] = k[1:] != k[:-1]
    run_start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
    key_sub = (run_start.astype(np.int64) << 16) | ex.astype(np.int64)
    return key64, key_sub


def atomic_savez(path: str, compress: bool = True, **arrays) -> None:
    """``np.savez_compressed`` (``np.savez`` when not ``compress``) to a
    temp file, fsync, then atomic replace (readers see the old file or the
    new one, never a torn write)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               suffix=".npz.tmp")
    try:
        umask = os.umask(0)
        os.umask(umask)
        os.chmod(tmp, 0o666 & ~umask)
        with os.fdopen(fd, "wb") as fh:
            (np.savez_compressed if compress else np.savez)(fh, **arrays)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


@dataclasses.dataclass
class FingerprintIndex:
    """Sorted fingerprint store (numpy on host; ``device_arrays`` uploads)."""

    key_hi: np.ndarray
    key_lo: np.ndarray
    key_ex: np.ndarray
    song_id: np.ndarray
    offset: np.ndarray
    n_songs: int
    max_offset: int  # largest stored frame offset (sets the delta range)

    def __post_init__(self):
        n = len(self.key_hi)
        for arr in (self.key_lo, self.key_ex, self.song_id, self.offset):
            if len(arr) != n:
                raise ValueError("index arrays must be parallel")

    @property
    def n_hashes(self) -> int:
        return int(len(self.key_hi))

    @property
    def offset_stride(self) -> int:
        return offset_stride_for(self.max_offset)

    def device_arrays(self, device) -> DeviceIndex:
        """Upload the search layout to ``device`` (>= 512 rows, sentinel
        padded to a multiple of 512)."""
        n = self.n_hashes
        cap = max(-(-n // CAPACITY_MULTIPLE), 1) * CAPACITY_MULTIPLE
        key64, key_sub = search_keys(self.key_hi, self.key_lo, self.key_ex)
        stride = self.offset_stride
        payload = (self.song_id.astype(np.int64) * stride
                   + self.offset.astype(np.int64))

        def up(a, fill):
            out = np.full(cap, fill, np.int64)
            out[:n] = a
            return torch.from_numpy(out).to(device)

        return DeviceIndex(up(key64, _INT64_MAX), up(key_sub, _INT64_MAX),
                           up(payload, 0), n, stride)

    # ---- persistence (the JAX package's .npz layout) ----
    def save(self, path: str) -> None:
        atomic_savez(
            path,
            key_hi=self.key_hi, key_lo=self.key_lo, key_ex=self.key_ex,
            song_id=self.song_id, offset=self.offset,
            meta=np.array([self.n_songs, self.max_offset], np.int64),
        )

    @classmethod
    def load(cls, path: str) -> "FingerprintIndex":
        with np.load(path) as z:
            return cls(
                key_hi=z["key_hi"], key_lo=z["key_lo"], key_ex=z["key_ex"],
                song_id=z["song_id"], offset=z["offset"],
                n_songs=int(z["meta"][0]), max_offset=int(z["meta"][1]),
            )

    def hashes_per_song(self) -> np.ndarray:
        return np.bincount(self.song_id,
                           minlength=self.n_songs + 1).astype(np.int64)


def from_numpy(key_hi, key_lo, key_ex, song_id, offset, n_songs: int,
               max_offset: int) -> FingerprintIndex:
    """A ``FingerprintIndex`` over already-sorted host columns (e.g. the
    JAX package's ``FingerprintIndex`` fields)."""
    cols = [np.asarray(a, np.uint32)
            for a in (key_hi, key_lo, key_ex, song_id, offset)]
    return FingerprintIndex(*cols, n_songs=int(n_songs),
                            max_offset=int(max_offset))


def _sort_entries(hi, lo, ex, sid, off):
    order = np.lexsort((off, sid, ex, lo, hi))
    return hi[order], lo[order], ex[order], sid[order], off[order]


def build_index(
    per_song: Sequence[Tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    n_songs: Optional[int] = None,
) -> FingerprintIndex:
    """Build a sorted index from per-song fingerprint arrays.

    :param per_song: iterable of (song_id, hi, lo, ex, offsets), already
        deduped per song (``fingerprints_to_pairs``).
    :param n_songs: catalog size; defaults to max song_id + 1.
    """
    his, los, exs, sids, offs = [], [], [], [], []
    for sid, hi, lo, ex, off in per_song:
        his.append(np.asarray(hi, np.uint32))
        los.append(np.asarray(lo, np.uint32))
        exs.append(np.asarray(ex, np.uint32))
        offs.append(np.asarray(off, np.uint32))
        sids.append(np.full(len(hi), sid, np.uint32))
    if his:
        hi, lo, ex = np.concatenate(his), np.concatenate(los), np.concatenate(exs)
        sid, off = np.concatenate(sids), np.concatenate(offs)
    else:
        hi = lo = ex = sid = off = np.zeros(0, np.uint32)
    hi, lo, ex, sid, off = _sort_entries(hi, lo, ex, sid, off)
    ns = n_songs if n_songs is not None else (int(sid.max()) + 1 if len(sid) else 0)
    max_off = int(off.max()) if len(off) else 0
    return FingerprintIndex(hi, lo, ex, sid, off, ns, max_off)


def merge_into(base: FingerprintIndex, addition: FingerprintIndex) -> FingerprintIndex:
    """Two-run sorted merge in ~O(n), no full re-sort of the catalog.

    Both runs are merged on the packed 64-bit (hi, lo) key with two
    searchsorteds; rows where equal (hi, lo) keys from both runs collide
    get a local repair lexsort restoring (ex, sid, off) order. The output
    equals a full lexsort of the concatenated rows.
    """
    if base.n_hashes == 0 or addition.n_hashes == 0:
        keep = base if addition.n_hashes == 0 else addition
        return FingerprintIndex(
            keep.key_hi, keep.key_lo, keep.key_ex, keep.song_id, keep.offset,
            n_songs=max(base.n_songs, addition.n_songs),
            max_offset=max(base.max_offset, addition.max_offset),
        )
    kb = (base.key_hi.astype(np.uint64) << 32) | base.key_lo
    ka = (addition.key_hi.astype(np.uint64) << 32) | addition.key_lo
    nb, na = len(kb), len(ka)
    n = nb + na
    pos_b = np.arange(nb, dtype=np.int64) + np.searchsorted(ka, kb, "left")
    pos_a = np.arange(na, dtype=np.int64) + np.searchsorted(kb, ka, "right")

    cols = []
    for name in ("key_hi", "key_lo", "key_ex", "song_id", "offset"):
        out = np.empty(n, np.uint32)
        out[pos_b] = getattr(base, name)
        out[pos_a] = getattr(addition, name)
        cols.append(out)
    hi, lo, ex, sid, off = cols

    # inside equal-(hi, lo) runs the minor order must be (ex, sid, off)
    k = (hi.astype(np.uint64) << 32) | lo
    same = k[1:] == k[:-1]
    disorder = same & (
        (ex[1:] < ex[:-1])
        | ((ex[1:] == ex[:-1]) & (sid[1:] < sid[:-1]))
        | ((ex[1:] == ex[:-1]) & (sid[1:] == sid[:-1]) & (off[1:] < off[:-1]))
    )
    if disorder.any():
        run_id = np.zeros(n, np.int64)
        run_id[1:] = np.cumsum(~same)
        starts = np.concatenate([[0], np.nonzero(~same)[0] + 1])
        ends = np.concatenate([starts[1:], [n]])
        bad = np.unique(run_id[1:][disorder])
        delta = np.zeros(n + 1, np.int64)
        delta[starts[bad]] += 1
        delta[ends[bad]] -= 1
        mask = np.cumsum(delta[:-1]) > 0
        idx = np.nonzero(mask)[0]
        sub = np.lexsort((off[idx], sid[idx], ex[idx], run_id[idx]))
        for arr in cols:
            arr[idx] = arr[idx][sub]

    return FingerprintIndex(
        hi, lo, ex, sid, off,
        n_songs=max(base.n_songs, addition.n_songs),
        max_offset=max(base.max_offset, addition.max_offset),
    )


def merge_indices(indices: Iterable[FingerprintIndex]) -> FingerprintIndex:
    """Merge sorted indices by one full sort of their concatenated rows
    (``merge_into`` gives the same arrays for two runs in ~O(n))."""
    indices = [ix for ix in indices if ix.n_hashes > 0]
    if not indices:
        return FingerprintIndex(*(np.zeros(0, np.uint32),) * 5, n_songs=0,
                                max_offset=0)
    cols = _sort_entries(*(np.concatenate([getattr(ix, name) for ix in indices])
                           for name in ("key_hi", "key_lo", "key_ex",
                                        "song_id", "offset")))
    return FingerprintIndex(
        *cols, n_songs=max(ix.n_songs for ix in indices),
        max_offset=max(ix.max_offset for ix in indices))
