"""K3 wrapper: peak-mask bits -> ordered peak list (``csrc/compact.cu``).

Replaces the Pallas kernel ``shazam_tpu/ops/pallas/compact.py``
(``_ff_kernel``/``_tile_segment``, behind ``compact_candidates``). CPU
tensors take the plain twin ``ops.peaks.compact_plain``; CUDA tensors
launch the kernel or raise.

The kernel spreads each song over tiles of ``TILE_FRAMES`` frames joined
by a decoupled look-back scan, and zeroes the rows past the count with
one extra block per ``FILL_SLOTS`` slots. Its scratch (a ticket counter
and one status word per tile) belongs to this module: one int64 tensor
per (device, stream), grown on demand and never cleared per call, because
each call tags its status words with an epoch of its own and passes the
ticket count the earlier calls left (:class:`LookBackScratch`). Both
numbers are fixed on the host at launch, so a launch replayed from a
CUDA graph would reuse them: :func:`compact` refuses to be captured.

Threads share the scratch of their stream (every thread of a process
starts on the device's default stream), so taking the ticket base and
epoch, the launch and advancing the base are one critical section under
the scratch's lock (:meth:`LookBackScratch.launch`): two launches never
get the same ticket base or epoch.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..._build import Kernel, raw_stream
from ..peaks import MASK_WORDS, compact_plain

# csrc/compact.cu's kTile and kFillSlots: a launch takes B * (ceil(T /
# TILE_FRAMES) + ceil(capacity / FILL_SLOTS)) tickets
TILE_FRAMES = 16    # frames per block, one warp each (measured: PERF.md §6)
FILL_SLOTS = 2048   # output slots per block that zeroes past the count
MAX_SONG_PEAKS = (1 << 30) - 1  # a status word's 30-bit value field
N_BINS = 2049

KERNEL = Kernel(
    "compact", "shz_compact",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_uint, ctypes.c_uint])


class LookBackScratch:
    """The look-back's scratch on one stream: ``words[0]`` is the ticket
    counter and ``words[1 + i]`` tile i's status word.

    Calls on one stream run in order, so the counter holds the sum of the
    blocks launched so far (mod 2^32), which ``base`` mirrors on the host.
    Epochs run 1, 2, ...; a word still 0, or left by an earlier call,
    reads as unpublished. When the epoch would wrap, the words past the
    counter are zeroed once and the epochs start again at 1.
    """

    EPOCHS = 1 << 32

    def __init__(self, device):
        self.device = torch.device(device)
        self.words = torch.zeros(0, dtype=torch.int64, device=self.device)
        self.base = 0
        self.epoch = 0
        self.lock = threading.Lock()

    def launch(self, n_tiles: int, n_blocks: int, fn) -> None:
        """:meth:`take`, ``fn(words, base, epoch)`` (the launch of
        ``n_blocks`` blocks over ``n_tiles`` tiles) and :meth:`commit`,
        all under the lock, so that launches from several threads get
        distinct ticket bases and epochs."""
        with self.lock:
            words, base, epoch = self.take(n_tiles)
            fn(words, base, epoch)
            self.commit(n_blocks)

    def take(self, n_tiles: int):
        """(words, ticket base, epoch) for a launch of ``n_tiles`` tiles;
        call :meth:`commit` with its block count once it launched."""
        if self.words.numel() < 1 + n_tiles:
            size = max(1 + n_tiles, 2 * self.words.numel())
            self.words = torch.zeros(size, dtype=torch.int64,
                                     device=self.device)
            self.base = 0
        self.epoch += 1
        if self.epoch == self.EPOCHS:
            self.words[1:].zero_()
            self.epoch = 1
        return self.words, self.base, self.epoch

    def commit(self, n_blocks: int) -> None:
        self.base = (self.base + n_blocks) % (1 << 32)


_SCRATCH: dict = {}
_SCRATCH_LOCK = threading.Lock()


def _scratch(device: torch.device, stream: int) -> LookBackScratch:
    key = (device.index, stream)
    with _SCRATCH_LOCK:
        if key not in _SCRATCH:
            _SCRATCH[key] = LookBackScratch(device)
        return _SCRATCH[key]


def compact(bits: torch.Tensor, capacity: int):
    """int32 (B, T, 65) mask bits -> (times, freqs, n_peaks), all int32.

    times/freqs are (B, capacity) in (t, f) order, zeros past the count;
    n_peaks (B,) is the exact peak count (> capacity = overflow).
    """
    if capacity <= 0:
        raise ValueError("capacity must be positive")
    dev = bits.device
    if dev.type == "cpu":
        return compact_plain(bits, capacity)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if bits.dtype != torch.int32 or bits.dim() != 3 \
            or bits.shape[2] != MASK_WORDS or not bits.is_contiguous():
        raise ValueError("bits must be a contiguous (B, T, 65) int32 tensor")
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("K3 cannot be captured in a CUDA graph: its "
                           "ticket base and epoch are fixed at launch")
    bsz, t, _ = bits.shape
    tiles = bsz * -(-t // TILE_FRAMES)
    blocks = tiles + bsz * -(-capacity // FILL_SLOTS) if t else 0
    if t * N_BINS > MAX_SONG_PEAKS or blocks >= 1 << 31:
        raise ValueError(f"{bsz} x {t} frames exceed K3's counters")
    times = torch.empty((bsz, capacity), dtype=torch.int32, device=dev)
    freqs = torch.empty((bsz, capacity), dtype=torch.int32, device=dev)
    n_peaks = torch.empty((bsz,), dtype=torch.int32, device=dev)
    if bsz == 0:
        return times, freqs, n_peaks
    stream = raw_stream(dev.index)

    def launch(words, base, epoch):
        KERNEL(bits.data_ptr(), bsz, t, capacity, times.data_ptr(),
               freqs.data_ptr(), n_peaks.data_ptr(), words.data_ptr(), base,
               epoch, stream=stream)

    _scratch(dev, stream).launch(tiles, blocks, launch)
    return times, freqs, n_peaks
