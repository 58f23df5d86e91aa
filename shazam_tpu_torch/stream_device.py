"""Device-resident incremental stream fingerprinting (fixed-shape rings).

The port of ``shazam_tpu/stream_device.py``. ``stream.IncrementalFingerprinter``
keeps its column caches on the host and copies every new column back;
this engine keeps the state on the device and works in fixed quanta:

- the state is two ring buffers on the device: PSD power rows (ring_frames,
  2049) float32 and settled peak-mask rows as K2's bit words
  (ring_frames, 65) int32. K2 gates in the power domain, so power is what
  the ring keeps (the JAX ring keeps dB and bools). The host holds only
  counters and a sample residual;
- audio is consumed in 16-frame quanta: ``feed`` runs K1 on one block of
  (16 - 1) * hop + wsize samples (34,816 at the reference config) and
  writes its 16 power rows into the ring, then settles the 16 frames
  before them with K2 on a slab of 16 + 2 radius rows gathered from the
  ring (their full context);
- ``fingerprints`` gathers the window's settled bits, recomputes the two
  window-clipped edge strips with K2 (a 2 radius-row slab on the left,
  16 + 2 radius rows on the right), compacts the window's mask with K3 and
  hashes the peak list on the device.

Results are identical, bit for bit, to ``fingerprint_batch_fused`` of the
window's samples from scratch: settled interior rows saw their full
context, and rows before the stream starts are zero power, which K2 reads
exactly as it reads frames outside its input (zero power stays below the
``amp_min > 0`` gate). K1 computes each frame on its own, in float64, so a
frame's power does not depend on the block it came in. Configs that
``api._fused_ok`` refuses take the plain dB pipeline (``fingerprint_batch``'s
stages) on the same device, as ``SIA`` does.

K3 counts every peak exactly and has no per-frame capacity, so this engine
never raises the JAX engine's per-frame overflow.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import FingerprintConfig
from .device import resolve_device
from .ops.fingerprint import Fingerprints

FRAME_STEP = 16          # frames per feed quantum (aligned ring writes)


def _round_up(n: int, step: int) -> int:
    return -(-n // step) * step


def window_frames_for(config: FingerprintConfig, window_seconds: float) -> int:
    """STFT frames in a window of ``window_seconds`` (at least 1)."""
    return max((int(window_seconds * config.sample_rate) - config.window_size)
               // config.hop + 1, 1)


class FrameOps:
    """The fingerprint stages on one device, frame rows at a time: K1, K2
    and K3 where ``api._fused_ok`` admits the config (their plain twins on
    CPU tensors), the plain dB pipeline otherwise. Both stream engines
    call these."""

    def __init__(self, config: FingerprintConfig, device):
        from .api import _fused_ok

        self.config = config
        self.device = device
        self.fused = _fused_ok(config)
        self.n_freqs = config.window_size // 2 + 1
        self.n_words = -(-self.n_freqs // 32)
        self._nvf: Dict[int, torch.Tensor] = {}

    def power(self, samples: torch.Tensor, n_frames: int) -> torch.Tensor:
        """(n_frames, F) float32 PSD power of 1-D float32 samples on the
        device (exactly (n_frames - 1) * hop + wsize of them)."""
        from .ops.cuda.spectrogram import spectrogram_power
        from .ops.spectrogram import spectrogram_power_plain

        c = self.config
        nvf = self._nvf.get(n_frames)
        if nvf is None:
            nvf = torch.tensor([n_frames], dtype=torch.int32,
                               device=self.device)
            self._nvf[n_frames] = nvf
        fn = spectrogram_power if self.fused else spectrogram_power_plain
        return fn(samples[None].contiguous(), nvf,
                  fs=c.sample_rate, wsize=c.window_size, hop=c.hop)[0]

    def mask(self, slab: torch.Tensor) -> torch.Tensor:
        """(T, n_words) int32 peak-mask bits of a (T, F) power slab, frames
        outside it out of range."""
        from .ops.cuda.peaks import peak_mask
        from .ops.peaks import pack_mask_bits, peak_mask_db
        from .ops.spectrogram import db_spectrogram

        c = self.config
        x = slab[None].contiguous()
        if self.fused:
            return peak_mask(x, c.amp_min, c.peak_neighborhood_size)[0]
        return pack_mask_bits(peak_mask_db(
            db_spectrogram(x), c.amp_min, c.peak_neighborhood_size))[0]

    def fingerprints(self, mask: torch.Tensor, capacity: int) -> Fingerprints:
        """K3 (or its twin) on a window's (T, n_words) mask, then the
        hashes of its peak list, on the device; one read-back, the peak
        count. Past ``capacity`` peaks: ``OverflowError`` carrying
        ``n_peaks``, so the caller jumps to a tier that fits."""
        from .ops.cuda.compact import compact
        from .ops.hashes import generate_hashes
        from .ops.peaks import compact_plain

        c = self.config
        x = mask[None].contiguous()
        if self.fused:
            times, freqs, n_peaks = compact(x, capacity)
        else:
            times, freqs, n_peaks = compact_plain(x, capacity,
                                                  n_bins=self.n_freqs)
        hi, lo, ex, t1, valid = generate_hashes(
            times[0], freqs[0], n_peaks[0], fan_value=c.fan_value,
            min_dt=c.min_hash_time_delta, max_dt=c.max_hash_time_delta)
        n = int(n_peaks[0])
        if n > capacity:
            err = OverflowError(f"window holds {n} peaks > capacity {capacity}")
            err.n_peaks = n
            raise err
        return Fingerprints(hi, lo, ex, t1, valid, n_peaks[0])


class DeviceIncrementalFingerprinter:
    """Sibling of ``stream.IncrementalFingerprinter`` whose column caches
    live on the device and whose per-quantum work has fixed shapes. Runs
    on the card unless ``device="cpu"``."""

    def __init__(self, config: FingerprintConfig, window_seconds: float,
                 device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        wsize, hop = config.window_size, config.hop
        if config.peak_neighborhood_size > FRAME_STEP:
            raise ValueError("device streaming requires radius <= 16")
        self._ops = FrameOps(config, self.device)
        self.n_freqs = self._ops.n_freqs
        self.window_frames = window_frames_for(config, window_seconds)
        if self.window_frames < 3 * FRAME_STEP:
            raise ValueError(
                "device streaming needs a >= ~2.5 s window; use the host "
                "IncrementalFingerprinter for shorter ones"
            )
        self.radius = config.peak_neighborhood_size
        self.cap = _round_up(self.window_frames, FRAME_STEP) + 4 * FRAME_STEP
        self._block = (FRAME_STEP - 1) * hop + wsize   # samples per quantum
        self.reset()
        self.frames_computed = 0         # lifetime STFT frames (stats)

    # ---- the stream.IncrementalFingerprinter surface ------------------
    @property
    def n_frames(self) -> int:
        return self._t

    @property
    def window_bounds(self) -> Tuple[int, int]:
        return max(0, self._t - self.window_frames), self._t

    def window_sample_range(self) -> Tuple[int, int]:
        w0, w1 = self.window_bounds
        wsize, hop = self.config.window_size, self.config.hop
        return w0 * hop, (w1 - 1) * hop + wsize if w1 > w0 else w0 * hop

    @property
    def ready(self) -> bool:
        """True once the ring holds one full, settle-covered window."""
        return self._t >= max(self.window_frames, 2 * FRAME_STEP)

    def _rows(self, ring: torch.Tensor, start: int, n: int) -> torch.Tensor:
        """Ring rows of absolute frames [start, start + n); frames before
        the stream (start < 0) are zero rows."""
        parts = []
        if start < 0:
            pre = min(-start, n)
            parts.append(ring.new_zeros((pre, ring.shape[1])))
            start, n = 0, n - pre
        at = start % self.cap
        while n > 0:
            take = min(n, self.cap - at)
            parts.append(ring[at: at + take])
            n -= take
            at = 0
        return parts[0].contiguous() if len(parts) == 1 else torch.cat(parts)

    def _absorb(self, block: torch.Tensor) -> None:
        """Frames [t, t + 16): K1 writes their power rows, then K2 settles
        frames [t - 16, t) from a slab holding their full context."""
        r = self.radius
        self._t += FRAME_STEP
        t_new = self._t
        w = (t_new - FRAME_STEP) % self.cap   # 16-aligned: never wraps
        self._power[w: w + FRAME_STEP] = self._ops.power(block, FRAME_STEP)
        s0 = t_new - 2 * FRAME_STEP
        if s0 >= 0:
            slab = self._rows(self._power, s0 - r, FRAME_STEP + 2 * r)
            s = s0 % self.cap
            self._bits[s: s + FRAME_STEP] = \
                self._ops.mask(slab)[r: r + FRAME_STEP]
        self.frames_computed += FRAME_STEP

    def feed(self, samples: np.ndarray) -> None:
        """Append mono samples; absorb every complete 16-frame quantum
        (one upload of the samples they need)."""
        step = FRAME_STEP * self.config.hop
        data = np.concatenate(
            [self._residual, np.asarray(samples, np.float32)]
        )
        if len(data) >= self._block:
            n_q = (len(data) - self._block) // step + 1
            x = torch.from_numpy(
                np.ascontiguousarray(data[: (n_q - 1) * step + self._block])
            ).to(self.device)
            for q in range(n_q):
                self._absorb(x[q * step: q * step + self._block])
            data = data[n_q * step:]
        self._residual = data

    def window_mask(self) -> torch.Tensor:
        """(window_frames, n_words) mask bits of the window: the settled
        interior from the ring, the two window-clipped edge strips
        recomputed with K2."""
        w, r, t = self.window_frames, self.radius, self._t
        tail = FRAME_STEP + r   # unsettled frames + right-clip context
        # left strip [w0, w0 + r): a full pass clips its context at w0
        left = self._ops.mask(self._rows(self._power, t - w, 2 * r))[:r]
        # right strip [t - tail, t): the slab gives the unsettled frames
        # their full left context and ends where the window ends
        right = self._ops.mask(
            self._rows(self._power, t - tail - r, tail + r))[r:]
        interior = self._rows(self._bits, t - w + r, w - tail - r)
        return torch.cat([left, interior, right])

    def fingerprints(self, capacity: Optional[int] = None) -> Fingerprints:
        """K3 on the window's mask and the hashes of its peak list."""
        if not self.ready:
            raise OverflowError(
                "ring window not full yet; use the fallback recompute"
            )
        return self._ops.fingerprints(self.window_mask(),
                                      capacity or self.config.peak_capacity)

    def reset(self) -> None:
        self._power = torch.zeros((self.cap, self.n_freqs), dtype=torch.float32,
                                  device=self.device)
        self._bits = torch.zeros((self.cap, self._ops.n_words),
                                 dtype=torch.int32, device=self.device)
        self._residual = np.zeros(0, np.float32)
        self._t = 0
