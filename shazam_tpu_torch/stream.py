"""Streaming recognition: incremental fingerprinting + optional mic capture.

The port of ``shazam_tpu/stream.py``. The reference records CHUNK=8192-sample
pyaudio buffers into channel lists and fingerprints the WHOLE window after
RECORD_SECONDS (``recognizer.py:355-382``). A continuous-listening
deployment calling ``recognize()`` repeatedly would redo ~15 s of STFT per
call, so here the per-channel fingerprint state is incremental:

- spectrogram rows are computed once per frame as samples arrive (K1 on
  the new frames only: device work per ``recognize()`` is proportional to
  NEW audio);
- peak-mask rows "settle" once their full +-radius frame context exists
  and are cached; only two radius-wide strips at the current window's
  edges are recomputed per call (K2; the window boundary clips the peak
  neighborhood there, exactly like a full recompute);
- hash pairing + the index match run on the window's peak set (cheap).

Results are identical to fingerprinting the window's samples from
scratch with ``fingerprint_batch_fused`` (bit for bit).
``IncrementalFingerprinter`` caches its rows on the host, as the JAX
engine does; ``stream_device.DeviceIncrementalFingerprinter`` keeps them
in rings on the device.

Mic capture stays host-side and optional: ``mic_chunks`` yields chunks via
pyaudio when (and only when) that package exists.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .api import MAX_PEAK_CAPACITY, SIA
from .config import FingerprintConfig
from .device import resolve_device
from .match.align import align_results
from .match.prepare import prepare_query
from .ops.fingerprint import Fingerprints
from .stream_device import FrameOps, window_frames_for

CHUNK = 8192  # samples per chunk per channel (recognizer.py:25)


class IncrementalFingerprinter:
    """Per-channel incremental fingerprint state over a sliding window.

    Absolute frame t covers stream samples [t*hop, t*hop + wsize); the
    recognition window is the last ``window_frames`` computed frames (its
    start is always hop-aligned, so window frames coincide with stream
    frames and cached rows stay valid as the window slides). Power rows
    and settled mask rows are cached on the host; K1, K2 and, on the
    window, K3 run on ``device`` (the card unless ``device="cpu"``).
    """

    def __init__(self, config: FingerprintConfig, window_seconds: float,
                 device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self._ops = FrameOps(config, self.device)
        self.n_freqs = self._ops.n_freqs
        self.window_frames = window_frames_for(config, window_seconds)
        self.radius = config.peak_neighborhood_size
        if self.window_frames < 2 * self.radius:
            # _settle's slab slicing assumes the window retains at least
            # the +-radius context of every settled frame
            raise ValueError(
                f"window_seconds={window_seconds} gives "
                f"{self.window_frames} frames < 2 * radius "
                f"({2 * self.radius}); use a window of at least "
                f"{(2 * self.radius * config.hop + config.window_size) / config.sample_rate:.2f} s"
            )
        self.reset()
        self.frames_computed = 0        # lifetime STFT frames (stats/tests)
        self.strip_frames_computed = 0  # edge-strip mask rows (stats)

    @property
    def n_frames(self) -> int:
        """Absolute frames computed so far (= window end W1)."""
        return self._base + self._spec.shape[0]

    @property
    def window_bounds(self) -> Tuple[int, int]:
        """[W0, W1) absolute frame range of the current window."""
        w1 = self.n_frames
        return max(0, w1 - self.window_frames), w1

    def _mask_rows(self, slab: np.ndarray) -> np.ndarray:
        """K2 (or the plain dB mask) of a host power slab, on the device."""
        return self._ops.mask(torch.from_numpy(slab).to(self.device)).cpu().numpy()

    def feed(self, samples: np.ndarray) -> None:
        """Append mono samples; K1 computes the power rows of every newly
        completed frame (the only per-sample device work)."""
        wsize, hop = self.config.window_size, self.config.hop
        data = np.concatenate([
            self._residual, np.asarray(samples, np.float32)
        ])
        if len(data) < wsize:
            self._residual = data
            return
        n_new = (len(data) - wsize) // hop + 1
        x = torch.from_numpy(
            np.ascontiguousarray(data[: (n_new - 1) * hop + wsize])
        ).to(self.device)
        rows = self._ops.power(x, n_new).cpu().numpy()
        self._residual = data[n_new * hop:]
        self._spec = np.concatenate([self._spec, rows])
        self.frames_computed += n_new
        self._settle()
        self._evict()

    def _settle(self) -> None:
        """Extend the cached mask to every frame whose full +-radius context
        exists. Interior rows of any slab equal the full computation (rows
        outside the slab are out of range, so rows >= radius from its edge
        see only real data)."""
        r = self.radius
        new_until = max(self.n_frames - r, 0)
        if new_until <= self._settled:
            return
        a = self._settled            # absolute rows to settle: [a, b)
        b = new_until
        slab_lo = max(a - r, 0)
        m = self._mask_rows(self._spec[slab_lo - self._base: b + r - self._base])
        keep = m[a - slab_lo: b - slab_lo]
        # rows < radius from the stream start have true (clipped) context:
        # the slab starts at frame 0 exactly like a full pass
        grow = b - (self._base + self._mask.shape[0])
        if grow > 0:
            self._mask = np.concatenate(
                [self._mask, np.zeros((grow, self._ops.n_words), np.int32)])
        self._mask[a - self._base: b - self._base] = keep
        self._settled = b

    def _evict(self) -> None:
        """Drop cached rows older than the current window start."""
        w0, _ = self.window_bounds
        drop = w0 - self._base
        if drop > 0:
            self._spec = self._spec[drop:]
            self._mask = self._mask[drop:]
            self._base = w0

    def _edge_strip(self, lo: int, hi: int,
                    window: Tuple[int, int]) -> np.ndarray:
        """Mask rows [lo, hi) computed with the WINDOW's boundary clipping
        (exactly what a from-scratch pass over the window sees)."""
        r = self.radius
        w0, w1 = window
        slab_lo = max(lo - r, w0)
        slab_hi = min(hi + r, w1)
        m = self._mask_rows(
            self._spec[slab_lo - self._base: slab_hi - self._base])
        self.strip_frames_computed += hi - lo
        return m[lo - slab_lo: hi - slab_lo]

    def window_bits(self) -> np.ndarray:
        """(window frames, n_words) int32 mask bits of the current window."""
        w0, w1 = self.window_bounds
        r = self.radius
        if w1 - w0 <= 2 * r:
            return self._edge_strip(w0, w1, (w0, w1))
        left = self._edge_strip(w0, w0 + r, (w0, w1))
        right = self._edge_strip(w1 - r, w1, (w0, w1))
        interior = self._mask[w0 + r - self._base: w1 - r - self._base]
        return np.concatenate([left, interior, right])

    def fingerprints(self, capacity: Optional[int] = None) -> Fingerprints:
        """K3 on the window's mask (uploaded) and the hashes of its peak
        list, on the device."""
        return self._ops.fingerprints(
            torch.from_numpy(self.window_bits()).to(self.device),
            capacity or self.config.peak_capacity)

    def window_sample_range(self) -> Tuple[int, int]:
        """[start, end) absolute sample range a full recompute of this
        window would fingerprint (for parity tests / fallbacks)."""
        w0, w1 = self.window_bounds
        wsize, hop = self.config.window_size, self.config.hop
        return w0 * hop, (w1 - 1) * hop + wsize if w1 > w0 else w0 * hop

    def reset(self) -> None:
        self._residual = np.zeros(0, np.float32)          # unframed tail
        self._spec = np.zeros((0, self.n_freqs), np.float32)   # power rows
        self._mask = np.zeros((0, self._ops.n_words), np.int32)  # settled
        self._base = 0          # absolute frame index of _spec[0]
        self._settled = 0       # absolute frames with a settled mask


class StreamRecognizer:
    """Rolling window of interleaved audio chunks + incremental recognition.

    ``feed()`` consumes interleaved int16 chunks from any producer
    (microphone, socket, file reader); ``recognize()`` matches the current
    window. Fingerprint state is incremental per channel; a raw sample
    ring is kept only as the fallback and for parity tests.
    ``fallbacks`` counts the incremental ``recognize()`` calls that
    recomputed the window from the sample ring instead.
    """

    def __init__(self, sia: SIA, channels: int = 2,
                 window_seconds: float = 15.0, engine: str = "host"):
        """engine="device" keeps the incremental state in ring buffers on
        the SIA's device with fixed-shape quanta (stream_device.py);
        "host" caches rows host-side (identical results either way)."""
        self.sia = sia
        self.channels = channels
        self.window_seconds = window_seconds
        self.window_samples = int(window_seconds * sia.config.sample_rate)
        if engine == "device":
            from .stream_device import DeviceIncrementalFingerprinter

            fp_cls = DeviceIncrementalFingerprinter
        elif engine == "host":
            fp_cls = IncrementalFingerprinter
        else:
            raise ValueError(f"unknown streaming engine {engine!r}")
        self.engine = engine
        self._fps = [fp_cls(sia.config, window_seconds, device=sia.device)
                     for _ in range(channels)]
        self._rings: List[np.ndarray] = [
            np.zeros(0, np.int16) for _ in range(channels)
        ]
        self._ring_start = 0   # absolute sample index of ring[0]
        # per-window peak capacity; doubles when dense audio overflows it
        # (sticky, so one escalation covers the rest of the stream and
        # the incremental path is never permanently lost to the full-
        # recompute fallback)
        self._peak_cap = sia.config.peak_capacity
        self.fallbacks = 0

    def feed(self, chunk: np.ndarray) -> None:
        """Consume one interleaved int16 chunk (len = n * channels)."""
        chunk = np.asarray(chunk, np.int16)
        for c in range(self.channels):
            ch = chunk[c:: self.channels]
            self._fps[c].feed(ch)
            self._rings[c] = np.concatenate([self._rings[c], ch])
        # slack covers the fingerprinter's residual: the device engine
        # consumes 16-frame quanta, so up to ~15 hops + a window of
        # samples can be fed but not yet absorbed into frames
        keep = (self.window_samples + 2 * self.sia.config.window_size
                + 16 * self.sia.config.hop)
        if len(self._rings[0]) > keep:
            drop = len(self._rings[0]) - keep
            self._rings = [r[drop:] for r in self._rings]
            self._ring_start += drop

    @property
    def buffered_seconds(self) -> float:
        return len(self._rings[0]) / self.sia.config.sample_rate

    @property
    def ready(self) -> bool:
        """Every channel's engine can serve the window incrementally."""
        return all(getattr(f, "ready", True) for f in self._fps)

    def _window_channels(self) -> List[np.ndarray]:
        """Raw samples of the exact window range (fallback path)."""
        a, b = self._fps[0].window_sample_range()
        return [
            r[a - self._ring_start: b - self._ring_start]
            for r in self._rings if len(r)
        ]

    def _fallback(self, topn: Optional[int]) -> Dict:
        self.fallbacks += 1
        return self.sia.recognize_samples(self._window_channels(), topn=topn)

    def recognize(self, topn: Optional[int] = None,
                  incremental: bool = True) -> Dict:
        """Recognize the current window (channel set-union, like the ref).

        incremental=True fingerprints only audio that arrived since the
        previous call; False recomputes the window from the sample ring
        (identical results, more device work).
        """
        if not incremental:
            return self.sia.recognize_samples(
                self._window_channels(), topn=topn
            )
        t0 = time.time()
        if not self.ready:
            # the device engine can't serve a window until its first
            # 16-frame quanta land -- recompute from the sample ring
            return self._fallback(topn)
        while True:
            try:
                fps = [
                    f.fingerprints(capacity=self._peak_cap)
                    for f in self._fps
                    if f.n_frames > f.window_bounds[0]
                ]
                if not fps:   # no frames at all yet (sub-wsize feed)
                    fps = [self._fps[0].fingerprints(
                        capacity=self._peak_cap)]
                break
            except OverflowError as e:
                # dense window: escalate like SIA's query path (sticky),
                # straight to a tier that fits the known count. The
                # port's engines count peaks exactly and never raise a
                # per-frame overflow (escalate=False); that branch stays
                # for engines that do
                if not getattr(e, "escalate", True) \
                        or self._peak_cap >= MAX_PEAK_CAPACITY:
                    return self._fallback(topn)
                need = getattr(e, "n_peaks", 0)
                self._peak_cap *= 2
                while (self._peak_cap < need
                       and self._peak_cap < MAX_PEAK_CAPACITY):
                    self._peak_cap *= 2
        q = prepare_query(fps)
        fingerprint_time = time.time() - t0

        a, b = self._fps[0].window_sample_range()
        t0 = time.time()
        raw_matcher = getattr(self.sia, "_match_prepared", None)
        if raw_matcher is not None:
            raw, cap_used = raw_matcher(q, n_samples=b - a, topn=topn)
            query_time = time.time() - t0
            t0 = time.time()
            matched = align_results(
                raw, q.n_pairs, catalog=self.sia.catalog,
                config=self.sia.config, match_capacity=cap_used,
            )
            align_time = time.time() - t0
        else:
            # SIA-shaped facades (parallel.serving.ShardedRecognizer)
            # expose an aligned prepared-query match spanning the group
            matched = self.sia.match_prepared(q, topn=topn)
            query_time = time.time() - t0
            align_time = 0.0
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

    def reset(self) -> None:
        for f in self._fps:
            f.reset()
        self._rings = [np.zeros(0, np.int16) for _ in range(self.channels)]
        self._ring_start = 0


def mic_chunks(seconds: float, channels: int = 2, rate: int = 44100,
               chunk: int = CHUNK) -> Iterator[np.ndarray]:
    """Yield interleaved int16 mic chunks via pyaudio (if installed).

    Mirrors the capture loop at ``recognizer.py:357-374``. Raises a clear
    error when pyaudio is unavailable.
    """
    try:
        import pyaudio
    except ImportError as exc:
        raise RuntimeError(
            "microphone capture requires pyaudio, which is not installed; "
            "use StreamRecognizer.feed() with your own chunk source"
        ) from exc

    pa = pyaudio.PyAudio()
    stream = pa.open(format=pyaudio.paInt16, channels=channels, rate=rate,
                     input=True, frames_per_buffer=chunk)
    try:
        for _ in range(int(rate / chunk * seconds)):
            data = stream.read(chunk, exception_on_overflow=False)
            yield np.frombuffer(data, np.int16)
    finally:
        stream.stop_stream()
        stream.close()
        pa.terminate()


def recognize_from_mic(sia: SIA, seconds: float = 5.0, channels: int = 2,
                       topn: Optional[int] = None) -> Dict:
    """One-shot mic recognition (the reference's recognizer.py main path)."""
    rec = StreamRecognizer(sia, channels=channels,
                           window_seconds=max(seconds, 1.0))
    for chunk in mic_chunks(seconds, channels=channels,
                            rate=sia.config.sample_rate):
        rec.feed(chunk)
    return rec.recognize(topn=topn)
