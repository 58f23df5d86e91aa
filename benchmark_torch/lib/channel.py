"""Acoustic-channel degradation for robustness benchmarks (numpy + scipy):
the benchmark's frozen copy of the program's
``shazam_tpu_torch/audio/channel.py``, so that a change to the program
cannot move the yardstick.

The reference's published accuracy numbers all survived a real analog
loop: each query fragment was PLAYED through speakers and re-recorded
from the mic (reference ``recognizer_test.py:561-580``, ``play_thread``
at ``:381-388``) — DAC, speaker, room, mic, ADC. Our harness is
file-based (right for CI), so this module provides a seeded synthetic
stand-in for that channel, applied to query clips before recognition:

1. speaker/mic band-limit — 4th-order Butterworth band-pass
   (~120 Hz – 7.5 kHz, typical laptop speaker + electret mic);
2. small-room reverb — sparse early reflections plus an exponentially
   decaying diffuse tail (~120 ms RT60-ish), energy-normalized;
3. speaker nonlinearity — soft clip (tanh) at a randomized drive;
4. room noise floor at a randomized 30–40 dB SNR;
5. playback level variation (±6 dB) and int16 re-quantization.

Each knob is drawn from the seeded RNG per clip, so a sweep sees a
distribution of channels, like a test rig whose operator moves the mic
between runs. Used by ``lib/clips.py`` for the listener mixes'
``channel`` condition.
"""

from __future__ import annotations

import numpy as np

# Severity at which clean 5 s/100-song accuracy through the channel
# lands in the reference's real-loopback band (0.93-0.96), fit by the
# JAX package's round-5 calibration sweep (300 clips per point, music-style catalog;
# .tpu_logs/chan100_s*.log, table in benchmarks/README.md):
#   0.25 -> 0.9500   0.50 -> 0.9467   0.75 -> 0.9233   1.00 -> 0.8700
# 0.5 is the HARDEST severity still inside the band (0.25 is also
# in-band); 1.0 is the stress rig.
CALIBRATED_SEVERITY = 0.5


def _butter_bandpass_sos(lo_hz: float, hi_hz: float, fs: int):
    from scipy.signal import butter

    ny = fs / 2.0
    hi = min(hi_hz, ny * 0.98)
    return butter(4, [lo_hz / ny, hi / ny], btype="band", output="sos")


def _room_impulse(rng: np.random.Generator, fs: int,
                  rt_ms: float, tail_mix: float = 0.25) -> np.ndarray:
    """Sparse early reflections + diffuse exponential tail, direct-path
    dominant, normalized to unit energy."""
    n = max(int(rt_ms / 1000.0 * fs), 8)
    ir = np.zeros(n, np.float64)
    ir[0] = 1.0
    n_refl = int(rng.integers(3, 7))
    for _ in range(n_refl):
        at = int(rng.integers(int(0.002 * fs), max(int(0.035 * fs), 2)))
        if at < n:
            ir[at] += rng.uniform(0.1, 0.4) * rng.choice((-1.0, 1.0))
    tail = rng.normal(0.0, 1.0, n) * np.exp(
        -np.arange(n) / (rt_ms / 1000.0 * fs / 6.9))  # -60 dB at rt_ms
    ir += tail_mix * tail
    return ir / np.sqrt(np.sum(ir * ir))


def simulate_channel(clip: np.ndarray, fs: int = 44100,
                     rng: np.random.Generator | int | None = None,
                     severity: float = 1.0) -> np.ndarray:
    """Pass one query clip through a randomized synthetic acoustic loop.

    Input any int16-scale 1-D array; output int16 of the same length.
    Deterministic per (clip, seed, severity).

    ``severity`` scales how harsh the per-clip channel draws are:

    - ``1.0`` (default) — the original ranges: rooms up to ~180 ms
      RT60, drives to 2.2x, 30-40 dB noise floors, +-6 dB level swing.
      Harsher than a benchtop rig (deep rooms, heavy clipping) — the
      stress setting.
    - ``CALIBRATED_SEVERITY`` — fit so clean 5 s/100-song accuracy
      through the channel lands in the reference's REAL loopback band
      (0.93-0.96, ``tests_csv/shazam_results_100records_5sec*.csv``);
      use this when comparing against the reference's published
      numbers, which all survived its speakers->mic loop
      (``recognizer_test.py:561-580``).
    - ``0.0`` — a gentle benchtop rig: wide passband, dry 30 ms room,
      barely-driven speaker, 40-45 dB SNR, flat level.

    Every knob interpolates linearly between those endpoints.
    """
    from scipy.signal import fftconvolve, sosfilt

    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    s = float(np.clip(severity, 0.0, 1.0))
    x = np.asarray(clip, np.float64)
    peak_in = np.max(np.abs(x)) + 1e-9

    # 1. speaker/mic band-limit (randomize edges a little)
    lo = rng.uniform(60.0 + 40.0 * s, 100.0 + 80.0 * s)
    hi = rng.uniform(7900.0 - 1400.0 * s, 8400.0 - 500.0 * s)
    x = sosfilt(_butter_bandpass_sos(lo, hi, fs), x)

    # 2. small-room reverb (tail mix scales with severity too)
    ir = _room_impulse(rng, fs,
                       rt_ms=rng.uniform(30.0 + 50.0 * s,
                                         60.0 + 120.0 * s),
                       tail_mix=0.05 + 0.20 * s)
    x = fftconvolve(x, ir)[: len(clip)]

    # 3. speaker soft-clip: drive the top ~few dB into tanh
    drive = rng.uniform(1.0 + 0.2 * s, 1.1 + 1.1 * s)
    ref = np.max(np.abs(x)) + 1e-9
    x = np.tanh(x / ref * drive) * (ref / np.tanh(drive))

    # 4. room/mic noise floor (30-40 dB SNR at full severity)
    rms = np.sqrt(np.mean(x * x)) + 1e-9
    snr_db = rng.uniform(40.0 - 10.0 * s, 45.0 - 5.0 * s)
    x = x + rng.normal(0.0, rms * 10.0 ** (-snr_db / 20.0), len(x))

    # 5. playback level +-6*s dB around the input peak, re-quantized
    gain = 10.0 ** (rng.uniform(-6.0 * s, 6.0 * s) / 20.0)
    x = x * (peak_in / (np.max(np.abs(x)) + 1e-9)) * gain
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)
