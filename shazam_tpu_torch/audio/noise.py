"""Seeded noise injection for robustness benchmarks (numpy), a copy of
``shazam_tpu.audio.noise`` held bit-equal to it by a test.

Reproduces the reference's two injectors (``recognizer_test.py:412-435``)
with explicit RNG seeding so CI runs are deterministic:

- AWGN at a target SNR derived from the signal RMS (``get_white_noise``).
- An arbitrary noise recording rescaled so the mix hits the target SNR
  (``get_noise_from_sound``), with the same [-1, 1] renormalization the
  bench loop applies (``recognizer_test.py:547-549``).
"""

from __future__ import annotations

import numpy as np


def renormalize(signal: np.ndarray) -> np.ndarray:
    """Map a signal linearly onto [-1, 1] (reference ``np.interp`` renorm)."""
    signal = np.asarray(signal, dtype=np.float64)
    lo, hi = signal.min(), signal.max()
    if hi == lo:
        return np.zeros_like(signal)
    return np.interp(signal, (lo, hi), (-1.0, 1.0))


def _rms(x: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(np.asarray(x, dtype=np.float64)))))


def white_noise_for_snr(signal: np.ndarray, snr_db: float,
                        rng: np.random.Generator | int | None = None) -> np.ndarray:
    """AWGN whose power puts `signal` at `snr_db` dB SNR.

    Same RMS arithmetic as reference ``get_white_noise``
    (``recognizer_test.py:412-423``); seeded instead of global np.random.
    """
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    rms_s = _rms(signal)
    rms_n = np.sqrt(rms_s ** 2 / (10.0 ** (snr_db / 10.0)))
    return rng.normal(0.0, rms_n, np.asarray(signal).shape[0])


def scale_noise_to_snr(signal: np.ndarray, noise: np.ndarray,
                       snr_db: float) -> np.ndarray:
    """Rescale `noise` so that signal+noise sits at `snr_db` dB SNR.

    Same arithmetic as reference ``get_noise_from_sound``
    (``recognizer_test.py:426-435``).
    """
    rms_s = _rms(signal)
    rms_target = np.sqrt(rms_s ** 2 / (10.0 ** (snr_db / 10.0)))
    rms_now = _rms(noise)
    if rms_now == 0.0:
        return np.zeros_like(np.asarray(noise, dtype=np.float64))
    return np.asarray(noise, dtype=np.float64) * (rms_target / rms_now)


def mix_at_snr(signal: np.ndarray, noise: np.ndarray, snr_db: float,
               rng: np.random.Generator | int | None = None) -> np.ndarray:
    """Bench-loop mix (reference ``recognizer_test.py:542-558``):
    renormalize both to [-1,1], take a random noise window of matching
    length, scale it to the target SNR, and sum.
    """
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    sig = renormalize(signal)
    noi = renormalize(noise)
    if len(noi) < len(sig):
        reps = int(np.ceil(len(sig) / max(len(noi), 1)))
        noi = np.tile(noi, reps)
    start = int(rng.integers(0, len(noi) - len(sig) + 1))
    noi = noi[start:start + len(sig)]
    return sig + scale_noise_to_snr(sig, noi, snr_db)
