"""Host-side polyphase resampling to the fingerprint sample rate.

A copy of ``shazam_tpu.audio.resample`` (the port imports nothing of the
JAX package); a test holds the two bit-equal.

The reference decoded through pydub at each file's NATIVE rate and fed
that straight into ``fingerprint`` (``__init__.py:86-95,232``) — a
48 kHz file was binned with 44.1 kHz constants, silently pitch-shifting
every hash, so cross-rate catalogs could never match.  Here mismatched
rates are either rejected loudly (``SIA(resample=False)``) or converted
with a proper polyphase rational resampler before fingerprinting, so a
mixed-rate corpus lands in one coherent hash space.

Resampling is host-side CPU work on purpose: it happens once per clip
at decode time, is memory-bandwidth trivial next to the STFT, and
the device pipeline sees exactly one sample rate.
"""

from __future__ import annotations

from math import gcd
from typing import List, Sequence

import numpy as np


def resample_channel(x: np.ndarray, fs: int, target_fs: int) -> np.ndarray:
    """Resample one channel ``fs -> target_fs`` (polyphase, rational).

    int16 input stays int16 (rounded, clipped); float stays float32.
    """
    if fs == target_fs:
        return x
    if fs <= 0 or target_fs <= 0:
        raise ValueError(f"invalid sample rates {fs} -> {target_fs}")
    from scipy.signal import resample_poly

    g = gcd(int(fs), int(target_fs))
    up, down = int(target_fs) // g, int(fs) // g
    was_int16 = x.dtype == np.int16
    y = resample_poly(x.astype(np.float64), up, down)
    if was_int16:
        return np.clip(np.rint(y), -32768, 32767).astype(np.int16)
    return y.astype(np.float32)


def resample_channels(channels: Sequence[np.ndarray], fs: int,
                      target_fs: int) -> List[np.ndarray]:
    """Resample every channel of a decoded file."""
    return [resample_channel(np.asarray(c), fs, target_fs)
            for c in channels]
