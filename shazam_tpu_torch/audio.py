"""Deterministic synthetic songs (numpy), sample for sample the JAX package's.

``synth_song`` is ``shazam_tpu.audio.synth.synth_song`` (a test holds the
two bit-equal). It is defined here because ``chip_smoke.py``, which
synthesizes its catalog with it, imports nothing of the JAX package:
sums of held harmonic tones with onset
envelopes, percussive clicks and a noise floor, fully determined by
(seed, song_id, duration, fs).
"""

from __future__ import annotations

import numpy as np


def synth_song(song_id: int, duration_s: float = 30.0, fs: int = 44100,
               seed: int = 1234, n_voices: int = 4) -> np.ndarray:
    """Generate one int16 mono song, deterministically from (seed, song_id)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, song_id]))
    n = int(duration_s * fs)
    t = np.arange(n, dtype=np.float64) / fs
    audio = np.zeros(n, dtype=np.float64)

    # "notes": each voice plays a random walk of held tones with harmonics
    for _voice in range(n_voices):
        pos = 0
        freq = float(rng.uniform(80.0, 2000.0))
        while pos < n:
            note_len = int(rng.uniform(0.12, 0.6) * fs)
            end = min(pos + note_len, n)
            seg_t = t[pos:end]
            # attack/decay envelope
            env = np.minimum(1.0, (seg_t - seg_t[0]) * 40.0) * np.exp(
                -(seg_t - seg_t[0]) * rng.uniform(0.5, 3.0)
            )
            phase = rng.uniform(0, 2 * np.pi)
            for harmonic, gain in ((1, 1.0), (2, 0.5), (3, 0.25), (4, 0.12)):
                f = freq * harmonic
                if f < fs / 2 * 0.9:
                    audio[pos:end] += gain * env * np.sin(
                        2 * np.pi * f * seg_t + phase * harmonic
                    )
            # random-walk the pitch
            freq = float(np.clip(freq * rng.uniform(0.8, 1.25), 60.0, 3000.0))
            pos = end

    # percussive clicks (broadband transients -> high-freq peaks)
    n_hits = max(1, int(duration_s * 2))
    hit_pos = rng.integers(0, max(n - fs // 50, 1), size=n_hits)
    for hp in hit_pos:
        length = fs // 100
        audio[hp:hp + length] += rng.normal(0, 1.2, min(length, n - hp)) * np.exp(
            -np.arange(min(length, n - hp)) / (fs / 2000)
        )

    # noise floor
    audio += rng.normal(0, 0.01, n)

    peak = np.max(np.abs(audio))
    if peak > 0:
        audio = audio / peak * 0.8
    return (audio * 32767.0).astype(np.int16)
