"""Deterministic synthetic songs (numpy), sample for sample the JAX package's.

``synth_song``, ``synth_music_song`` and ``synth_corpus`` (both styles)
are ``shazam_tpu.audio.synth``'s (tests hold them equal). They are
defined here because ``chip_smoke.py``, which synthesizes its catalogs
with them, imports nothing of the JAX package. ``synth_song`` sums held
harmonic tones with onset envelopes, percussive clicks and a noise floor;
``synth_music_song`` renders sustained harmonic voices over a chord
progression (its device twin is ``audio/synth_device.py``). Both are
fully determined by (seed, song_id, duration, fs).
"""

from __future__ import annotations

import os
from typing import List, Tuple

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


_MAJOR = (0, 2, 4, 5, 7, 9, 11)
_MINOR = (0, 2, 3, 5, 7, 8, 10)


def _tone(seg_t: np.ndarray, freq: float, fs: int, rng, *,
          vibrato_hz: float, vibrato_cents: float, phase: float,
          harmonics=((1, 1.0), (2, 0.45), (3, 0.22), (4, 0.10), (5, 0.05))
          ) -> np.ndarray:
    """One sustained note with vibrato: integrated instantaneous frequency so
    the vibrato is a true FM (continuous phase), summed over harmonics."""
    dt = 1.0 / fs
    vib = 2.0 ** (
        (vibrato_cents / 1200.0)
        * np.sin(2 * np.pi * vibrato_hz * (seg_t - seg_t[0]) + rng.uniform(0, 2 * np.pi))
    )
    inst = freq * vib
    ph = 2 * np.pi * np.cumsum(inst) * dt
    out = np.zeros_like(seg_t)
    for h, gain in harmonics:
        if freq * h < fs / 2 * 0.9:
            out += gain * np.sin(h * ph + phase * h)
    return out


def synth_music_song(song_id: int, duration_s: float = 210.0, fs: int = 44100,
                     seed: int = 1234, level: float = 0.15) -> np.ndarray:
    """Generate one int16 mono MUSIC-LIKE song (vs :func:`synth_song`'s
    percussive random tones).

    Built to reproduce the statistics of the reference's real-music corpus
    (reference ``songs_queries.sql:11``: ~11-12K hashes per 210 s track, and
    the AWGN degradation shape of ``tests_csv/...100records_5sec_0SNR.csv``:
    ~0.96 clean -> ~0.81 @ 0 dB): energy concentrated in sustained HARMONIC
    ridges (tonal peaks survive broadband noise; clicks don't), per-song
    tonal identity (key + global detune + progression + tempo all derive
    from ``song_id``), and realistic dynamics (verse/chorus level contour,
    so some 5 s windows are genuinely quiet).

    ``level`` is the peak-normalization target (full scale = 1.0); hash
    density scales with it because ``amp_min`` is an absolute dB cut. The
    default 0.15 measures ~11K unique hashes / 210 s via the oracle
    (5-song mean 10,997; level 0.2 -> 12.1K, 0.8 -> 45K), matching the
    reference corpus density.

    Every sample is fully determined by (seed, song_id, duration_s, fs).
    """
    rng = np.random.default_rng(np.random.SeedSequence([seed, song_id, 7]))
    n = int(duration_s * fs)
    t = np.arange(n, dtype=np.float64) / fs
    audio = np.zeros(n, dtype=np.float64)

    # --- per-song tonal identity ---
    detune = 2.0 ** (rng.uniform(-0.5, 0.5) / 12.0)     # up to +-50 cents
    a4 = 440.0 * detune
    key = int(rng.integers(0, 12))
    scale = _MAJOR if rng.random() < 0.5 else _MINOR
    bpm = float(rng.uniform(70.0, 140.0))
    beat = 60.0 / bpm
    bar = 4 * beat

    def degree_hz(degree: int, octave: int) -> float:
        semis = key + scale[degree % 7] + 12 * (degree // 7)
        return a4 * 2.0 ** ((semis - 57 + 12 * octave) / 12.0)  # A4 = midi 69 ref C-1

    # chord progression: random walk over scale degrees, one chord per bar
    n_bars = int(np.ceil(duration_s / bar)) + 1
    prog_len = int(rng.choice([4, 8]))
    prog = [0] + [int(rng.choice([1, 2, 3, 4, 5])) for _ in range(prog_len - 1)]
    chords = [prog[b % prog_len] for b in range(n_bars)]

    # section-level dynamics: 8-bar sections alternate quiet/loud
    # contours. Quiet depth 0.72: at 0.55 a 5 s query inside a quiet
    # section cleared amp_min too rarely — clean accuracy measured 0.90
    # at 100x210 s vs the reference's real-music 0.96 (the 0 dB
    # city-traffic point was already matched, 0.80 vs 0.8119).
    sect = np.array([0.72 if (b // 8) % 2 == 0 else 1.0 for b in range(n_bars)])
    sect = sect * rng.uniform(0.9, 1.1, size=n_bars)

    def add(pos: int, seg: np.ndarray) -> None:
        end = min(pos + len(seg), n)
        if end > pos:
            audio[pos:end] += seg[: end - pos]

    # --- bass: chord root, one note per half-bar, sustained ---
    for b in range(n_bars):
        for half in range(2):
            pos = int((b * bar + half * 2 * beat) * fs)
            if pos >= n:
                break
            dur = int(2 * beat * fs)
            seg_t = t[pos: pos + dur]
            if len(seg_t) == 0:
                continue
            f = degree_hz(chords[b], 2)
            env = np.minimum(1.0, (seg_t - seg_t[0]) * 60.0) * np.exp(
                -(seg_t - seg_t[0]) * 0.8)
            add(pos, 0.9 * sect[b] * env * _tone(
                seg_t, f, fs, rng, vibrato_hz=0.0, vibrato_cents=0.0,
                phase=rng.uniform(0, 2 * np.pi),
                harmonics=((1, 1.0), (2, 0.5), (3, 0.2))))

    # --- pad: 3 chord tones per bar, slow attack, gentle vibrato ---
    for b in range(n_bars):
        pos = int(b * bar * fs)
        if pos >= n:
            break
        seg_t = t[pos: pos + int(bar * fs)]
        if len(seg_t) == 0:
            continue
        env = np.minimum(1.0, (seg_t - seg_t[0]) * 6.0) * np.exp(
            -(seg_t - seg_t[0]) * 0.25)
        for off in (0, 2, 4):
            f = degree_hz(chords[b] + off, 4)
            add(pos, 0.35 * sect[b] * env * _tone(
                seg_t, f, fs, rng, vibrato_hz=rng.uniform(4.0, 6.0),
                vibrato_cents=rng.uniform(4.0, 10.0),
                phase=rng.uniform(0, 2 * np.pi)))

    # --- melody: scale walk, note lengths in beats, vibrato, clear envelope ---
    pos_s = 0.0
    deg = int(rng.integers(7, 14))  # around octave 5
    while pos_s < duration_s:
        note_beats = float(rng.choice([0.5, 0.5, 1.0, 1.0, 2.0]))
        pos = int(pos_s * fs)
        dur = int(note_beats * beat * fs)
        seg_t = t[pos: pos + dur]
        if len(seg_t) == 0:
            break
        b = min(int(pos_s / bar), n_bars - 1)
        if rng.random() < 0.85:  # mostly play, some rests
            f = degree_hz(deg, 4)
            env = np.minimum(1.0, (seg_t - seg_t[0]) * 30.0) * np.exp(
                -(seg_t - seg_t[0]) * rng.uniform(0.8, 2.0))
            add(pos, 0.75 * sect[b] * env * _tone(
                seg_t, f, fs, rng, vibrato_hz=rng.uniform(4.5, 6.5),
                vibrato_cents=rng.uniform(8.0, 25.0),
                phase=rng.uniform(0, 2 * np.pi)))
        deg = int(np.clip(deg + rng.choice([-2, -1, -1, 1, 1, 2, 3]), 4, 20))
        pos_s += note_beats * beat

    # --- percussion bed (moderate: identity lives in the tonal ridges) ---
    kick_len = int(0.09 * fs)
    kick_t = np.arange(kick_len) / fs
    kick = np.sin(2 * np.pi * (90.0 * np.exp(-kick_t * 18.0) + 45.0) * kick_t) \
        * np.exp(-kick_t * 35.0)
    snare_len = int(0.07 * fs)
    hat_len = int(0.02 * fs)
    for b in range(n_bars):
        amp = sect[b]
        for bt in range(4):
            pos = int((b * bar + bt * beat) * fs)
            if pos >= n:
                break
            if bt in (0, 2):
                add(pos, 0.5 * amp * kick)
            if bt in (1, 3):
                burst = rng.normal(0, 1.0, snare_len)
                burst -= np.concatenate([[0.0], burst[:-1]]) * 0.5  # tilt up
                add(pos, 0.18 * amp * burst * np.exp(-np.arange(snare_len) / (0.012 * fs)))
            for half in (0, 1):
                hp = pos + int(half * 0.5 * beat * fs)
                burst = rng.normal(0, 1.0, hat_len)
                burst = np.diff(burst, prepend=0.0)  # high-pass-ish
                add(hp, 0.05 * amp * burst * np.exp(-np.arange(hat_len) / (0.004 * fs)))

    audio += rng.normal(0, 0.004, n)  # room floor
    peak = np.max(np.abs(audio))
    if peak > 0:
        audio = audio / peak * level
    return (audio * 32767.0).astype(np.int16)


def synth_corpus(directory: str, n_songs: int, duration_s: float = 30.0,
                 fs: int = 44100, seed: int = 1234,
                 style: str = "tones") -> List[Tuple[str, int]]:
    """Write a corpus of WAV songs named ``track{i:06d}.wav``.

    ``style="tones"`` (default) is the original percussive random-tone
    generator; ``style="music"`` is :func:`synth_music_song` (sustained
    harmonic voices — matches real-music hash density and SNR behavior).

    Returns [(path, song_id)]. Skips files that already exist (same seed
    always regenerates identical bytes, so stale files are safe).
    """
    from .io import write_wav

    if style == "tones":
        gen = lambda i: synth_song(i, duration_s=duration_s, fs=fs, seed=seed)
    elif style == "music":
        gen = lambda i: synth_music_song(i, duration_s=duration_s, fs=fs, seed=seed)
    else:
        raise ValueError(f"unknown corpus style: {style!r}")
    os.makedirs(directory, exist_ok=True)
    out = []
    for i in range(n_songs):
        path = os.path.join(directory, f"track{i:06d}.wav")
        if not os.path.exists(path):
            write_wav(path, gen(i), fs)
        out.append((path, i))
    return out
