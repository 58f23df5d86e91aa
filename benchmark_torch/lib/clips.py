"""Query clips: the listener traffic's generator.

A mix file fixes the pool size, the clip length and the recording
conditions; the seed draws, for each clip, a catalog song (uniform), a
start (uniform over the song's samples) and, in equal shares shuffled,
its condition. Every seed gives the same number of clips of each length
and condition, in another order and from other songs. Conditions:

- ``clean``: the song's samples;
- ``channel``: the benchmark's copy of the synthetic speaker-room-mic
  loop (``lib/channel.py``) at the mix's ``severity``;
- ``awgn``: white noise at the mix's ``snr_db``, after the reference's
  [-1, 1] renormalization (``recognizer_test.py:412-423, 542-558``), as
  the program's recognition sweep (``bench/harness.py``) makes it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import channel, noise


@dataclass(frozen=True)
class ClipPlan:
    songs: np.ndarray        # (P,) catalog song index
    starts: np.ndarray       # (P,) first sample in the song
    conditions: np.ndarray   # (P,) index into the mix's conditions
    length: int              # samples


def plan(mix: dict, n_songs: int, song_samples: int, fs: int,
         seed: int) -> ClipPlan:
    pool = int(mix["pool"])
    n_cond = len(mix["conditions"])
    if pool % n_cond:
        raise ValueError("pool must split evenly over the conditions")
    length = int(round(mix["clip_s"] * fs))
    if length > song_samples:
        raise ValueError("clips longer than the songs")
    rng = np.random.default_rng([seed, 1])
    songs = rng.integers(0, n_songs, pool)
    starts = rng.integers(0, song_samples - length + 1, pool)
    conditions = rng.permutation(np.repeat(np.arange(n_cond), pool // n_cond))
    return ClipPlan(songs, starts, conditions, length)


def degrade(clip: np.ndarray, condition: dict, fs: int,
            seed: int, k: int) -> np.ndarray:
    """Clip ``k`` of the pool under its condition, int16."""
    rng = np.random.default_rng([seed, 2, k])
    kind = condition["name"]
    if kind == "clean":
        return clip.astype(np.int16)
    if kind == "channel":
        return channel.simulate_channel(clip, fs=fs, rng=rng,
                                        severity=condition["severity"])
    if kind == "awgn":
        sig = noise.renormalize(clip)
        noisy = sig + noise.white_noise_for_snr(sig, condition["snr_db"],
                                                rng=rng)
        return np.clip(noisy * 32767.0, -32768, 32767).astype(np.int16)
    raise ValueError(f"unknown condition {kind!r}")


class ClipCutter:
    """Collects the pool's clips from rendered catalog batches: call
    ``take(first_song, audio)`` with each batch, then ``finish``."""

    def __init__(self, p: ClipPlan):
        self.p = p
        self.raw = [None] * len(p.songs)

    def take(self, first_song: int, audio) -> None:
        rows = audio.shape[0]
        hit = np.nonzero((self.p.songs >= first_song)
                         & (self.p.songs < first_song + rows))[0]
        for k in hit:
            s = int(self.p.starts[k])
            self.raw[k] = audio[int(self.p.songs[k]) - first_song,
                                s: s + self.p.length].cpu().numpy()

    def finish(self, mix: dict, fs: int, seed: int, workers: int = 8):
        """The pool's clips as int16 arrays, each under its condition
        (each clip seeded on its own, so the threads change nothing)."""
        from concurrent.futures import ThreadPoolExecutor

        def one(k):
            return degrade(self.raw[k],
                           mix["conditions"][int(self.p.conditions[k])], fs,
                           seed, k)

        with ThreadPoolExecutor(workers) as ex:
            return list(ex.map(one, range(len(self.raw))))
