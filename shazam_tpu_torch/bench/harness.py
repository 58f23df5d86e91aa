"""Recognition benchmark sweep: the reference's accuracy/latency rig, CI-safe.

The port of ``shazam_tpu/bench/harness.py``: the same loop, the same draws
from one ``np.random.default_rng(seed)`` in the same order (start time,
then the channel per channel, then the noise per channel), so a seed cuts
the same fragments and makes the same noisy clips in both packages.
Reproduces the ``recognizer_test.py:516-614`` loop without the acoustic
mic loopback (the reference plays each fragment through speakers and
re-records it — untestable in CI; SURVEY.md §4): for every corpus song,
cut a random fragment (seeded), optionally mix noise at a target SNR
(AWGN or a noise recording, reference ``:412-435``), recognize through
the full index path, log per-stage timings, and checkpoint CSV/CM/CR/ACC
artifacts at 1/4, 2/4, 3/4 and the end (``:611-613``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..audio.io import read
from ..audio.noise import mix_at_snr, white_noise_for_snr, renormalize
from .report import generate_csv_results


@dataclasses.dataclass
class BenchConfig:
    record_seconds: float = 5.0        # RECORD_SECONDS
    add_noise: bool = False            # ADD_NOISE
    snr_db: float = 0.0                # SNR
    noise_kind: str = "file"           # "file" (noise recording) | "awgn"
    noise_file: Optional[str] = None
    channel: bool = False              # synthetic acoustic loop (audio/channel.py)
    channel_severity: float = 1.0      # 1 = stress rig; see CALIBRATED_SEVERITY
    topn: int = 3                      # TOPN (recognizer_test.py:38)
    seed: int = 1234
    out_dir: str = "bench_out"
    checkpoints: bool = True


def run_recognition_sweep(
    sia,
    songs: Sequence[str],
    config: BenchConfig = BenchConfig(),
) -> Dict:
    """Run the sweep; returns summary dict with accuracy + artifact paths.

    ``sia`` is any engine with ``config.sample_rate`` and
    ``recognize_samples(channels, topn=)``: an ``api.SIA`` or a
    ``parallel.serving.ShardedRecognizer``."""
    rng = np.random.default_rng(config.seed)
    fs = sia.config.sample_rate

    noise_samples = None
    if config.add_noise and config.noise_kind == "file" and config.noise_file:
        noise_channels, nfs, _ = read(config.noise_file)
        if nfs != fs:
            # same guard as the per-song check below: mixing a
            # wrong-rate noise recording silently shifts pitch/duration
            # and the reported SNR with it
            raise ValueError(
                f"{config.noise_file}: noise sample rate {nfs} != "
                f"config {fs}")
        noise_samples = noise_channels[0]

    predicted: List[str] = []
    finals: List[str] = []
    times: List[Dict] = []
    artifacts: List[Dict[str, str]] = []

    n = len(songs)
    quarter = math.floor(n / 4)
    marks = {quarter, quarter * 2, quarter * 3, n - 1} if config.checkpoints else {n - 1}

    for i, path in enumerate(songs):
        channels, file_fs, _sha = read(path)
        if file_fs != fs:
            # same guard as recognize_file: fingerprinting a clip at the
            # wrong rate silently pitch-shifts every hash (accuracy ~0
            # with no error) — fail loudly instead
            raise ValueError(
                f"{path}: sample rate {file_fs} != config {fs}")
        dur = len(channels[0]) / file_fs
        max_start = max(int(dur) - int(config.record_seconds), 1)
        start_s = int(rng.integers(0, max_start))
        a = int(start_s * file_fs)
        b = a + int(config.record_seconds * file_fs)
        # every channel of the recording, set-unioned by the recognizer —
        # the reference records stereo and unions both channels
        # (recognizer_test.py:564-580, recognizer.py:377-382)
        clips = [ch[a:b] for ch in channels]

        if config.channel:
            # synthetic acoustic loop standing in for the reference's
            # play-through-speakers rig (recognizer_test.py:561-580);
            # applied BEFORE additive noise, like a noisy room around a
            # physical playback. Seeded per clip from the sweep RNG.
            from ..audio.channel import simulate_channel

            clips = [simulate_channel(c, fs=fs, rng=rng,
                                      severity=config.channel_severity)
                     for c in clips]

        if config.add_noise:
            noisy_clips = []
            for clip in clips:
                if config.noise_kind == "awgn":
                    sig = renormalize(clip)
                    noisy = sig + white_noise_for_snr(sig, config.snr_db,
                                                      rng=rng)
                else:
                    if noise_samples is None:
                        raise ValueError("noise_kind='file' requires noise_file")
                    noisy = mix_at_snr(clip, noise_samples, config.snr_db,
                                       rng=rng)
                noisy_clips.append(
                    np.clip(noisy * 32767.0, -32768, 32767).astype(np.int16)
                )
            clips = noisy_clips

        out = sia.recognize_samples(clips, topn=config.topn)
        if out["results"]:
            predicted.append(str(out["results"][0]["song_name"]))
            finals.append(str(out["results"]))
        else:
            predicted.append("No results")
            finals.append("No results")
        times.append({
            "song_start_time": start_s,
            "fingerprint_times": out["fingerprint_time"],
            "query_time": out["query_time"],
            "align_time": out["align_time"],
            "total_time": out["total_time"],
        })

        if i in marks:
            artifacts.append(generate_csv_results(
                songs[: i + 1], predicted, times, finals, i,
                out_dir=config.out_dir,
                record_seconds=config.record_seconds,
                snr=config.snr_db if config.add_noise else None,
            ))

    true_names = [os.path.splitext(os.path.basename(p))[0] for p in songs]
    correct = sum(1 for t, p in zip(true_names, predicted) if t == p)
    return {
        "n": n,
        "correct": correct,
        "accuracy": correct / n if n else 0.0,
        "mean_total_time": float(np.mean([t["total_time"] for t in times])) if times else 0.0,
        "p50_total_time": float(np.median([t["total_time"] for t in times])) if times else 0.0,
        "artifacts": artifacts,
        "predicted": predicted,
    }
