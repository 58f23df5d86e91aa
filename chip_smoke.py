#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero):

1. build: compile the hand-written kernels ``shazam_tpu_torch/csrc/*.cu``
   with nvcc (sm_90a) and load them;
2. kernels: run K1 (spectrogram), K2 (peak mask) and K3 (compaction) on
   the card at the main path's shapes -- ingest (8, 1,572,864) samples,
   767 frames, peak capacity 16384; clip (1, 262,144), 127 frames,
   capacity 8192 -- and hold each against its plain PyTorch twin on the
   same inputs: K1 in dB, max |diff| < 1e-3 dB with exact zeros equal
   (both compute in float64; the distance of an f32 FFT from the twin is
   printed beside it, as the gap the bound has to tell apart); K2 and K3
   bit-exact.
   Kernel and plain times are CUDA-event medians;
3. end to end: ``SIA(device="cuda")`` ingests the catalog (2,035 seeded
   30 s synthetic songs, synthesized by a process pool, in chunks of 256)
   and ``recognize_clip`` answers seeded 5 s clips cut at frame-aligned
   offsets: every top-1 must be the source song with |offset error| <
   0.1 s, and each kernel's launch counter must have risen in this phase.
   Then ``torch.profiler`` traces the first 8 clips once more, and their
   device busy time over their unprofiled wall time gives the device's
   idle share during ``recognize_clip``.

It prints the card's name and power limit, build seconds, per-kernel
times, ingest seconds and rows, clip latencies and the idle share, then
one JSON line of per-kernel results and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import subprocess
import sys
import time

import numpy as np

FS = 44100
HOP = 2048
INGEST_SHAPE = (8, 1_572_864, 16384, 30.0)  # batch, samples, capacity, song s
CLIP_SHAPE = (1, 262_144, 8192, 5.0)
CLIP_S = 5.0
# K1 and its plain twin both compute in float64 and round to f32 once, so
# they may differ only by that rounding; an f32 FFT misses this by far
K1_DB_BOUND = 1e-3
PROFILED_CLIPS = 8
KERNELS = (
    ("spectrogram_power", "shazam_tpu_torch/csrc/spectrogram.cu",
     "shazam_tpu/ops/pallas/spectrogram.py:107"),
    ("peak_mask", "shazam_tpu_torch/csrc/peaks.cu",
     "shazam_tpu/ops/pallas/peaks.py:107"),
    ("compact", "shazam_tpu_torch/csrc/compact.cu",
     "shazam_tpu/ops/pallas/compact.py:136"),
)


def _song(i: int) -> np.ndarray:
    from shazam_tpu_torch.audio import synth_song

    return synth_song(i, 30.0, seed=i)


def _event_ms(fn, calls: int = 10) -> float:
    """Device milliseconds per call over ``calls`` back-to-back calls,
    between two CUDA events (one call alone is mostly launch jitter)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _timed_pair(kernel_fn, plain_fn, reps: int = 5):
    """Median ms per call of kernel and plain, measured in turns (plain,
    kernel, kernel, plain, ...) after one warm-up of each."""
    import torch

    kernel_fn()
    plain_fn()
    torch.cuda.synchronize()
    k, p = [], []
    for r in range(reps):
        order = ((plain_fn, p), (kernel_fn, k))
        for fn, acc in (order if r % 2 == 0 else order[::-1]):
            acc.append(_event_ms(fn))
    return float(np.median(k)), float(np.median(p))


def _device_busy_ms(fn):
    """Milliseconds in which the card ran any kernel, copy or memset that
    ``fn`` issued (the union of their intervals in a ``torch.profiler``
    trace), or None when the trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e3 if spans else None


def check_kernels(device) -> dict:
    """Phase 2: each kernel against its plain twin at both main-path shapes."""
    import torch

    from shazam_tpu_torch.audio import synth_song
    from shazam_tpu_torch.ops.cuda import compact as k3
    from shazam_tpu_torch.ops.cuda import peaks as k2
    from shazam_tpu_torch.ops.cuda import spectrogram as k1
    from shazam_tpu_torch.ops.peaks import compact_plain, peak_mask_plain
    from shazam_tpu_torch.ops.spectrogram import (db_spectrogram,
                                                  spectrogram_power_plain)

    out = {name: {} for name, _, _ in KERNELS}
    for label, (bsz, n, cap, secs) in (("ingest", INGEST_SHAPE),
                                       ("clip", CLIP_SHAPE)):
        x = np.zeros((bsz, n), np.float32)
        nvf = np.zeros(bsz, np.int32)
        for i in range(bsz):
            s = synth_song(i, secs, seed=i).astype(np.float32)
            x[i, : len(s)] = s
            nvf[i] = (len(s) - 4096) // HOP + 1
        xs = torch.from_numpy(x).to(device)
        nv = torch.from_numpy(nvf).to(device)

        power = k1.spectrogram_power(xs, nv)
        power_p = spectrogram_power_plain(xs, nv)
        power_f32 = spectrogram_power_plain(xs, nv,
                                            compute_dtype=torch.float32)
        torch.cuda.synchronize()
        if not torch.isfinite(power).all():
            raise AssertionError(f"K1 {label}: non-finite power")
        db_p = db_spectrogram(power_p)
        k1_err = float((db_spectrogram(power) - db_p).abs().max())
        f32_err = float((db_spectrogram(power_f32) - db_p).abs().max())
        del power_f32
        if not (k1_err < K1_DB_BOUND and torch.equal(power == 0, power_p == 0)):
            raise AssertionError(
                f"K1 {label}: max|ddB| {k1_err} (bound {K1_DB_BOUND}) or "
                "exact zeros differ")

        bits = k2.peak_mask(power, 10.0)
        bits_p = peak_mask_plain(power, 10.0)
        torch.cuda.synchronize()
        k2_err = int((bits != bits_p).sum())
        if k2_err:
            raise AssertionError(f"K2 {label}: {k2_err} mask words differ")

        got = k3.compact(bits, cap)
        ref = compact_plain(bits, cap)
        torch.cuda.synchronize()
        k3_err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, ref))
        if k3_err:
            raise AssertionError(f"K3 {label}: (times, freqs, n_peaks) differ")
        if int(got[2].max()) > cap:
            raise AssertionError(f"K3 {label}: peak capacity {cap} overflowed")

        timings = (
            ("spectrogram_power", lambda: k1.spectrogram_power(xs, nv),
             lambda: spectrogram_power_plain(xs, nv), k1_err),
            ("peak_mask", lambda: k2.peak_mask(power, 10.0),
             lambda: peak_mask_plain(power, 10.0), k2_err),
            ("compact", lambda: k3.compact(bits, cap),
             lambda: compact_plain(bits, cap), k3_err),
        )
        for name, kfn, pfn, e in timings:
            ms, plain_ms = _timed_pair(kfn, pfn)
            out[name][label] = {"ms": ms, "plain_ms": plain_ms, "err": e}
            print(f"kernel {name} {label} {tuple(x.shape)}: {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, max_abs_err {e}"
                  + (" dB" if name == "spectrogram_power" else ""), flush=True)
        print(f"K1 {label}: max|ddB| {k1_err:.3g} (bound {K1_DB_BOUND}); an "
              f"f32 torch.fft.rfft is {f32_err:.6f} dB from the same float64 "
              f"twin; n_peaks {got[2].tolist()}", flush=True)
    return out


def end_to_end(device, n_songs: int, n_clips: int, seed: int,
               workers: int) -> dict:
    """Phase 3: ingest the synthetic catalog, recognize seeded clips."""
    import torch

    from shazam_tpu_torch.api import SIA

    rng = np.random.default_rng(seed)
    clip_len = int(CLIP_S * FS)
    max_frame = (int(30.0 * FS) - clip_len) // HOP
    picks = [(int(rng.integers(n_songs)), int(rng.integers(0, max_frame + 1)))
             for _ in range(n_clips)]
    keep = {sid for sid, _ in picks}
    sources = {}

    sia = SIA(device=device)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hashes = 0
    sia_s = 0.0  # inside SIA.ingest_arrays; the rest is waiting on synthesis
    ctx = mp.get_context("spawn")
    with ctx.Pool(workers) as pool:
        chunk = []
        for i, song in enumerate(pool.imap(_song, range(n_songs), chunksize=4)):
            if i in keep:
                sources[i] = song
            chunk.append((f"song{i:05d}", song))
            if len(chunk) == 256 or i == n_songs - 1:
                stats = sia.ingest_arrays(chunk)
                hashes += stats["hashes"]
                sia_s += stats["seconds"]
                chunk = []
        pool.close()
        pool.join()
    ingest_s = time.perf_counter() - t0
    rows = sia.index.n_hashes
    counts = sia.catalog.counts()
    if not (rows == hashes == counts["n_hashes"]
            and counts["n_songs"] == n_songs):
        raise AssertionError(f"index rows {rows}, ingested hashes {hashes}, "
                             f"catalog {counts}")
    print(f"ingest: {n_songs} songs x 30 s, {rows} rows, wall {ingest_s:.3f} s "
          f"with synthesis, {sia_s:.3f} s in SIA.ingest_arrays "
          f"({n_songs * 0.5 / sia_s:.3f} audio-min/s)", flush=True)

    def clip_of(sid, frame):
        return sources[sid][frame * HOP: frame * HOP + clip_len]

    sia.recognize_clip(clip_of(*picks[0]))  # uploads the device index
    lat, wrong = [], []
    for sid, frame in picks:
        c = clip_of(sid, frame)
        t = time.perf_counter()
        res = sia.recognize_clip(c)
        lat.append(time.perf_counter() - t)
        top = res["results"][0] if res["results"] else None
        if (top is None or top["song_name"] != f"song{sid:05d}"
                or abs(top["offset_seconds"] - frame * HOP / FS) >= 0.1):
            wrong.append((sid, frame, top))
    print(f"recognize_clip: {n_clips} clips of {CLIP_S} s, p50 "
          f"{1e3 * float(np.median(lat)):.3f} ms, max "
          f"{1e3 * max(lat):.3f} ms, wrong {len(wrong)}", flush=True)
    if wrong:
        raise AssertionError(f"wrong top-1: {wrong[:5]}")
    peak_mib = (torch.cuda.max_memory_allocated() / 2**20 if on_card
                else None)
    print(f"peak device memory allocated: {peak_mib} MiB", flush=True)

    # idle share: device busy time of the first clips, traced, over the
    # host wall time the same clips took above without the profiler
    traced = picks[:PROFILED_CLIPS]
    busy_ms = idle = None
    if on_card:
        busy_ms = _device_busy_ms(
            lambda: [sia.recognize_clip(clip_of(*p)) for p in traced])
    wall_ms = 1e3 * sum(lat[: len(traced)])
    if busy_ms is not None:
        idle = 1.0 - busy_ms / wall_ms
        print(f"recognize_clip device busy {busy_ms / len(traced):.3f} ms per "
              f"clip (torch.profiler, {len(traced)} clips) over "
              f"{wall_ms / len(traced):.3f} ms unprofiled wall: idle share "
              f"{idle:.4f}", flush=True)
    else:
        print("recognize_clip device busy: not measured", flush=True)
    return {"songs": n_songs, "rows": rows, "ingest_wall_s": ingest_s,
            "ingest_s": sia_s,
            "clip_p50_ms": 1e3 * float(np.median(lat)),
            "clip_max_ms": 1e3 * max(lat), "peak_device_mib": peak_mib,
            "clip_device_busy_ms": (None if busy_ms is None
                                    else busy_ms / len(traced)),
            "clip_idle_share": idle}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--songs", type=int, default=2035)
    ap.add_argument("--clips", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from shazam_tpu_torch import _build
    from shazam_tpu_torch.device import resolve_device
    from shazam_tpu_torch.ops.cuda import compact, peaks, spectrogram

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    device = resolve_device("cuda")

    t0 = time.perf_counter()
    compiled = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc {compiled:.3f} s)",
          flush=True)

    measured = check_kernels(device)

    wrappers = {"spectrogram_power": spectrogram.KERNEL,
                "peak_mask": peaks.KERNEL, "compact": compact.KERNEL}
    for k in wrappers.values():
        k.launches = 0
    e2e = end_to_end(device, args.songs, args.clips, args.seed,
                     os.cpu_count() or 1)
    launches = {name: k.launches for name, k in wrappers.items()}
    print(f"launches: {launches}", flush=True)
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels not launched by the main path: {idle}")

    report = []
    for name, source, replaces in KERNELS:
        m = measured[name]
        report.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(m["ingest"]["err"], m["clip"]["err"]),
            "ms": m["ingest"]["ms"], "plain_ms": m["ingest"]["plain_ms"],
            "clip_ms": m["clip"]["ms"], "clip_plain_ms": m["clip"]["plain_ms"],
        })
    print(json.dumps({"kernels": report, "end_to_end": e2e}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
