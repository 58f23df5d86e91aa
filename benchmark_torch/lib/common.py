"""What the drivers share: the run's context, device bookkeeping, the
listener clips and the comparison of answers with the reference."""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass

import numpy as np

from . import catalog, check, clips, host, refrun
from .roofline import frames


@dataclass
class Ctx:
    """One run of one cell."""

    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float            # perf_counter at process start

    @property
    def fs(self) -> int:
        return self.cfg["fingerprint"].get("sample_rate", 44100)


@dataclass
class Outcome:
    """What a driver hands back to ``run.py``."""

    setup_s: float
    attempted: int
    failed: int
    end_to_end: dict                       # metric name -> value
    obs: dict                              # what per-layer readers read
    readings: dict                         # check name -> number
    memory_peak: int
    trace: object = None                   # lib.trace.Trace


sync = catalog.sync


def reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def memory_peak(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


def quiet_gc() -> None:
    """Collect once and move every object to the permanent generation, so
    that no full collection runs inside the window."""
    gc.collect()
    gc.freeze()


def free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def log_host(ctx: Ctx, before: dict) -> None:
    """The host since ``before`` (``host.snapshot()`` at the window's
    start) and the card's clocks, after the window."""
    log(host.report(before, host.snapshot()))
    if ctx.device.type == "cuda":
        log(f"card after the window: {host.gpu_state()}")


def listener_setup(ctx: Ctx):
    """The catalog and the pool of clips: (sia, pool, plan)."""
    n_samp = int(ctx.cfg["song_s"] * ctx.fs)
    plan = clips.plan(ctx.mix, ctx.cfg["songs"], n_samp, ctx.fs, ctx.seed)
    cutter = clips.ClipCutter(plan)
    t0 = time.perf_counter()
    log(f"set-up: {t0 - ctx.t_start:.3f} s to the first render "
        "(imports, CUDA init)")
    sia, _, rows = catalog.build(ctx.cfg, ctx.seed, ctx.device,
                             on_batch=cutter.take)
    sync(ctx.device)
    t1 = time.perf_counter()
    pool = cutter.finish(ctx.mix, ctx.fs, ctx.seed)
    log(f"set-up: catalog of {ctx.cfg['songs']} songs "
        f"({rows} rows) rendered and ingested in "
        f"{t1 - t0:.3f} s; {len(pool)} clips degraded in "
        f"{time.perf_counter() - t1:.3f} s")
    return sia, pool, plan


def clip_shape(sia, clip_len: int) -> dict:
    """K1-K3's launch shape for one clip (``lib.roofline``)."""
    return {"nvf": [frames(clip_len, sia.config.window_size, sia.config.hop)],
            "n_frames": frames(check.bucket_len(clip_len),
                               sia.config.window_size, sia.config.hop),
            "cap": sia.config.peak_capacity}


def accuracy(ctx: Ctx, plan, answers: dict) -> None:
    """Print, per condition, the share of answered clips ({k: [answer, ...]},
    the first answer of each) whose top song is the clip's source (the reference's 0.9624 on its 2,714-song catalog,
    15 s clips), and the share also within 0.1 s of the clip's start."""
    hop = ctx.cfg["fingerprint"].get("window_size", 4096) // 2
    for c, cond in enumerate(ctx.mix["conditions"]):
        ks = [k for k in answers if plan.conditions[k] == c]
        right = at = 0
        for k in ks:
            res = (answers[k][0] or {}).get("results") or []
            if res and refrun.song_index(res[0]["song_name"]) == plan.songs[k]:
                right += 1
                at += abs(res[0]["offset"] * hop / ctx.fs
                          - plan.starts[k] / ctx.fs) < 0.1
        n = max(len(ks), 1)
        log(f"accuracy {cond['name']}: song {right / n:.4f}, song and "
            f"offset {at / n:.4f} over {len(ks)} clips")


def sample_of(ctx: Ctx, answered) -> tuple:
    """(clips, catalog songs) the comparison reads, drawn from the seed:
    ``compare_clips`` of the ``answered`` clips and ``compare_songs``
    songs of the catalog."""
    rng = np.random.default_rng([ctx.seed, 3])
    answered = sorted(answered)
    n = min(int(ctx.mix["compare_clips"]), len(answered))
    sample = sorted(int(k) for k in rng.choice(answered, n, replace=False))
    songs = sorted({int(s) for s in rng.choice(
        ctx.cfg["songs"], int(ctx.mix["compare_songs"]), replace=False)})
    return sample, songs


def program_outputs(ctx: Ctx, sia, answers: dict, pairs_of) -> dict:
    """What the comparison needs of the program, taken before it is freed:
    every answer ({k: [answer, ...]}) and the store rows of the sample, and the query pairs that
    ``pairs_of(sample)`` reads from the entry point the window drove."""
    sample, songs = sample_of(ctx, answers)
    ids = catalog.ids_by_name(sia)
    return {"sample": sample, "songs": songs,
            "answers": {k: answers[k] for k in sample},
            "rows": check.store_rows(
                sia, {s: ids.get(catalog.song_name(s), -1) for s in songs}),
            "pairs": pairs_of(sample)}


def reference_readings(ctx: Ctx, prog: dict, pool, plan) -> dict:
    """Readings of ``lib.check`` for a listener cell, once the program is
    freed."""
    t0 = time.perf_counter()
    ref = refrun.listen(ctx.cfg, ctx.seed, ctx.device,
                        {k: pool[k] for k in prog["sample"]}, prog["songs"],
                        [refrun.REFERENCE])[refrun.REFERENCE]
    sync(ctx.device)
    log(f"reference: {time.perf_counter() - t0:.3f} s")
    return compare_listen(prog, ref, plan)


def compare_listen(prog: dict, ref: dict, plan) -> dict:
    """The readings of a listener cell: ``prog`` (the program's outputs,
    or the control's in their form) against the reference's ``ref``."""
    sample, songs = prog["sample"], prog["songs"]
    off, counts = 0, 0.0
    for k in sample:
        whys = set()
        wrong_k = 0
        for r in prog["answers"][k]:     # every answer the window gave k
            wrong, gap, why = check.answer_gap(r, ref["answers"][k],
                                               refrun.song_index)
            wrong_k = max(wrong_k, wrong)
            counts = max(counts, gap)
            whys.add(why)
        off += wrong_k
        for why in sorted(whys - {""}):
            log(f"clip {k} (song {plan.songs[k]}, condition "
                f"{plan.conditions[k]}): {why}")
    for s in songs:
        if check.gap(prog["rows"][s], ref["rows"][s]) > 0.01:
            a, b = prog["rows"][s], ref["rows"][s]
            log(f"song {s}: {len(a)} rows in the store, {len(b)} in the "
                f"reference, {len(a - b)} extra, {len(b - a)} missing")
    gaps = {}
    for k in sample:
        got = prog["pairs"][k]
        if got is None:
            log(f"clip {k}: no query fingerprint captured at the entry "
                "point (lib/check.py names the step it wraps)")
        gaps[k] = 1.0 if got is None else check.gap(got, ref["pairs"][k])
        if gaps[k] > 0.01:
            log(f"clip {k} (song {plan.songs[k]}, condition "
                f"{plan.conditions[k]}): pairs gap {gaps[k]:.5f} "
                f"({len(ref['pairs'][k])} pairs in the reference)")
    return {"answers_off": off, "count_gap": counts,
            "store_row_gap": max(check.gap(prog["rows"][s], ref["rows"][s])
                                 for s in songs),
            "clip_hash_gap": float(np.median(list(gaps.values())))}
