"""Closed loop of the reference's one-shot listener: stereo clips back to
back through ``SIA.recognize_clip``, each timed from the call until its
answer is on the host.

The reference's recognizer (``recognizer.py:355-382``) records a few
seconds in stereo, fingerprints both channels and queries the set union
of their (hash, offset) pairs. Here each clip is a (channels, N) int16
array handed whole to ``recognize_clip``.

Mix keys: ``clip_s``, ``channels``, ``pool`` (clips made in set-up,
cycled in the window), ``conditions``, ``warm_clips`` (run in set-up),
``trace_clips`` (the traced stretch after the window),
``compare_clips`` and ``compare_songs`` (the sample the reference
checks), as in ``listen.py``.

Per-channel draws: ``lib/clips.py`` draws each clip's song, start and
condition from the seed, as for a mono listener; channel ``c`` of clip
``k`` is then degraded on a draw of its own (``clips.degrade`` with
index ``k + c * pool``). A clean clip is dual-mono (L = R); under the
``channel`` and ``awgn`` conditions L and R differ as two microphones'
takes do. Channel 0 is the mono listener's clip ``k``.

Besides ``run``, the module's command line gives the cell's control
(the plain reference with its power in bfloat16, judged by the cell's
own comparison; it has to come out ``correct`` false) and the stereo
pair (``recognize_clip`` against ``recognize_samples([L, R])`` on the
same card and clips, and the lanes of each clip), one JSON line a seed,
each naming its device. Both exit 2 without a CUDA device, as ``run.py``
does, and run with its TF32 settings:

    python3 -m benchmark_torch.lib.drivers.oneshot --control \
        --workload ref2035-listen5 --seeds 1 2 3
    python3 -m benchmark_torch.lib.drivers.oneshot --pair \
        --workload ref2035-listen5 --seeds 7 --seconds 30
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import catalog, check, clips, common, host, refrun, spans
from .. import trace as tracing
from ..common import Ctx, Outcome
from ..roofline import frames
from ..stats import percentile


def stereo_pool(ctx: Ctx, cutter: clips.ClipCutter, workers: int = 8):
    """The pool's clips as (channels, N) int16 arrays, each channel
    degraded on its own draw (the module's docstring)."""
    pool, chans = len(cutter.raw), int(ctx.mix["channels"])

    def one(k):
        cond = ctx.mix["conditions"][int(cutter.p.conditions[k])]
        return np.stack([clips.degrade(cutter.raw[k], cond, ctx.fs,
                                       ctx.seed, k + c * pool)
                         for c in range(chans)])

    with ThreadPoolExecutor(workers) as ex:
        return list(ex.map(one, range(pool)))


def setup(ctx: Ctx):
    """The catalog and the pool of stereo clips: (sia, pool, plan)."""
    n_samp = int(ctx.cfg["song_s"] * ctx.fs)
    plan = clips.plan(ctx.mix, ctx.cfg["songs"], n_samp, ctx.fs, ctx.seed)
    cutter = clips.ClipCutter(plan)
    t0 = time.perf_counter()
    common.log(f"set-up: {t0 - ctx.t_start:.3f} s to the first render "
               "(imports, CUDA init)")
    sia, _, rows = catalog.build(ctx.cfg, ctx.seed, ctx.device,
                                 on_batch=cutter.take)
    common.sync(ctx.device)
    t1 = time.perf_counter()
    pool = stereo_pool(ctx, cutter)
    common.log(f"set-up: catalog of {ctx.cfg['songs']} songs ({rows} rows) "
               f"rendered and ingested in {t1 - t0:.3f} s; {len(pool)} "
               f"stereo clips degraded in {time.perf_counter() - t1:.3f} s")
    return sia, pool, plan


def row_shape(sia, clip_len: int) -> dict:
    """K1-K3's launch shape for one channel row of a clip
    (``lib.roofline``)."""
    return {"nvf": [frames(clip_len, sia.config.window_size,
                           sia.config.hop)],
            "n_frames": frames(check.bucket_len(clip_len),
                               sia.config.window_size, sia.config.hop),
            "cap": sia.config.peak_capacity}


def capture_fingerprints(sia, clips_of: dict) -> dict:
    """{k: the first output of ``match.ondevice._fingerprint_clip``} as
    ``sia.recognize_clip`` builds it for each clip (None where the entry
    point did not reach that step), as ``check.recognized_clip_pairs``
    wraps it."""
    from shazam_tpu_torch.match import ondevice

    inner = ondevice._fingerprint_clip
    seen = []

    def capture(*args, **kwargs):
        fp = inner(*args, **kwargs)
        seen.append(fp)
        return fp

    out = {}
    ondevice._fingerprint_clip = capture
    try:
        for k, clip in clips_of.items():
            seen.clear()
            sia.recognize_clip(clip)
            out[k] = seen[0] if seen else None
    finally:
        ondevice._fingerprint_clip = inner
    return out


def union_pairs(fp) -> set:
    """The union of the unique (hash, offset) pairs of every row of the
    program's fingerprint lanes."""
    return set().union(*(check.fingerprint_pairs(fp, r)
                         for r in range(fp.hi.shape[0])))


def stereo_pairs(sia, clips_of: dict) -> dict:
    """{k: ``union_pairs`` of the query fingerprint} that
    ``recognize_clip`` builds for each clip."""
    return {k: None if fp is None else union_pairs(fp)
            for k, fp in capture_fingerprints(sia, clips_of).items()}


def union_dup_share(recs) -> float | None:
    """Share in % of the query lanes that the union dedup removed: 1 -
    the summed ``pairs`` over the summed lanes the dedup took, from the
    attributes of the ``sia.recognize_clip`` span records (``lanes``, the
    valid lanes of every channel row, each root's taken up to the
    ``query_capacity`` of its ``match.dedup`` span). A clean dual-mono
    clip reads 50 %. None where no root carries the attributes. The
    traffic fixes it (the dedup is exact), so it is logged, not judged."""
    cap = {r.parent: r.attrs["query_capacity"]
           for r in spans.named(recs, "match.dedup")
           if "query_capacity" in r.attrs}
    lanes = pairs = 0
    for r in spans.named(recs, "sia.recognize_clip"):
        if "lanes" in r.attrs and "pairs" in r.attrs:
            lanes += min(r.attrs["lanes"], cap.get(r.index, r.attrs["lanes"]))
            pairs += r.attrs["pairs"]
    return 100.0 * (1.0 - pairs / lanes) if lanes else None


def reference(cfg: dict, seed: int, device, clips_of, songs, dtypes,
              on_batch=None) -> dict:
    """``refrun.listen`` for stereo clips: for each dtype name, the rows
    of catalog ``songs``, each clip's query (the union of its channels'
    pairs, ``reference/stereo.py``) and its answer over the whole
    catalog. ``clips_of`` is {k: (C, N) samples} or a callable that gives
    it once every batch has passed ``on_batch``."""
    import torch

    from ...reference.fingerprint import Fingerprinter
    from ...reference.match import Catalog, match
    from ...reference.stereo import union_rows

    fps = {d: Fingerprinter(cfg["fingerprint"], *refrun.PRECISIONS[d])
           for d in dtypes}
    parts = {d: [] for d in dtypes}
    rows = {d: {} for d in dtypes}
    songs = set(int(s) for s in songs)
    gen = catalog.generator(cfg, seed, device)
    for first, ids, audio in catalog.batches(cfg, gen):
        for d, fp in fps.items():
            b, key, t1 = fp.rows(audio, gen.n_samp)
            parts[d].append((b + first, key, t1))
            for s in songs.intersection(ids):
                sel = b == s - first
                rows[d][s] = fp.hex_pairs(key[sel], t1[sel])
        if on_batch is not None:
            on_batch(first, audio)
        del audio
    if callable(clips_of):
        clips_of = clips_of()
    out = {}
    for d, fp in fps.items():
        cat = Catalog.concat(parts[d])
        parts[d] = None
        pairs, answers = {}, {}
        for k, clip in clips_of.items():
            x = torch.as_tensor(clip, device=device).float()
            key, t1 = union_rows(fp, x, clip.shape[1])
            pairs[k] = fp.hex_pairs(key, t1)
            answers[k] = match(cat, key, t1)
        out[d] = {"rows": rows[d], "pairs": pairs, "answers": answers}
        del cat
    return out


def run(ctx: Ctx) -> Outcome:
    sia, pool, plan = setup(ctx)
    n = len(pool)
    for k in range(int(ctx.mix["warm_clips"])):
        sia.recognize_clip(pool[k % n])
    common.sync(ctx.device)
    common.reset_peak(ctx.device)
    common.quiet_gc()
    setup_s = time.perf_counter() - ctx.t_start

    # handoffs: clips that recognize_clip passes to recognize_samples,
    # and the reason it names (where the program names one)
    calls, reasons = [0], Counter()
    inner = sia.recognize_samples
    inner_handoff = getattr(sia, "_handoff", None)

    def counted(*args, **kwargs):
        calls[0] += 1
        return inner(*args, **kwargs)

    def named(samples, topn, reason):
        reasons[reason] += 1
        return inner_handoff(samples, topn, reason)

    sia.recognize_samples = counted
    if inner_handoff is not None:
        sia._handoff = named
    lat, answers, failed, i, handed = [], {}, 0, 0, []
    h0 = host.snapshot()
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    while time.perf_counter() < end:
        k = i % n
        before = calls[0]
        s = time.perf_counter()
        try:
            r = sia.recognize_clip(pool[k])
        except Exception as e:          # a failed request, counted
            failed += 1
            common.log(f"clip {k} raised {e!r}")
            r = None
        lat.append(time.perf_counter() - s)
        handed.append(calls[0] > before)
        if r is not None:
            answers.setdefault(k, []).append(r)
        i += 1
    common.sync(ctx.device)
    peak = common.memory_peak(ctx.device)
    handoffs = calls[0]
    sia.recognize_samples = inner
    if inner_handoff is not None:
        del sia._handoff
    common.log(f"window: {i} clips in {time.perf_counter() - t0:.3f} s, "
               f"{handoffs} handed to recognize_samples "
               f"({dict(sorted(reasons.items()))}), {failed} failed")
    common.log_host(ctx, h0)
    common.accuracy(ctx, plan, answers)

    tr = None
    if ctx.trace:
        m = int(ctx.mix["trace_clips"])
        tr = tracing.trace(lambda: [sia.recognize_clip(pool[(i + j) % n])
                                    for j in range(m)], units=m)
        common.log("traced stretch: the union dedup removed "
                   f"{union_dup_share(spans.records())} % of the lanes")
    obs = {"trace": tr, "clips": i, "handoffs": handoffs,
           "fp_row_shape": row_shape(sia, plan.length)}
    prog = common.program_outputs(
        ctx, sia, answers,
        lambda ks: stereo_pairs(sia, {k: pool[k] for k in ks}))
    del sia, inner, counted, inner_handoff, named
    common.free(ctx.device)
    t1 = time.perf_counter()
    ref = reference(ctx.cfg, ctx.seed, ctx.device,
                    {k: pool[k] for k in prog["sample"]}, prog["songs"],
                    [refrun.REFERENCE])[refrun.REFERENCE]
    common.sync(ctx.device)
    common.log(f"reference: {time.perf_counter() - t1:.3f} s")
    readings = common.compare_listen(prog, ref, plan)
    ms = [1e3 * x for x in lat]
    common.log(f"latency over {len(ms)} clips: p50 {percentile(ms, 50)} ms, "
               f"p95 {percentile(ms, 95)} ms ({len(ms) - int(0.95 * len(ms))}"
               " beyond it); p10/p25/p75/p90 "
               f"{[round(percentile(ms, q), 3) for q in (10, 25, 75, 90)]}")
    for label, part in (("one pass", [m for m, h in zip(ms, handed) if not h]),
                        ("handed off", [m for m, h in zip(ms, handed) if h])):
        if part:
            common.log(f"  {label}: {len(part)} clips, p50 "
                       f"{percentile(part, 50):.3f} ms")
    return Outcome(setup_s=setup_s, attempted=i, failed=failed,
                   end_to_end={"clip_ms_p50": percentile(ms, 50),
                               "clip_ms_p95": percentile(ms, 95)},
                   obs=obs, readings=readings, memory_peak=peak, trace=tr)


def control_readings(ctx: Ctx) -> dict:
    """The cell's control: the catalog's rows, the clips' union pairs and
    their answers over the whole catalog from the reference with its
    power in bfloat16, in the program's place, against the float32
    reference (``control.listen_readings`` for stereo clips)."""
    from ...control import as_answer

    plan = clips.plan(ctx.mix, ctx.cfg["songs"],
                      int(ctx.cfg["song_s"] * ctx.fs), ctx.fs, ctx.seed)
    cutter = clips.ClipCutter(plan)
    sample, songs = common.sample_of(ctx, range(len(plan.songs)))

    def sampled():
        made = stereo_pool(ctx, cutter)
        return {k: made[k] for k in sample}

    ref = reference(ctx.cfg, ctx.seed, ctx.device, sampled, songs,
                    [refrun.REFERENCE, "bfloat16"], on_batch=cutter.take)
    low = ref["bfloat16"]
    prog = {"sample": sample, "songs": songs,
            "answers": {k: [as_answer(low["answers"][k])] for k in sample},
            "rows": low["rows"], "pairs": low["pairs"]}
    return common.compare_listen(prog, ref[refrun.REFERENCE], plan)


def _summary(values) -> dict:
    return {q: percentile(values, p) for q, p in
            (("min", 0), ("p25", 25), ("p50", 50), ("p75", 75), ("p95", 95),
             ("max", 100))}


def stereo_pair(ctx: Ctx) -> dict:
    """What the single pass buys a stereo listener: on the same SIA and
    clips, in turns (the order flipped every clip) for ``ctx.seconds``,
    ``recognize_clip(clip)`` against ``recognize_samples([L, R])``, the
    parent's only stereo path; and each pool clip's valid lanes (every
    row), union pairs and largest peak count, from the fingerprint its
    single pass builds."""
    sia, pool, plan = setup(ctx)
    n = len(pool)
    for k in range(int(ctx.mix["warm_clips"])):
        sia.recognize_clip(pool[k % n])
        sia.recognize_samples(list(pool[k % n]))
    fps = capture_fingerprints(sia, dict(enumerate(pool)))
    lanes = {k: int(fp.valid.sum()) for k, fp in fps.items()}
    pairs = {k: len(union_pairs(fp)) for k, fp in fps.items()}
    peaks = {k: int(fp.n_peaks.max()) for k, fp in fps.items()}
    common.sync(ctx.device)
    times = {"recognize_clip": [], "recognize_samples": []}
    calls = {"recognize_clip": lambda c: sia.recognize_clip(c),
             "recognize_samples": lambda c: sia.recognize_samples(list(c))}
    i = 0
    end = time.perf_counter() + ctx.seconds
    while time.perf_counter() < end:
        order = sorted(calls, reverse=bool(i % 2))
        for name in order:
            s = time.perf_counter()
            calls[name](pool[i % n])
            times[name].append(1e3 * (time.perf_counter() - s))
        i += 1
    conds = [c["name"] for c in ctx.mix["conditions"]]
    by_cond = {name: _summary([lanes[k] for k in range(n)
                                 if plan.conditions[k] == c])
               for c, name in enumerate(conds)}
    out = {"clips_timed": i,
           **{f"{name}_ms": {"p50": percentile(t, 50),
                             "p95": percentile(t, 95)}
              for name, t in times.items()},
           "lanes": _summary(list(lanes.values())),
           "lanes_by_condition": by_cond,
           "pairs": _summary(list(pairs.values())),
           "union_dup_share": 1.0 - sum(pairs.values()) / max(
               sum(lanes.values()), 1),
           "lanes_over": {str(c): sum(v > c for v in lanes.values())
                          for c in (2048, 3072, 4096, 6144, 8192)},
           "peaks_over_capacity": sum(v > sia.config.peak_capacity
                                      for v in peaks.values())}
    out["card"] = host.gpu_state()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--control", action="store_true")
    mode.add_argument("--pair", action="store_true")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    import torch

    from ...run import cell_inputs, load_benchmark

    _, cfg, mix = cell_inputs(load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print(f"{args.workload}: the control and the pair run on a CUDA "
              "device; found none", file=sys.stderr)
        return 2
    # run.py's settings, which the cell's runs and its control share
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = {"platform": "gpu", "kind": torch.cuda.get_device_name(device)}
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.control:
            ctx = Ctx(cfg, mix, seed, 0.0, False, device, t0)
            correct, checks = check.verdict(control_readings(ctx))
            out = {"control": "reference, power in bfloat16",
                   "correct": correct, "checks": checks}
        else:
            out = stereo_pair(Ctx(cfg, mix, seed, args.seconds, False,
                                  device, t0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "device": card,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
