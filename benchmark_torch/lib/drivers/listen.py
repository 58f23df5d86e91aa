"""Closed loop of one listener: clips back to back through
``SIA.recognize_clip``, each timed from the call until its answer is on
the host.

Mix keys: ``clip_s``, ``pool`` (clips made in set-up, cycled in the
window), ``conditions``, ``warm_clips`` (run in set-up, so that the
decide tier's adaptation has settled), ``trace_clips`` (the traced
stretch after the window), ``compare_clips`` and ``compare_songs`` (the
sample the reference checks).
"""

from __future__ import annotations

import time

from .. import check, common, host, trace as tracing
from ..common import Ctx, Outcome
from ..stats import percentile


def run(ctx: Ctx) -> Outcome:
    sia, pool, plan = common.listener_setup(ctx)
    n = len(pool)
    for k in range(int(ctx.mix["warm_clips"])):
        sia.recognize_clip(pool[k % n])
    common.sync(ctx.device)
    common.reset_peak(ctx.device)
    common.quiet_gc()
    setup_s = time.perf_counter() - ctx.t_start

    # handoffs: clips that recognize_clip passes to recognize_samples
    calls = [0]
    inner = sia.recognize_samples

    def counted(*args, **kwargs):
        calls[0] += 1
        return inner(*args, **kwargs)

    sia.recognize_samples = counted
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
    common.log(f"window: {i} clips in {time.perf_counter() - t0:.3f} s, "
               f"{handoffs} handed to recognize_samples, {failed} failed")
    common.log_host(ctx, h0)
    common.accuracy(ctx, plan, answers)

    tr = None
    if ctx.trace:
        m = int(ctx.mix["trace_clips"])
        tr = tracing.trace(lambda: [sia.recognize_clip(pool[(i + j) % n])
                                    for j in range(m)], units=m)
    obs = {"trace": tr, "clips": i, "handoffs": handoffs,
           "fp_shape": common.clip_shape(sia, plan.length)}
    prog = common.program_outputs(
        ctx, sia, answers, lambda ks: check.recognized_clip_pairs(
            sia, {k: pool[k] for k in ks}))
    del sia, inner, counted
    common.free(ctx.device)
    readings = common.reference_readings(ctx, prog, pool, plan)
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
