"""Closed loop of concurrent listeners against the program's HTTP daemon:
an in-process ``serve.RecognitionServer`` takes POST ``/recognize`` of
mono int16 WAV clips from clients that run in a process of their own, so
that their Python does not take the server's interpreter lock.

Mix keys: the listener keys of ``listen.py`` (``clip_s``, ``pool``,
``conditions``, ``compare_clips``, ``compare_songs``), ``clients``,
``max_batch`` and ``max_wait_ms`` (the daemon's), ``warm_s`` (load before
the window, counted in set-up) and ``trace_s`` (the traced stretch, a
third into the window of a traced run; the daemon's counters that the
per-layer metrics read are taken over the window's untraced stretch before
it).
"""

from __future__ import annotations

import io
import json
import multiprocessing
import time
import wave

import numpy as np

from .. import check, common, host, trace as tracing
from ..common import Ctx, Outcome


def wav_bytes(clip: np.ndarray, fs: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes(np.asarray(clip, "<i2").tobytes())
    return buf.getvalue()


def _clients(port: int, wavs, order, n_clients: int, warm_s: float,
             seconds: float, out) -> None:
    """The client process: ``n_clients`` threads, each posting its next
    clip as soon as its last answer came. Sends ("window", t0, t1) first
    and ("records", [...]) last; a record is (clip, sent, done, status,
    body), the body kept for requests sent inside the window."""
    import http.client
    import threading

    t0 = time.perf_counter() + warm_s
    t1 = t0 + seconds
    out.put(("window", t0, t1))
    records = []
    lock = threading.Lock()

    def worker(c: int) -> None:
        j = c
        while True:
            sent = time.perf_counter()
            if sent >= t1:
                return
            k = int(order[j % len(order)])
            j += n_clients
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=120)
                conn.request("POST", "/recognize", body=wavs[k],
                             headers={"Content-Type": "audio/wav"})
                resp = conn.getresponse()
                body, status = resp.read(), resp.status
                conn.close()
            except (OSError, http.client.HTTPException) as e:
                body, status = repr(e).encode(), -1
            done = time.perf_counter()
            with lock:
                records.append((k, sent, done, status,
                                body if sent >= t0 else None))

    threads = [threading.Thread(target=worker, args=(c,))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out.put(("records", records))


def _stats(batcher) -> dict:
    while True:
        try:
            return dict(batcher.stats)
        except RuntimeError:      # resized while copied: read again
            continue


def run(ctx: Ctx) -> Outcome:
    from shazam_tpu_torch.serve import RecognitionServer, warmup

    mix = ctx.mix
    sia, pool, plan = common.listener_setup(ctx)
    wavs = [wav_bytes(c, ctx.fs) for c in pool]
    order = np.random.default_rng([ctx.seed, 5]).permutation(len(pool))
    warmup(sia, seconds=mix["clip_s"], max_batch=int(mix["max_batch"]))
    server = RecognitionServer(sia, port=0, max_batch=int(mix["max_batch"]),
                               max_wait_ms=float(mix["max_wait_ms"]))
    server.start_background()
    common.quiet_gc()
    mp = multiprocessing.get_context("spawn")
    out = mp.Queue()
    proc = mp.Process(target=_clients, args=(
        server.port, wavs, order, int(mix["clients"]), float(mix["warm_s"]),
        ctx.seconds, out))
    proc.start()
    try:
        _, t0, t1 = out.get(timeout=120)
        time.sleep(max(t0 - time.perf_counter(), 0))
        common.sync(ctx.device)
        common.reset_peak(ctx.device)
        setup_s = time.perf_counter() - ctx.t_start
        s0 = _stats(server.batcher)
        h0 = host.snapshot()
        tr = None
        if ctx.trace:
            # the counters the per-layer readers take stop where the
            # trace starts: the profiler and the reading of its trace
            # slow the daemon down for the rest of the window
            time.sleep(ctx.seconds / 3)
            s_mid, t_mid = _stats(server.batcher), time.perf_counter()
            tr = tracing.trace(lambda: time.sleep(float(mix["trace_s"])),
                               units=0)
            tr.units = _stats(server.batcher)["requests"] - s_mid["requests"]
        time.sleep(max(t1 - time.perf_counter(), 0))
        s1 = _stats(server.batcher)
        h1 = host.snapshot()
        if not ctx.trace:
            s_mid, t_mid = s1, h1["t"]
        common.sync(ctx.device)
        peak = common.memory_peak(ctx.device)
        _, records = out.get(timeout=300)
        proc.join(timeout=60)
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join()
        server.close()

    window = [r for r in records if r[1] >= t0]
    served = sum(1 for r in records if t0 <= r[2] <= t1 and r[3] == 200)
    failed = sum(1 for r in window if r[3] != 200)
    answers = {}
    for k, _, _, status, body in window:
        if status == 200:
            answers.setdefault(k, []).append(json.loads(body))
        elif status != 200:
            common.log(f"clip {k}: status {status} {body[:200]!r}")
    lat = sorted(1e3 * (r[2] - r[1]) for r in window if r[3] == 200)
    common.log(f"window: {len(window)} requests sent, {served} answered "
               f"inside it, {failed} failed; latency p50 "
               f"{np.percentile(lat, 50) if lat else None} ms")
    common.accuracy(ctx, plan, answers)
    def delta(a, b):
        return {k: b.get(k, 0) - a.get(k, 0) for k in (
            "requests", "batches", "batched_requests", "match_s",
            "prepare_s", "errors")}

    common.log(f"batcher over the window: {delta(s0, s1)}")
    untraced = delta(s0, s_mid)
    if ctx.trace:
        common.log(f"batcher over the {t_mid - h0['t']:.3f} s before the "
                   f"trace: {untraced}")
    common.log(host.report(h0, h1))
    if ctx.device.type == "cuda":
        common.log(f"card after the window: {host.gpu_state()}")
    obs = {"trace": tr, "stats_delta": untraced, "window_s": t_mid - h0["t"]}
    prog = common.program_outputs(
        ctx, sia, answers, lambda ks: check.prepared_batch_pairs(
            sia, {k: pool[k] for k in ks}, int(mix["max_batch"]), pool))
    del sia, server
    common.free(ctx.device)
    readings = common.reference_readings(ctx, prog, pool, plan)
    return Outcome(setup_s=setup_s, attempted=len(window), failed=failed,
                   end_to_end={"served_clips_per_s": served / ctx.seconds},
                   obs=obs, readings=readings, memory_peak=peak, trace=tr)
