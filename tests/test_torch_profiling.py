"""The port's spans (``shazam_tpu_torch/profiling.py``) on the CPU: the
no-op without a profiler, nesting and the profiler's trace,
spans from other threads, the ring's bound, and the span trees of
``recognize_clip``, its continuation and the daemon's batcher."""

import dataclasses
import sys
import threading
import time
from collections import deque

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from shazam_tpu_torch import profiling
from shazam_tpu_torch.api import SIA
from shazam_tpu_torch.audio import synth_song
from shazam_tpu_torch.config import DEFAULT_CONFIG

FS = 44100


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def songs():
    return [(f"s{i}", synth_song(i, duration_s=8.0, seed=31))
            for i in range(3)]


@pytest.fixture(scope="module")
def sia(songs):
    engine = SIA(device="cpu")
    engine.ingest_arrays(songs)
    return engine


def _clip(songs, i=1, start_s=1.0, length_s=4.0):
    x = songs[i][1]
    return x[int(start_s * FS): int((start_s + length_s) * FS)]


def _mark():
    return max((r.index for r in profiling.span_records()), default=-1)


def _since(mark):
    return [r for r in profiling.span_records() if r.index > mark]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _tree(recs, root):
    """{name: [records]} of ``root``'s descendants."""
    by_index = {r.index: r for r in recs}
    out = {}
    for r in recs:
        up = r
        while up.parent in by_index:
            up = by_index[up.parent]
            if up.index == root.index:
                out.setdefault(r.name, []).append(r)
                break
    return out


def test_span_without_a_profiler_records_nothing():
    mark = _mark()
    a = profiling.span("sia.align")
    b = profiling.span("sia.handoff", reason="peaks")
    assert a is b is profiling._NOOP
    with a:
        with b:
            profiling.record("serve.queue_wait", 0, 1)
    assert _since(mark) == []


def test_nested_spans_record_parents_and_trace_ops():
    mark = _mark()
    with _cpu_profile() as prof:
        with profiling.span("outer.a", clips=2):
            with profiling.span("inner.b"):
                torch.ones(4).sum()
            profiling.record("inner.c", 5, 9)
        with profiling.span("outer.d"):
            pass
    got = {r.name: r for r in _since(mark)}
    assert set(got) == {"outer.a", "inner.b", "inner.c", "outer.d"}
    a, b, c, d = (got[n] for n in ("outer.a", "inner.b", "inner.c",
                                   "outer.d"))
    assert a.parent == -1 and b.parent == a.index and c.parent == a.index
    assert d.parent == -1
    assert a.attrs == {"clips": 2} and (c.start_ns, c.end_ns) == (5, 9)
    assert a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns
    assert {r.thread for r in (a, b, c, d)} == {threading.get_ident()}
    names = {e.name for e in prof.events()}
    assert {"outer.a", "inner.b", "outer.d"} <= names


def test_a_span_that_outlives_the_profiler_is_dropped():
    mark = _mark()
    with _cpu_profile():
        with profiling.span("kept.inner"):
            pass
        outer = profiling.span("dropped.outer")
        outer.__enter__()
    outer.__exit__(None, None, None)
    assert [r.name for r in _since(mark)] == ["kept.inner"]


def test_spans_from_other_threads_are_all_kept():
    n_threads, n_spans = 8, 200
    mark = _mark()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for j in range(n_spans):
                with profiling.span(f"t.outer{k}"):
                    with profiling.span(f"t.inner{k}"):
                        pass

        with _cpu_profile():
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    recs = _since(mark)
    assert len(recs) == 2 * n_threads * n_spans
    assert len({r.index for r in recs}) == len(recs)
    by_index = {r.index: r for r in recs}
    for r in recs:
        k = r.name[-1]
        if "inner" in r.name:
            parent = by_index[r.parent]
            assert parent.name == f"t.outer{k}"
            assert parent.thread == r.thread
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
        else:
            assert r.parent == -1
    for k in range(n_threads):   # an ident may be reused after a thread ends
        assert len({r.thread for r in recs if r.name[-1] == str(k)}) == 1


def test_the_ring_keeps_the_newest_records(monkeypatch):
    monkeypatch.setattr(profiling, "_records", deque(maxlen=3))
    with _cpu_profile():
        for k in range(5):
            with profiling.span(f"r{k}"):
                pass
    assert [r.name for r in profiling.span_records()] == ["r2", "r3", "r4"]


def test_recognize_clip_span_tree(sia, songs):
    clip = _clip(songs)
    want = sia.recognize_clip(clip)
    mark = _mark()
    with _cpu_profile() as prof:
        got = sia.recognize_clip(clip)
    assert got["results"] == want["results"]
    recs = _since(mark)
    (root,) = [r for r in recs if r.name == "sia.recognize_clip"]
    assert root.parent == -1
    tree = _tree(recs, root)
    assert {"fp.peaks", "fp.hash", "match.dedup", "match.rank",
            "sia.readback", "sia.align"} <= set(tree)
    assert "sia.handoff" not in tree
    assert all(r.thread == root.thread for rs in tree.values() for r in rs)
    assert len(tree) and all(len(rs) == 1 for rs in tree.values())
    names = {e.name for e in prof.events()}
    assert {"sia.recognize_clip", "fp.hash", "sia.align"} <= names


def test_undecided_clip_is_handed_off_under_a_span(songs, monkeypatch):
    """A clamped match that is not provably decided is handed on to the
    continuation under ``sia.rematch``: matched again at the tier its
    total fits, from the query still on the device, with no
    ``recognize_samples`` call, host dedup or second fingerprint."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, match_capacity_fast=64,
                              decision_escalation=False)
    engine = SIA(config=cfg, device="cpu")
    engine.ingest_arrays(songs)
    clip = _clip(songs, i=2)
    want = engine.recognize_samples([clip])
    calls = []
    monkeypatch.setattr(SIA, "recognize_samples",
                        lambda self, *a, **k: calls.append(a))
    mark = _mark()
    with _cpu_profile():
        got = engine.recognize_clip(clip)
    assert calls == []
    timing = ("fingerprint_time", "query_time", "align_time", "total_time")
    assert ({k: v for k, v in got.items() if k not in timing}
            == {k: v for k, v in want.items() if k not in timing})
    recs = _since(mark)
    (root,) = [r for r in recs if r.name == "sia.recognize_clip"]
    tree = _tree(recs, root)
    (rematch,) = tree["sia.rematch"]
    assert rematch.parent == root.index
    assert rematch.attrs == {"reason": "undecided", "query_capacity":
                             (cfg.fan_value - 1) * cfg.peak_capacity,
                             "cap": cfg.match_capacity}
    assert "sia.handoff" not in tree and "query.prepare" not in tree
    assert len(tree["fp.peaks"]) == len(tree["match.dedup"]) == 1
    inside = _tree(recs, rematch)
    assert {"match.rank", "sia.readback", "sia.align"} <= set(inside)
    assert "fp.peaks" not in inside
    # one match round, at the tier the total fits: the fast tier the
    # pass ran is not run again
    assert len(inside["match.rank"]) == 1


def test_microbatcher_records_one_queue_wait_per_request(sia, songs):
    from shazam_tpu_torch.serve import MicroBatcher, _Pending

    batcher = MicroBatcher(sia, max_batch=4, max_wait_ms=500.0)
    try:
        warm = _Pending([_clip(songs)], None)    # untraced
        batcher.submit(warm)
        assert warm.event.wait(timeout=300)
        mark = _mark()
        with _cpu_profile():
            pending = [_Pending([_clip(songs, i=k % 3, start_s=1.0 + k)],
                                None) for k in range(3)]
            for p in pending:
                batcher.submit(p)
            for p in pending:
                assert p.event.wait(timeout=300)
            deadline = time.monotonic() + 30
            while (not any(r.name == "serve.pipe_put" for r in _since(mark))
                   and time.monotonic() < deadline):
                time.sleep(0.01)
    finally:
        batcher.close()
    assert all(p.error is None and p.result["results"] for p in pending)
    recs = _since(mark)
    waits = [r for r in recs if r.name == "serve.queue_wait"]
    assert sorted(r.start_ns for r in waits) == sorted(p.t0_ns
                                                      for p in pending)
    assert all(r.end_ns > r.start_ns for r in waits)
    names = [r.name for r in recs]
    for name in ("sia.prepare_batch", "serve.pipe_put",
                 "sia.match_prepared_batch", "query.prepare", "sia.align"):
        assert name in names, name
    batches = [r for r in recs if r.name == "sia.prepare_batch"]
    assert sum(r.attrs["clips"] for r in batches) == len(pending)
    (matched,) = {r.thread for r in recs
                  if r.name == "sia.match_prepared_batch"}
    assert matched != threading.get_ident()
