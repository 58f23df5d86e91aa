"""The span arithmetic of ``lib/spans.py`` and the readers of the span
metrics, on hand-made records."""

from collections import namedtuple

import pytest

from benchmark_torch import run
from benchmark_torch.lib import spans

Rec = namedtuple("Rec", "index name thread start_ns end_ns parent attrs")

MS = 1_000_000


def rec(index, name, start_ms, end_ms, parent=-1, **attrs):
    return Rec(index, name, 1, int(start_ms * MS), int(end_ms * MS), parent,
               attrs)


# two listener clips: the second handed off, fingerprinted again inside
LISTEN = [
    rec(0, "sia.recognize_clip", 0, 40),
    rec(1, "fp.peaks", 1, 3, 0),
    rec(2, "fp.hash", 3, 9, 0),
    rec(3, "sia.readback", 12, 14, 0),
    rec(4, "sia.align", 14, 15, 0),
    rec(10, "sia.recognize_clip", 50, 130),
    rec(11, "fp.hash", 52, 58, 10),
    rec(12, "sia.readback", 60, 63, 10),
    rec(13, "sia.handoff", 64, 124, 10, reason="undecided"),
    rec(14, "fp.hash", 70, 80, 13),
    rec(15, "sia.readback", 85, 90, 13),
    rec(16, "sia.readback", 86, 88, 15),   # nested in its own kind
    rec(20, "fp.hash", 200, 300),          # outside any clip
]

# two daemon batches of 3 and 2 clips, and their requests' waits
SERVE = [
    rec(1, "serve.queue_wait", 2, 10),
    rec(2, "serve.queue_wait", 5, 10),
    rec(3, "serve.queue_wait", 9, 10),
    rec(4, "sia.prepare_batch", 10, 30, clips=3),
    rec(5, "sia.readback", 12, 18, 4),
    rec(6, "query.prepare", 18, 20, 4),
    rec(7, "query.prepare", 20, 22, 4),
    rec(8, "query.prepare", 22, 25, 4),
    rec(9, "query.prepare", 25, 26, 4),
    rec(10, "serve.pipe_put", 30, 36, clips=3),
    rec(11, "sia.prepare_batch", 40, 50, clips=2),
    rec(12, "sia.readback", 41, 44, 11),
    rec(13, "query.prepare", 44, 48, 11),
    rec(14, "query.prepare", 45, 46, 13),      # nested: counted once
    rec(15, "serve.pipe_put", 50, 51, clips=2),
    rec(16, "query.prepare", 60, 70),          # outside any batch
]


def test_self_time_subtracts_the_children_once_and_clipped():
    parent = rec(0, "p", 0, 100)
    kids = [rec(1, "c", 10, 30, 0), rec(2, "c", 20, 50, 0),
            rec(3, "c", 90, 120, 0)]
    assert spans.self_ns(parent, kids) == 50 * MS
    assert spans.self_ns(parent, []) == 100 * MS
    assert spans.self_ns(parent, [rec(1, "c", 0, 100, 0)]) == 0


def test_outermost_under_a_root():
    got = spans.outermost_under(LISTEN, "sia.readback", "sia.recognize_clip")
    assert [r.index for r in got] == [3, 12, 15]
    got = spans.outermost_under(LISTEN, "fp.hash", "sia.recognize_clip")
    assert [r.index for r in got] == [2, 11, 14]


def test_self_under_and_clips():
    assert spans.self_under(SERVE, "query.prepare",
                            "sia.prepare_batch") == (2 + 2 + 3 + 1 + 4) * MS
    assert spans.clips_of(SERVE, "sia.prepare_batch") == 5
    assert spans.clips_of(SERVE, "serve.pipe_put") == 5


@pytest.mark.parametrize("name,want", [
    ("hash_ms_per_clip.listen", (6 + 6 + 10) / 2),
    ("readback_ms_per_clip.listen", (2 + 3 + 5) / 2),
    ("handoff_ms_per_clip.listen", 60 / 2),
])
def test_listen_readers(monkeypatch, name, want):
    monkeypatch.setattr(spans, "records", lambda: list(LISTEN))
    assert run.read_metric(name, {}) == pytest.approx(want)
    monkeypatch.setattr(spans, "records", lambda: [])
    assert run.read_metric(name, {}) is None


@pytest.mark.parametrize("name,want", [
    ("queue_wait_ms.serve", (8 + 5 + 1) / 3),
    ("prepare_query_ms_per_clip.serve", (2 + 2 + 3 + 1 + 4) / 5),
    ("download_wait_ms_per_clip.serve", (6 + 3) / 5),
    ("pipe_wait_ms_per_clip.serve", (6 + 1) / 5),
])
def test_serve_readers(monkeypatch, name, want):
    monkeypatch.setattr(spans, "records", lambda: list(SERVE))
    assert run.read_metric(name, {}) == pytest.approx(want)
    monkeypatch.setattr(spans, "records", lambda: list(LISTEN))
    assert run.read_metric(name, {}) is None


def test_a_program_without_spans_gives_no_records(monkeypatch):
    from shazam_tpu_torch import profiling

    monkeypatch.delattr(profiling, "span_records")
    assert spans.records() == []
    assert run.read_metric("hash_ms_per_clip.listen", {}) is None


def test_every_span_metric_is_declared():
    bench = run.load_benchmark()
    names = {m["name"]: m for m in bench["per_layer"]}
    for name in ("hash_ms_per_clip.listen", "readback_ms_per_clip.listen",
                 "handoff_ms_per_clip.listen", "queue_wait_ms.serve",
                 "prepare_query_ms_per_clip.serve",
                 "download_wait_ms_per_clip.serve",
                 "pipe_wait_ms_per_clip.serve"):
        m = names[name]
        assert m["source"] == "program_counter" and m["unit"] == "ms"
        cells = {w["name"]: w for w in bench["workloads"]}
        assert all(w in cells for w in m["workloads"])
        assert all(("serve" in cells[w]["traffic"])
                   == name.endswith(".serve") for w in m["workloads"])
