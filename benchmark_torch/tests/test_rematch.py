"""The readers of the on-device continuation (``sia.rematch``), on
hand-made span records."""

from collections import namedtuple

import pytest

from benchmark_torch import run
from benchmark_torch.lib import spans

Rec = namedtuple("Rec", "index name thread start_ns end_ns parent attrs")

MS = 1_000_000


def rec(index, name, start_ms, end_ms, parent=-1, **attrs):
    return Rec(index, name, 1, int(start_ms * MS), int(end_ms * MS), parent,
               attrs)


# four listener clips: the second and the fourth continued on the device,
# the third handed off
LISTEN = [
    rec(0, "sia.recognize_clip", 0, 10),
    rec(1, "sia.readback", 5, 6, 0),
    rec(10, "sia.recognize_clip", 20, 40),
    rec(11, "sia.readback", 25, 27, 10),
    rec(12, "sia.rematch", 27, 39, 10, reason="undecided"),
    rec(13, "sia.readback", 35, 37, 12),
    rec(20, "sia.recognize_clip", 50, 90),
    rec(21, "sia.handoff", 55, 89, 20, reason="peaks"),
    rec(30, "sia.recognize_clip", 100, 120),
    rec(31, "sia.rematch", 105, 113, 30, reason="lanes"),
    rec(40, "sia.rematch", 200, 250),      # outside any clip
]


@pytest.mark.parametrize("name,want", [
    ("rematch_share.listen", 100.0 * 2 / 4),
    ("rematch_ms_per_clip.listen", (12 + 8) / 4),
])
def test_rematch_readers(monkeypatch, name, want):
    monkeypatch.setattr(spans, "records", lambda: list(LISTEN))
    assert run.read_metric(name, {}) == pytest.approx(want)
    monkeypatch.setattr(spans, "records", lambda: [])
    assert run.read_metric(name, {}) is None


@pytest.mark.parametrize("name", ["rematch_share.listen",
                                  "rematch_ms_per_clip.listen"])
def test_a_program_without_the_span_reads_nothing(monkeypatch, name):
    """A program whose span list lacks ``sia.rematch`` (an earlier one)
    gives no reading, not a zero."""
    from shazam_tpu_torch import profiling

    monkeypatch.setattr(spans, "records", lambda: list(LISTEN[:2]))
    assert run.read_metric(name, {}) is not None
    monkeypatch.setattr(profiling, "__doc__", "Spans: sia.handoff only.")
    assert run.read_metric(name, {}) is None


def test_the_rematch_metrics_are_declared():
    bench = run.load_benchmark()
    names = {m["name"]: m for m in bench["per_layer"]}
    listen = [w["name"] for w in bench["workloads"]
              if w["traffic"].startswith("listen")]
    for name in ("rematch_share.listen", "rematch_ms_per_clip.listen"):
        m = names[name]
        assert m["source"] == "program_counter"
        assert m["layer"] == names["handoff_share.listen"]["layer"]
        assert m["moves"] == "clip_ms_p95"
        assert m["workloads"] == listen
