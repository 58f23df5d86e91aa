"""The harness end to end on the CPU at a tiny size: no card, no result;
a sound run is correct; the timed path broken underneath makes
``correct`` false; the control fails a limit."""

import subprocess
import sys
import time

import pytest
import torch

from benchmark_torch import control, run
from benchmark_torch.lib import check

from .conftest import ROOT

CELLS = {"listen15": "ref2714-listen15", "serve32": "ref2714-serve32",
         "ingest16": "ref2714-ingest16"}


def _bench():
    """BENCHMARK.json with a cell of every mix and their metrics."""
    bench = run.load_benchmark()
    have = {w["name"] for w in bench["workloads"]}
    for traffic, name in CELLS.items():
        if name not in have:
            bench["workloads"].append({"name": name, "config": "ref2714",
                                       "traffic": traffic, "chips": 1})
    return bench


def _run(tiny, traffic, **mix):
    cfg, mixes = tiny
    return run.run_cell(_bench(), CELLS[traffic], 2**31 + 11, 2.0, False,
                        torch.device("cpu"), time.perf_counter(), cfg=cfg,
                        mix=dict(mixes[traffic], **mix))


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark_torch/run.py", "--workload",
         "ref2714-listen15", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("traffic", sorted(CELLS))
def test_sound_run_is_correct(tiny, traffic):
    res = _run(tiny, traffic)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"


def _offset_plus_one(out):
    for r in out.get("results") or []:
        r["offset"] += 1
    return out


@pytest.mark.parametrize("traffic", ["listen15", "serve32"])
def test_an_altered_answer_is_not_correct(tiny, traffic, monkeypatch):
    from shazam_tpu_torch.api import SIA

    clip, batch = SIA.recognize_clip, SIA.match_prepared_batch
    monkeypatch.setattr(SIA, "recognize_clip", lambda self, *a, **k:
                        _offset_plus_one(clip(self, *a, **k)))
    monkeypatch.setattr(SIA, "match_prepared_batch", lambda self, pb:
                        [_offset_plus_one(o) for o in batch(self, pb)])
    res = _run(tiny, traffic)
    assert not res["correct"]
    assert res["checks"]["answers_off"]["value"] > 0


def test_half_the_batch_left_out_is_not_correct(tiny, monkeypatch):
    from shazam_tpu_torch.api import SIA

    batch = SIA.match_prepared_batch

    def half(self, pb):
        out = batch(self, pb)
        return [o if i % 2 == 0 else dict(o, results=[])
                for i, o in enumerate(out)]

    monkeypatch.setattr(SIA, "match_prepared_batch", half)
    res = _run(tiny, "serve32", clients=4)    # full batches of 4
    assert not res["correct"]


@pytest.mark.parametrize("fault", ["half", "unchanged", "altered"])
def test_a_broken_ingest_is_not_correct(tiny, fault, monkeypatch):
    from shazam_tpu_torch.api import SIA

    ingest = SIA.ingest_device_batch

    def broken(self, names, samples, n_valid, *a, **k):
        if not names[0].startswith("mix"):
            return ingest(self, names, samples, n_valid, *a, **k)
        if fault == "half":          # the second half left out
            h = len(names) // 2
            return ingest(self, names[:h], samples[:h], n_valid[:h], *a, **k)
        if fault == "unchanged":     # the store returned as it was
            return {"files": len(names), "skipped": 0,
                    "ingested": len(names), "hashes": 0, "overflowed": [],
                    "merges": 1}
        return ingest(self, names, samples.roll(1, 0), n_valid, *a, **k)

    monkeypatch.setattr(SIA, "ingest_device_batch", broken)
    res = _run(tiny, "ingest16")
    assert not res["correct"]


def test_an_altered_fingerprint_is_not_correct(tiny, monkeypatch):
    from shazam_tpu_torch.match import ondevice

    inner = ondevice._fingerprint_clip

    def altered(*args, **kwargs):
        fp = inner(*args, **kwargs)
        return fp._replace(hi=fp.hi ^ 1)

    monkeypatch.setattr(ondevice, "_fingerprint_clip", altered)
    res = _run(tiny, "listen15")
    assert not res["correct"]
    assert (res["checks"]["clip_hash_gap"]["value"]
            > check.LIMITS["clip_hash_gap"])


@pytest.mark.parametrize("traffic", ["listen15", "ingest16"])
def test_the_control_fails_a_limit(tiny, traffic):
    cfg, mixes = tiny
    got = control.control(cfg, mixes[traffic], 2**31 + 11,
                          torch.device("cpu"))
    assert not got["correct"], got["checks"]
