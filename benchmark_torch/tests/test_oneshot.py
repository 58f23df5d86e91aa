"""The one-shot listener's cell end to end on the CPU at a tiny size: a
sound run is correct; the R channel dropped from the union, an answer's
offset +1 and the bfloat16 control each make it not correct; the
reference's stereo union equals the union of its channels' rows; and the
cell's readers on hand-made records and traces."""

import json
import time
from collections import namedtuple

import numpy as np
import pytest
import torch

from benchmark_torch import run
from benchmark_torch.lib import check, refrun
from benchmark_torch.lib.drivers import oneshot

from .conftest import ROOT

CELL = "ref2035-listen5"
SEED = 2**31 + 13


@pytest.fixture
def tiny_oneshot():
    cfg = json.loads((ROOT / "benchmark_torch/configs/ref2035.json")
                     .read_text())
    cfg.update(songs=4, song_s=12.0, render_batch=2)
    mix = json.loads((ROOT / "benchmark_torch/traffic/listen5.json")
                     .read_text())
    mix.update(pool=6, warm_clips=1, compare_clips=3, compare_songs=2,
               trace_clips=1)
    return cfg, mix


def _run(tiny_oneshot):
    cfg, mix = tiny_oneshot
    return run.run_cell(run.load_benchmark(), CELL, SEED, 2.0, False,
                        torch.device("cpu"), time.perf_counter(), cfg=cfg,
                        mix=mix)


def test_sound_run_is_correct(tiny_oneshot):
    res = _run(tiny_oneshot)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"clip_ms_p95", "setup_s"}


def test_the_right_channel_dropped_is_not_correct(tiny_oneshot, monkeypatch):
    from shazam_tpu_torch.match import ondevice

    inner = ondevice._fingerprint_dedup

    def left_only(fp, query_capacity):
        return inner(type(fp)(*(a[:1] for a in fp)), query_capacity)

    monkeypatch.setattr(ondevice, "_fingerprint_dedup", left_only)
    res = _run(tiny_oneshot)
    assert not res["correct"]
    assert res["checks"]["count_gap"]["value"] > check.LIMITS["count_gap"]


def test_an_offset_plus_one_is_not_correct(tiny_oneshot, monkeypatch):
    from shazam_tpu_torch.api import SIA

    clip = SIA.recognize_clip

    def shifted(self, *a, **k):
        out = clip(self, *a, **k)
        for r in out.get("results") or []:
            r["offset"] += 1
        return out

    monkeypatch.setattr(SIA, "recognize_clip", shifted)
    res = _run(tiny_oneshot)
    assert not res["correct"]
    assert res["checks"]["answers_off"]["value"] > 0


def test_the_control_fails_a_limit(tiny_oneshot):
    cfg, mix = tiny_oneshot
    from benchmark_torch.lib.common import Ctx

    ctx = Ctx(cfg, mix, SEED, 0.0, False, torch.device("cpu"),
              time.perf_counter())
    correct, checks = check.verdict(oneshot.control_readings(ctx))
    assert not correct, checks


def test_stereo_union_equals_the_channels_rows():
    from benchmark_torch.lib import music
    from benchmark_torch.reference.fingerprint import Fingerprinter
    from benchmark_torch.reference.stereo import union_rows

    gen = music.make_music_gen(6.0, seed=2**32 + 9, device="cpu")
    x = gen(range(2))
    noisy = x[1] + 300.0 * torch.from_numpy(
        np.random.default_rng(4).standard_normal(x.shape[1])).float()
    for clip in (x, torch.stack([x[0], x[0]]), torch.stack([x[0], noisy])):
        fp = Fingerprinter({}, *refrun.PRECISIONS[refrun.REFERENCE])
        want = set()
        for c in range(clip.shape[0]):
            _, key, t1 = fp.rows(clip[c: c + 1], gen.n_samp)
            want |= fp.hex_pairs(key, t1)
        key, t1 = union_rows(fp, clip, gen.n_samp)
        assert fp.hex_pairs(key, t1) == want
        assert len(key) == len(want) > 100
        assert torch.equal(torch.sort(key * (1 << 20) + t1).values,
                           key * (1 << 20) + t1)


Rec = namedtuple("Rec", "index name thread start_ns end_ns parent attrs")
MS = 1_000_000


def rec(index, name, start_ms, end_ms, parent=-1, **attrs):
    return Rec(index, name, 1, int(start_ms * MS), int(end_ms * MS), parent,
               attrs)


# two stereo clips: the second past its lanes and handed off
CLIPS = [
    rec(0, "sia.recognize_clip", 0, 10, channels=2, lanes=1000, pairs=600),
    rec(1, "match.dedup", 4, 6, 0, rows=2, query_capacity=8192),
    rec(2, "sia.readback", 7, 8, 0),
    rec(10, "sia.recognize_clip", 20, 60, channels=2, lanes=9000,
        pairs=8100),
    rec(11, "match.dedup", 24, 27, 10, rows=2, query_capacity=8192),
    rec(12, "sia.handoff", 30, 58, 10, reason="lanes"),
    rec(13, "query.prepare", 40, 50, 12),
]


def test_span_readers(monkeypatch):
    from benchmark_torch.lib import spans

    monkeypatch.setattr(spans, "records", lambda: list(CLIPS))
    assert run.read_metric("dedup_ms_per_clip.oneshot", {}) == \
        pytest.approx((2 + 3) / 2)
    # the second root's dedup took 8,192 of its 9,000 lanes
    assert oneshot.union_dup_share(CLIPS) == \
        pytest.approx(100 * (1 - (600 + 8100) / (1000 + 8192)))
    # a program whose roots carry no lane counts (the parent)
    assert oneshot.union_dup_share(
        [r._replace(attrs={}) for r in CLIPS]) is None
    assert oneshot.union_dup_share([]) is None
    monkeypatch.setattr(spans, "records", lambda: [])
    assert run.read_metric("dedup_ms_per_clip.oneshot", {}) is None


def test_roofline_counts_a_two_row_launch_as_two_rows():
    """With no handoff each kernel launches once a clip at two rows: the
    one-row bound over launches plus clips equals the two-row bound over
    launches; a handed-off clip's one-row launches count one row each."""
    from benchmark_torch.lib.roofline import share_percent
    from benchmark_torch.lib.trace import Trace

    kernels = {"spectrogram_power_kernel": [16, 2e-4],
               "peak_mask_kernel": [16, 1e-4], "compact_kernel": [16, 1e-4],
               "other": [50, 1e-3]}
    row = {"nvf": [106], "n_frames": 127, "cap": 8192}
    two = dict(row, nvf=[106, 106])
    tr = Trace(1.0, 0.1, 16, 500, 0, kernels=kernels)
    obs = {"trace": tr, "fp_row_shape": row}
    got = run.read_metric("fp_kernels_roofline.oneshot", obs)
    assert got == pytest.approx(share_percent(kernels, two))
    handed = {k: [v[0] + 8, v[1]] for k, v in kernels.items()}
    obs["trace"] = Trace(1.0, 0.1, 16, 500, 0, kernels=handed)
    assert run.read_metric("fp_kernels_roofline.oneshot", obs) == \
        pytest.approx(share_percent(
            {k: [v[0] + 16, v[1]] for k, v in handed.items()}, row))
    assert run.read_metric("fp_kernels_roofline.oneshot",
                           {"trace": None}) is None


SHARED = ("handoff_share", "launches_per_clip", "idle_share",
          "hash_ms_per_clip", "readback_ms_per_clip", "handoff_ms_per_clip")


@pytest.mark.parametrize("name", SHARED)
def test_shared_readers_read_as_the_listen_ones(name, monkeypatch):
    """The cell's share of the listen readers reads the oneshot driver's
    observations (the window's counts, the trace, the spans), and nothing
    where there is nothing to read."""
    from benchmark_torch.lib import spans
    from benchmark_torch.lib.trace import Trace

    monkeypatch.setattr(spans, "records", lambda: list(CLIPS))
    obs = {"trace": Trace(2.0, 0.5, 16, 800, 0), "clips": 40, "handoffs": 10,
           "fp_row_shape": {"nvf": [106], "n_frames": 127, "cap": 8192}}
    assert run.read_metric(f"{name}.listen", obs) is not None
    monkeypatch.setattr(spans, "records", lambda: [])
    assert run.read_metric(f"{name}.listen", {"trace": None}) is None


def test_every_oneshot_metric_is_declared_for_the_cell():
    bench = run.load_benchmark()
    mine = [m for m in bench["per_layer"] if m["name"].endswith(".oneshot")]
    assert sorted(m["name"] for m in mine) == [
        "dedup_ms_per_clip.oneshot", "fp_kernels_roofline.oneshot"]
    for m in mine:
        assert m["workloads"] == [CELL] and m["moves"] == "clip_ms_p95"
        assert (ROOT / f"benchmark_torch/metrics/{m['name']}.py").exists()
    shared = {m["name"]: m for m in bench["per_layer"]
              if CELL in m.get("workloads", [])
              and not m["name"].endswith(".oneshot")}
    assert sorted(shared) == sorted(f"{n}.listen" for n in SHARED)
    for m in shared.values():
        assert m["workloads"][-1] == CELL and m["moves"] == "clip_ms_p95"


def test_command_line_refuses_without_a_card(monkeypatch, capsys):
    """``--control`` and ``--pair`` exit 2 without a CUDA device, as
    ``run.py`` does, before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("--control", "--pair"):
        assert oneshot.main([mode, "--workload", CELL, "--seeds", "1"]) == 2
        assert "CUDA" in capsys.readouterr().err


def test_each_channel_is_degraded_on_its_own_draw(tiny_oneshot):
    """Clean clips are dual-mono, the other conditions differ between L
    and R, channel 0 is the mono listener's clip, and the pool is a
    function of the seed."""
    from benchmark_torch.lib import clips, music
    from benchmark_torch.lib.common import Ctx

    cfg, mix = tiny_oneshot
    fs, song_s = 44100, 8.0
    gen = music.make_music_gen(song_s, seed=SEED, device="cpu")
    plan = clips.plan(mix, 3, int(song_s * fs), fs, SEED)
    ctx = Ctx(cfg, mix, SEED, 0.0, False, torch.device("cpu"), 0.0)
    pools = []
    for _ in range(2):
        cutter = clips.ClipCutter(plan)
        cutter.take(0, gen(range(3)))
        pools.append(oneshot.stereo_pool(ctx, cutter))
    for k, clip in enumerate(pools[0]):
        cond = mix["conditions"][int(plan.conditions[k])]
        assert clip.shape == (2, plan.length) and clip.dtype == np.int16
        assert np.array_equal(clip[0], clips.degrade(cutter.raw[k], cond, fs,
                                                     SEED, k))
        assert np.array_equal(clip[0], clip[1]) == (cond["name"] == "clean")
        assert np.array_equal(clip, pools[1][k])
