"""The harness's CPU tests: tiny configurations of the real files."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def tiny():
    """(cfg, {traffic: mix}) at a size the CPU runs in seconds."""
    cfg = json.loads((ROOT / "benchmark_torch/configs/ref2714.json")
                     .read_text())
    cfg.update(songs=4, song_s=12.0, render_batch=2)
    mixes = {}
    for name in ("listen15", "serve32", "ingest16"):
        mix = json.loads((ROOT / f"benchmark_torch/traffic/{name}.json")
                         .read_text())
        mix.update(clip_s=5.0, pool=6, warm_clips=1, compare_clips=3,
                   compare_songs=2, trace_clips=1, clients=3, max_batch=4,
                   warm_s=1.0, batch=2, pool_songs=3,
                   warm_batches=1, compare_new=2)
        mixes[name] = mix
    return cfg, mixes
