"""Tracing / profiling utilities.

The port of ``shazam_tpu/utils/profiling.py``. The reference's
observability is wall-clock stage timers persisted to the trial CSVs
(``fingerprint_time``/``query_time``/``align_time``/``total_time``,
reference ``recognizer.py:214-220,283-286,388-390``); the API keeps that
exact schema. This module adds structured stage timing as a reusable
object and device tracing with ``torch.profiler`` (a Chrome trace, which
Perfetto opens). The launch counts and device events that
``chip_smoke.py`` reads are ``shazam_tpu_torch/profiling.py``'s.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


class StageTimer:
    """Accumulating named stage timer with the reference's CSV fields."""

    def __init__(self) -> None:
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + time.time() - t0

    @property
    def total(self) -> float:
        return sum(self.stages.values())

    def as_row(self) -> Dict[str, float]:
        row = dict(self.stages)
        row["total_time"] = self.total
        return row


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace around a block and write it to
    ``log_dir`` as ``trace_<pid>_<ns>.json`` (Chrome trace format).

    Usage::

        with device_trace("/tmp/sia_trace"):
            sia.recognize_samples([clip])

    ``None`` is a no-op. The trace records host activity, and CUDA
    activity when a card is present; the block's work is synchronized
    before the trace stops. Unlike the JAX package, which swallows them,
    a failure to start, stop or write the trace raises.
    """
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
