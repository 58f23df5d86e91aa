"""Device intervals and host launches of a ``torch.profiler`` trace.

The launch and lost-record arithmetic is copied from the program's
``shazam_tpu_torch/profiling.py`` (``device_events``, ``host_launches``):
``torch.profiler`` can lose device records of a trace while every host
runtime launch call is there, so launches are counted from the host's
calls, and the kernel launch calls without a device record are counted
and reported beside the device time. Card-only.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

KERNEL_LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                             "cuLaunchKernel", "cuLaunchKernelEx"})
HOST_LAUNCHES = KERNEL_LAUNCHES | {"cudaMemcpyAsync", "cudaMemsetAsync"}


@dataclass
class Trace:
    """One traced stretch: wall seconds, the union of device intervals,
    launches, kernel records by name and the longest idle gaps."""

    window_s: float
    busy_s: float
    units: int                       # clips, batches or requests traced
    launches: int
    lost: int                        # kernel launch calls without a record
    kernels: dict = field(default_factory=dict)   # name -> [count, seconds]
    idle_gaps: list = field(default_factory=list)  # [[host op, seconds]]

    def device_ops(self, top: int = 10):
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:top]
        return [[name, secs] for name, (_, secs) in ops]


def union_seconds(intervals) -> tuple:
    """(busy seconds, merged intervals) of (start, end) pairs, in the
    pairs' unit divided by 1e6 (the profiler's microseconds)."""
    if not len(intervals):
        return 0.0, []
    iv = sorted(intervals)
    merged = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged) / 1e6, merged


def _gap_labels(merged, cpu, top: int):
    """The ``top`` longest gaps between merged device intervals, each
    labelled by the innermost host op in flight at its midpoint, or, when
    none is (the host in plain Python), by the last op that ended before
    the gap: "after <op>"."""
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
            for i in range(len(merged) - 1)]
    gaps.sort(reverse=True)
    if cpu:
        starts = np.array([c[0] for c in cpu], np.float64)
        ends = np.array([c[1] for c in cpu], np.float64)
    out = []
    for length, s, e in gaps[:top]:
        label = "none"
        if cpu:
            mid = (s + e) / 2
            hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
            before = np.nonzero(ends <= s)[0]
            if len(hit):
                label = cpu[hit[np.argmin(ends[hit] - starts[hit])]][2]
            elif len(before):
                label = "after " + cpu[before[np.argmax(ends[before])]][2]
        out.append([label, length / 1e6])
    return out


def trace(fn, units: int, top: int = 10) -> Trace:
    """Profile one call of ``fn`` (begun after a synchronize, ended by
    one) and reduce it to a ``Trace``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    device, cpu, launches, kernel_calls = [], [], 0, []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            device.append(e)
        elif e.device_type == DeviceType.CPU:
            if e.name in HOST_LAUNCHES:
                launches += 1
                if e.name in KERNEL_LAUNCHES:
                    kernel_calls.append(e.id)
            cpu.append((e.time_range.start, e.time_range.end, e.name))
    recorded = {e.id for e in device}
    lost = sum(1 for i in kernel_calls if i not in recorded)
    busy, merged = union_seconds(
        [(e.time_range.start, e.time_range.end) for e in device])
    kernels = {}
    for e in device:
        k = kernels.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) / 1e6
    return Trace(window_s=wall, busy_s=busy, units=units, launches=launches,
                 lost=lost, kernels=kernels,
                 idle_gaps=_gap_labels(merged, cpu, top))
