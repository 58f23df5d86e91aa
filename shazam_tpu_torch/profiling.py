"""Launch counts and device events of a profiled call.

``torch.profiler`` records every CUDA runtime call the host makes, but its
device records are not always whole: on an H100 (torch 2.11, CUDA 12.8)
traces of one batched match dispatch lacked the records of from one to
over a hundred of its kernels, some traces in a row lacked the same
number, and a one-kernel trace could hold no device event at all, while
the host's launch calls were there every time. So launches are counted
from the host's launch calls (``HOST_LAUNCHES``), and device time is read
from a complete trace, one in which every kernel launch call has the
device record of its correlation id, or else from the trace that lost the
fewest, with that number beside it. Card-only: nothing here runs on the
CPU.
"""

from __future__ import annotations

KERNEL_LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                             "cuLaunchKernel", "cuLaunchKernelEx"})
HOST_LAUNCHES = KERNEL_LAUNCHES | {"cudaMemcpyAsync", "cudaMemsetAsync"}


def _trace(fn):
    """The events of one profiled call of ``fn``, begun after a
    synchronize and ended by one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.events()


def device_events(fn, attempts: int = 3):
    """The device events (kernels, copies, memsets) of one call of ``fn``:
    from the first complete trace of up to ``attempts``, else from the one
    that lost the fewest. Returns (events, the kernel launch calls of that
    trace without a device record: 0 for a complete trace)."""
    from torch.autograd import DeviceType

    best = None
    for _ in range(attempts):
        events = _trace(fn)
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        recorded = {e.id for e in device}
        lost = sum(e.device_type == DeviceType.CPU
                   and e.name in KERNEL_LAUNCHES and e.id not in recorded
                   for e in events)
        if best is None or lost < best[1]:
            best = (device, lost)
        if not lost:
            break
    return best


def host_launches(fn, traces: int = 3):
    """Kernels, copies and memsets the host launched in one call of
    ``fn``: its runtime launch calls, which every one of ``traces`` traces
    must count alike. Returns (the count, a Counter of the call names)."""
    import collections

    from torch.autograd import DeviceType

    counts, names = [], None
    for _ in range(traces):
        names = collections.Counter(
            e.name for e in _trace(fn)
            if e.device_type == DeviceType.CPU and e.name in HOST_LAUNCHES)
        counts.append(sum(names.values()))
    if len(set(counts)) != 1:
        raise AssertionError(f"traces disagree on the launch calls: {counts}")
    return counts[0], names
