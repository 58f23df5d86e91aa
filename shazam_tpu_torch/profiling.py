"""The port's tracing: spans at its layer boundaries, a Chrome trace of a
block, and the launch counts and device events of a profiled call.

Spans
-----
``span(name, **attrs)`` marks the work of one layer; ``annotate(name,
**attrs)`` adds attributes known only inside it, such as counts read
back. It records only while a ``torch.profiler`` session is running
(``device_trace`` below, or any ``torch.profiler.profile``); otherwise it
reads one flag and returns one shared no-op context. While a session
runs, a span

- is a host op named ``name`` in the profiler's trace, on the profiler's
  clock, so a ``device_trace`` timeline shows each span above the kernels
  it launched. torch records host ops of the thread that started the
  profiler only: the daemon's spans (its batcher and match threads) are
  in the records below, not in the timeline;
- appends one ``SpanRecord`` to an in-memory ring of the process's last
  ``MAX_RECORDS`` records, from any thread (``span_records()``), when it
  ends while the session still runs. Nothing is written to disk.

A span launches nothing, copies nothing and synchronizes nothing.

The spans of the port, from a request down:

- ``sia.recognize_clip``: ``SIA.recognize_clip``, the root of a listener's
  clip; ``channels`` its rows (1 mono, 2 stereo) and, once its pass has
  read back, ``lanes`` the valid fingerprint lanes of every row and
  ``pairs`` the unique (hash, offset) pairs left after the dedup.
- ``fp.peaks``: K1-K3, or their plain twins, from samples to peak lists.
- ``fp.hash``: SHA-1 pairing (``ops/hashes``: ``csrc/sha1.cu`` on the card,
  the plain twin on the CPU); ``impl`` is ``cuda`` or ``torch``, ``lanes``
  the lanes hashed.
- ``match.dedup``: the on-device query dedup; ``rows`` the channel rows it
  takes the union of, ``query_capacity`` the lanes it keeps (in
  ``recognize_clip``'s pass every lane of the clip's fingerprint, rows x
  (fan_value - 1) x peak_capacity).
- ``match.rank``: one match dispatch: search, expansion and vote rank.
- ``sia.readback``: the host blocked on the device while it copies back.
- ``sia.align``: the reference-shaped result records, on the host.
- ``sia.rematch``: a clip whose single pass on the flat store did not
  answer it, going on from the query the pass left on the device;
  ``reason`` is ``undecided`` (a clamped match not provably decided), and
  once it has matched ``query_capacity`` the query's lanes and ``cap``
  the capacity it reports (its last tier, or the exact total of a
  decided clamp).
- ``sia.handoff``: a clip sent on to ``recognize_samples``; ``reason`` is
  ``peaks``, ``undecided`` or ``long`` (``undecided`` from the spanned
  pass only).
- ``query.prepare``: host query dedup and padding, and a batch's stacking.
- ``sia.prepare_batch`` and ``sia.match_prepared_batch``: a batch's two
  stages, ``clips`` its real clips; ``match.solo_retry``: one clip of the
  batch matched again alone.
- ``serve.queue_wait``: a daemon request from its submit until its batch
  is collected (``record``).
- ``serve.pipe_put``: a prepared batch waiting for the match thread.

Launches and device events
--------------------------
``torch.profiler`` records every CUDA runtime call the host makes, but its
device records are not always whole: on an H100 (torch 2.11, CUDA 12.8)
traces of one batched match dispatch lacked the records of from one to
over a hundred of its kernels, some traces in a row lacked the same
number, and a one-kernel trace could hold no device event at all, while
the host's launch calls were there every time. So launches are counted
from the host's launch calls (``HOST_LAUNCHES``), and device time is read
from a complete trace, one in which every kernel launch call has the
device record of its correlation id, or else from the trace that lost the
fewest, with that number beside it. ``device_events`` and
``host_launches`` need a card.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from collections import deque
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

KERNEL_LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                             "cuLaunchKernel", "cuLaunchKernelEx"})
HOST_LAUNCHES = KERNEL_LAUNCHES | {"cudaMemcpyAsync", "cudaMemsetAsync"}
MAX_RECORDS = 1 << 16


class SpanRecord(NamedTuple):
    index: int              # serial number of the record in the process
    name: str
    thread: int             # threading.get_ident() of the recording thread
    start_ns: int           # time.perf_counter_ns()
    end_ns: int
    parent: int             # index of the span open around it, or -1
    attrs: dict


_NOOP = contextlib.nullcontext()
# the process's last MAX_RECORDS records, written from any thread; each
# thread nests its own spans (its open spans, innermost last)
_records: deque = deque(maxlen=MAX_RECORDS)
_lock = threading.Lock()
_serial = itertools.count()
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _add(rec: SpanRecord) -> None:
    with _lock:
        _records.append(rec)


class _Span:
    """One recording span: a host op in the profiler's trace and, on
    exit, a ``SpanRecord``."""

    __slots__ = ("_name", "_attrs", "_op", "_index", "_parent", "_start")

    def __init__(self, name: str, attrs: dict):
        self._name, self._attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        self._parent = stack[-1]._index if stack else -1
        self._index = next(_serial)
        stack.append(self)
        # a FUNCTION-scope host op, not record_function: on an H100 (torch
        # 2.11) the profiler gives a user annotation a twin on the device
        # timeline, which a trace's device intervals would count as busy
        self._op = torch._C._profiler._RecordFunctionFast(self._name)
        self._op.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._op.__exit__(*exc)
        _stack().pop()
        # a span that outlived the session is dropped: the profiler's stop
        # holds the interpreter lock while it collects the trace, and such
        # a span would carry that stall
        if _autograd_profiler._is_profiler_enabled:
            _add(SpanRecord(self._index, self._name, threading.get_ident(),
                            self._start, end, self._parent, self._attrs))
        return False


def span(name: str, **attrs):
    """A context that records ``name`` while a profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name, attrs)


def record(name: str, start_ns: int, end_ns: int) -> None:
    """Record a span whose start was stamped elsewhere
    (``time.perf_counter_ns()``), while a profiler runs; its parent is the
    span open on this thread."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = _stack()
    _add(SpanRecord(next(_serial), name, threading.get_ident(), start_ns,
                    end_ns, stack[-1]._index if stack else -1, {}))


def annotate(name: str, **attrs) -> None:
    """Add ``attrs`` to the innermost span ``name`` open on this thread
    (none open, or no profiler: nothing)."""
    for sp in reversed(_stack()):
        if sp._name == name:
            sp._attrs.update(attrs)
            return


def span_records() -> list:
    """The records kept, oldest first (a copy)."""
    with _lock:
        return list(_records)


def spanned(name: str):
    """Make every call of the decorated function a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace around a block and write it to
    ``log_dir`` as ``trace_<pid>_<ns>.json`` (Chrome trace format, which
    Perfetto opens). The port's spans show in it by name, as host ops
    above the kernels they launched, and are kept in ``span_records()``.

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


def _trace(fn):
    """The events of one profiled call of ``fn``, begun after a
    synchronize and ended by one."""
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
