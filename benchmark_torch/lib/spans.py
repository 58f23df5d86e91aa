"""Arithmetic over the program's span records.

The program (``shazam_tpu_torch.profiling``) keeps a record of each span
that ran while a ``torch.profiler`` session was on: its ``index``,
``name``, ``thread``, ``start_ns`` and ``end_ns`` (``perf_counter_ns``),
the ``parent`` index of the span open around it on its thread (-1 for
none) and ``attrs``. It hands over these raw records
only: every sum, self time and figure per unit is taken here, so a change
to the program cannot move this arithmetic. A program without spans
gives no records, and every reader of them then returns None.
"""

from __future__ import annotations


def records() -> list:
    """The program's span records kept in this process; [] where the
    program keeps none."""
    from shazam_tpu_torch import profiling

    get = getattr(profiling, "span_records", None)
    return list(get()) if get is not None else []


def duration_ns(r) -> int:
    return r.end_ns - r.start_ns


def named(recs, name: str) -> list:
    return [r for r in recs if r.name == name]


def _ancestors(r, by_index: dict):
    while r.parent in by_index:
        r = by_index[r.parent]
        yield r


def outermost_under(recs, name: str, root: str) -> list:
    """The records ``name`` that have an ancestor ``root`` and no ancestor
    ``name`` (so that a span nested in its own kind counts once)."""
    by_index = {r.index: r for r in recs}
    out = []
    for r in named(recs, name):
        up = [a.name for a in _ancestors(r, by_index)]
        if root in up and name not in up:
            out.append(r)
    return out


def self_ns(r, children) -> int:
    """``r``'s duration less the part that its child spans cover (each
    clipped to ``r``; overlapping children counted once)."""
    iv = sorted((max(c.start_ns, r.start_ns), min(c.end_ns, r.end_ns))
                for c in children)
    covered, end = 0, r.start_ns
    for s, e in iv:
        s = max(s, end)
        if e > s:
            covered += e - s
            end = e
    return duration_ns(r) - covered


def self_under(recs, name: str, root: str) -> int:
    """Summed self time (ns) of every record ``name`` with an ancestor
    ``root``."""
    by_index = {r.index: r for r in recs}
    kids: dict = {}
    for r in recs:
        kids.setdefault(r.parent, []).append(r)
    return sum(self_ns(r, kids.get(r.index, ()))
               for r in named(recs, name)
               if any(a.name == root for a in _ancestors(r, by_index)))


def ms_per_root(recs, name: str, root: str):
    """Total time (ms) of the outermost ``name`` spans under the ``root``
    spans, over the count of ``root`` spans; None without a root."""
    n = len(named(recs, root))
    if not n:
        return None
    return sum(map(duration_ns, outermost_under(recs, name, root))) / 1e6 / n


def clips_of(recs, name: str) -> int:
    """The summed ``clips`` attribute of the records ``name``."""
    return sum(int(r.attrs.get("clips", 0)) for r in named(recs, name))
