"""Share in % of the traced stretch's clips that ``recognize_clip``
continued on the device past its single pass: the ``sia.recognize_clip``
roots that hold a ``sia.rematch`` span (the counter of how often the
continuation engages). None without a root, or where the program's span
list (``shazam_tpu_torch.profiling``) has no ``sia.rematch``."""

from benchmark_torch.lib import spans


def read(obs):
    from shazam_tpu_torch import profiling

    recs = spans.records()
    n = len(spans.named(recs, "sia.recognize_clip"))
    if not n or "sia.rematch" not in (profiling.__doc__ or ""):
        return None
    by_index = {r.index: r for r in recs}
    held = set()
    for r in spans.named(recs, "sia.rematch"):
        while r.parent in by_index:
            r = by_index[r.parent]
            if r.name == "sia.recognize_clip":
                held.add(r.index)
                break
    return 100.0 * len(held) / n
