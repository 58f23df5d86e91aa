"""Time of the on-device union dedup per stereo clip of the traced
stretch, in ms: the summed self time of the ``match.dedup`` spans under
the ``sia.recognize_clip`` roots, over the count of roots."""

from benchmark_torch.lib import spans


def read(obs):
    recs = spans.records()
    n = len(spans.named(recs, "sia.recognize_clip"))
    if not n:
        return None
    return spans.self_under(recs, "match.dedup", "sia.recognize_clip") \
        / 1e6 / n
