"""Wait for the fingerprint download per clip of the daemon's first
stage, in ms: the ``sia.readback`` spans under the ``sia.prepare_batch``
spans of the traced stretch, over those batches' real clips."""

from benchmark_torch.lib import spans


def read(obs):
    recs = spans.records()
    clips = spans.clips_of(recs, "sia.prepare_batch")
    if not clips:
        return None
    return sum(map(spans.duration_ns, spans.outermost_under(
        recs, "sia.readback", "sia.prepare_batch"))) / 1e6 / clips
