"""Time a prepared batch waited to be handed to the daemon's match thread,
per clip, in ms: the ``serve.pipe_put`` spans of the traced stretch over
their batches' clips (their ``clips`` attribute)."""

from benchmark_torch.lib import spans


def read(obs):
    recs = spans.records()
    clips = spans.clips_of(recs, "serve.pipe_put")
    if not clips:
        return None
    return sum(map(spans.duration_ns, spans.named(
        recs, "serve.pipe_put"))) / 1e6 / clips
