"""Milliseconds of the batcher thread's first stage (``SIA.prepare_batch``)
per clip it batched over the window: the delta of
``MicroBatcher.stats["prepare_s"]`` over that of ``batched_requests``. While
that stage is the bottleneck, its inverse bounds ``served_clips_per_s``."""


def read(obs):
    d = obs.get("stats_delta")
    if not d or not d.get("batched_requests"):
        return None
    return 1e3 * d["prepare_s"] / d["batched_requests"]
