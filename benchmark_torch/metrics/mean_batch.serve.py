"""Clips per batch of the daemon's micro-batcher over the window: the
deltas of ``MicroBatcher.stats`` ``batched_requests`` over ``batches``."""


def read(obs):
    d = obs.get("stats_delta")
    if not d or not d.get("batches"):
        return None
    return d["batched_requests"] / d["batches"]
