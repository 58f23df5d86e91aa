"""Share in % of the window the daemon's batcher thread spent in its first
stage (``SIA.prepare_batch``: fingerprinting a batch and building its host
queries): the delta of ``MicroBatcher.stats["prepare_s"]`` over the
window's seconds. Near 100 while that thread is the daemon's bottleneck."""


def read(obs):
    d = obs.get("stats_delta")
    if not d or not obs.get("window_s"):
        return None
    return 100.0 * d["prepare_s"] / obs["window_s"]
