"""Share in % of the window the daemon's match thread spent matching: the
delta of ``MicroBatcher.stats["match_s"]`` over the window's seconds."""


def read(obs):
    d = obs.get("stats_delta")
    if not d or not obs.get("window_s"):
        return None
    return 100.0 * d["match_s"] / obs["window_s"]
