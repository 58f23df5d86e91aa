"""Device idle share of the traced stretch, in %: 100 * (1 - the union of
device intervals over the stretch's wall time)."""


def read(obs):
    tr = obs.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
