"""K1-K3's share of their roofline in %, over the traced stretch of
stereo clips: the bound of every recorded launch over their summed device
time (``lib/roofline.py``). A launch's bound is its rows' bound at the
one-row shape of a channel (the bound is linear in rows): each clip's
single pass is one two-row launch of each kernel, and a handed-off clip's
``recognize_samples`` adds one-row launches, so a kernel's rows are its
launches plus one a traced clip."""

from benchmark_torch.lib.roofline import share_percent


def read(obs):
    tr = obs.get("trace")
    if tr is None:
        return None
    rows = {name: [count + min(tr.units, count), secs]
            for name, (count, secs) in tr.kernels.items()}
    return share_percent(rows, obs["fp_row_shape"])
