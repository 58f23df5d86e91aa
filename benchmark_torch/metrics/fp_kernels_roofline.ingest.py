"""K1-K3's share of their roofline in %: the byte and operation bound of
every recorded launch at the cell's launch shape (``lib/roofline.py``)
over their summed device time in the trace."""

from benchmark_torch.lib.roofline import share_percent


def read(obs):
    tr = obs.get("trace")
    if tr is None:
        return None
    return share_percent(tr.kernels, obs["fp_shape"])
