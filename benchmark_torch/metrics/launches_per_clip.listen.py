"""Host launch calls (kernels, copies, memsets) per clip of the traced
stretch: the dispatch cost of ``SIA.recognize_clip``."""


def read(obs):
    tr = obs.get("trace")
    if tr is None or not tr.units:
        return None
    return tr.launches / tr.units
