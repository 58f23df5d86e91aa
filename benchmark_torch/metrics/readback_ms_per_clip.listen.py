"""Time the host spent blocked on the device per clip of the traced
stretch, in ms: the summed ``sia.readback`` spans (the waits and copies
of results and fingerprints back to the host) under the
``sia.recognize_clip`` roots, over the count of roots."""

from benchmark_torch.lib import spans


def read(obs):
    return spans.ms_per_root(spans.records(), "sia.readback",
                             "sia.recognize_clip")
