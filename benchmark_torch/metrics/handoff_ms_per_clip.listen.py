"""Time of the escalation per clip of the traced stretch, in ms: the
summed ``sia.handoff`` spans (a clip sent on to ``recognize_samples``,
everything inside included) under the ``sia.recognize_clip`` roots, over
the count of every root, handed off or not."""

from benchmark_torch.lib import spans


def read(obs):
    return spans.ms_per_root(spans.records(), "sia.handoff",
                             "sia.recognize_clip")
