"""SHA-1 pairing time per clip of the traced stretch, in ms: the summed
``fp.hash`` spans (``ops/hashes`` + ``ops/sha1``) under the
``sia.recognize_clip`` roots, over the count of roots. A clip handed to
``recognize_samples`` is fingerprinted twice, and both count."""

from benchmark_torch.lib import spans


def read(obs):
    return spans.ms_per_root(spans.records(), "fp.hash",
                             "sia.recognize_clip")
