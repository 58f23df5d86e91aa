"""Time of the on-device continuation per clip of the traced stretch, in
ms: the summed ``sia.rematch`` spans (a clip matched again past its
single pass, everything inside included) under the ``sia.recognize_clip``
roots, over the count of every root, continued or not; comparable with
``handoff_ms_per_clip.listen``. None where the program's span list
(``shazam_tpu_torch.profiling``) has no ``sia.rematch``."""

from benchmark_torch.lib import spans


def read(obs):
    from shazam_tpu_torch import profiling

    if "sia.rematch" not in (profiling.__doc__ or ""):
        return None
    return spans.ms_per_root(spans.records(), "sia.rematch",
                             "sia.recognize_clip")
