"""Host query dedup and stacking per clip of the daemon's first stage, in
ms: the self time of the ``query.prepare`` spans under the
``sia.prepare_batch`` spans of the traced stretch, over those batches'
real clips (their ``clips`` attribute)."""

from benchmark_torch.lib import spans


def read(obs):
    recs = spans.records()
    clips = spans.clips_of(recs, "sia.prepare_batch")
    if not clips:
        return None
    return spans.self_under(recs, "query.prepare",
                            "sia.prepare_batch") / 1e6 / clips
