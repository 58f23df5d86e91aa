"""Mean wait of a daemon request in ``MicroBatcher``'s queue, in ms: the
``serve.queue_wait`` records of the traced stretch, each from the
request's submit until its batch was collected."""

from benchmark_torch.lib import spans


def read(obs):
    waits = spans.named(spans.records(), "serve.queue_wait")
    if not waits:
        return None
    return sum(map(spans.duration_ns, waits)) / 1e6 / len(waits)
