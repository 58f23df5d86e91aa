"""Store merges per ingest batch in the window: the ``merges`` that
``SIA.ingest_device_batch`` returns, over the batches."""


def read(obs):
    if not obs.get("batches"):
        return None
    return obs["merges"] / obs["batches"]
