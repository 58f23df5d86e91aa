"""Share in % of the window's clips that ``recognize_clip`` handed to
``recognize_samples`` (the escalation past its single pass), counted by a
wrapper the benchmark puts around the bound method."""


def read(obs):
    if not obs.get("clips"):
        return None
    return 100.0 * obs["handoffs"] / obs["clips"]
