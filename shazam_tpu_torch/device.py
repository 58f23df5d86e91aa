"""Explicit device resolution.

The port never picks a device for the caller: ``"cuda"`` on a machine
without a usable card raises instead of quietly running on the CPU,
because that fallback is exactly what hides a missing device.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``"cpu"``, ``"cuda"``, ``"cuda:N"`` or a ``torch.device`` -> device.

    For CUDA it also pins full-f32 matmul/convolution numerics (TF32 keeps
    ~3 decimal digits, which reorders near-tied constellation peaks).
    """
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("could not disable TF32")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
