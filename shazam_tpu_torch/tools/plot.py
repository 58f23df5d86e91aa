"""Spectrogram + constellation visualizer.

The port of ``shazam_tpu/tools/plot.py``, which reproduces the plotting
path of the reference (``get_2D_peaks(plot=True)`` at
``__init__.py:166-175`` and the full-song render of
``recognizer_plot.py:468-477``) as a headless PNG writer. The dB
spectrogram and the peak mask are computed on ``device`` with the port's
plain ``spectrogram_db`` and ``peak_mask_db`` (the JAX package's
``spectrogram_db`` and ``peak_mask``); matplotlib is imported only here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..device import resolve_device


def plot_constellation(samples, out_path: str, fs: int = 44100,
                       amp_min: float = 10.0, radius: int = 10,
                       title: Optional[str] = None, *,
                       device="cuda") -> str:
    """Render the dB spectrogram with peak scatter to a PNG; returns path."""
    import torch

    from ..ops.peaks import peak_mask_db
    from ..ops.spectrogram import spectrogram_db

    dev = resolve_device(device)
    x = torch.from_numpy(np.asarray(samples, np.float32)).to(dev)
    spec = spectrogram_db(x, fs=fs)                       # (freqs, frames)
    mask = peak_mask_db(spec.T[None], amp_min, radius=radius)[0].T
    spec, mask = spec.cpu().numpy(), mask.cpu().numpy()

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    freqs, times = np.nonzero(mask)
    fig, ax = plt.subplots(figsize=(12, 6))
    ax.imshow(spec, origin="lower", aspect="auto", cmap="magma")
    ax.scatter(times, freqs, s=4, c="cyan")
    ax.set_xlabel("Time (frames)")
    ax.set_ylabel("Frequency (bins)")
    ax.set_title(title or "Spectrogram")
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path
