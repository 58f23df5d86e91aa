"""dB/power spectrogram with mlab.specgram semantics, in plain PyTorch.

Matches reference ``fingerprint()`` (``__init__.py:232-241``):
``mlab.specgram(x, NFFT=4096, Fs, window=hanning, noverlap=2048)`` PSD
(one-sided, scale_by_freq) followed by ``10*log10`` with exact zeros kept
at zero. Samples come in as f32 and spectra leave as f32.

``spectrogram_power_plain`` is the plain twin of the K1 kernel
(``ops/cuda/spectrogram.py``): the same (B, T, 2049) contract, computed
with ``torch.fft.rfft``. Like the kernel it windows, transforms and
scales in float64 (the reference's mlab precision) and rounds to f32 once
(see ``csrc/spectrogram.cu`` for why). The kernel wrapper calls it for
CPU tensors and ``chip_smoke.py`` holds the kernel against it on the card;
``compute_dtype=torch.float32`` gives the f32 FFT that ``chip_smoke.py``
reads beside it, to show how far f32 rounding alone moves the dB.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hann_window(wsize: int, device=None) -> torch.Tensor:
    """np.hanning(wsize) in float64: symmetric Hann incl. zero endpoints."""
    return torch.from_numpy(np.hanning(wsize)).to(device)


@functools.lru_cache(maxsize=8)
def psd_scales(wsize: int, fs: int):
    """mlab one-sided PSD scale: (DC/Nyquist bins, other bins), float64.

    1 / (fs * sum(win^2)), doubled for every bin but DC and Nyquist.
    """
    win = np.hanning(wsize)
    base = 1.0 / (fs * float(np.sum(win * win)))
    return base, 2.0 * base


def num_frames(n_samples: int, wsize: int, hop: int) -> int:
    return max((n_samples - wsize) // hop + 1, 0)


def valid_frames(n_valid_samples: torch.Tensor, wsize: int,
                 hop: int) -> torch.Tensor:
    """Frames fully inside each row's valid prefix, (B,) int32."""
    n = n_valid_samples.to(torch.int64)
    return torch.clamp((n - wsize) // hop + 1, min=0).to(torch.int32)


def spectrogram_power_plain(samples: torch.Tensor,
                            n_valid_frames: torch.Tensor, *,
                            fs: int = 44100, wsize: int = 4096,
                            hop: int = 2048,
                            compute_dtype: torch.dtype = torch.float64
                            ) -> torch.Tensor:
    """(B, N) f32 samples -> (B, T, wsize//2 + 1) f32 scaled PSD power.

    Frame t covers samples [t*hop, t*hop + wsize); frames >= n_valid_frames
    (pad-to-bucket tails) are exactly zero.
    """
    bsz, n = samples.shape
    t = num_frames(n, wsize, hop)
    n_bins = wsize // 2 + 1
    if t == 0:
        return samples.new_zeros((bsz, 0, n_bins))
    win = hann_window(wsize, samples.device).to(compute_dtype)
    frames = samples[:, : (t - 1) * hop + wsize].unfold(1, wsize, hop)
    spec = torch.fft.rfft(frames.to(compute_dtype) * win, dim=-1)
    power = spec.real * spec.real + spec.imag * spec.imag
    edge, mid = psd_scales(wsize, fs)
    scale = torch.full((n_bins,), mid, dtype=compute_dtype,
                       device=samples.device)
    scale[0] = edge
    scale[-1] = edge
    power = (power * scale).to(torch.float32)
    live = (torch.arange(t, device=samples.device)[None, :]
            < n_valid_frames.to(samples.device)[:, None])
    return torch.where(live[:, :, None], power, torch.zeros((), device=samples.device))


def db_spectrogram(psd: torch.Tensor) -> torch.Tensor:
    """10*log10 with exact zeros kept at 0 (reference ``__init__.py:241``)."""
    nz = psd != 0
    return torch.where(nz, 10.0 * torch.log10(torch.where(nz, psd, 1.0)),
                       torch.zeros((), dtype=psd.dtype, device=psd.device))


def spectrogram_db(samples: torch.Tensor, fs: int = 44100, wsize: int = 4096,
                   hop: int = 2048) -> torch.Tensor:
    """1-D samples -> (n_freqs, n_frames) dB spectrogram (JAX layout)."""
    x = samples.to(torch.float32)[None, :]
    nvf = torch.tensor([num_frames(x.shape[1], wsize, hop)], dtype=torch.int32,
                       device=x.device)
    power = spectrogram_power_plain(x, nvf, fs=fs, wsize=wsize, hop=hop)
    return db_spectrogram(power[0]).T
