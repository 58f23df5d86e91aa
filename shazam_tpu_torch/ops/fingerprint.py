"""The full fingerprint pipeline: samples -> 80-bit hash keys + offsets.

Replaces reference ``fingerprint()`` (``__init__.py:212-245``):
spectrogram -> constellation peaks -> fan-out pair hashing, batched over a
leading song axis with static capacities.

Two pipelines, like the JAX package's:

- ``fingerprint_batch_fused``, the hot path: power-domain spectrum (K1),
  bit-packed peak mask (K2) and ordered compaction (K3). CUDA tensors run
  the hand-written kernels, CPU tensors their plain twins; nothing else.
- ``fingerprint_batch`` / ``fingerprint_samples``: the reference's own dB
  formulation in plain PyTorch (dB spectrum, dB gate, dB-zero background).
  It agrees with the fused path except on f32 dB-collision plateaus,
  where two distinct powers round to one dB value and the dB compare marks
  both as co-maxima.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, FingerprintConfig
from .cuda.compact import compact
from .cuda.peaks import peak_mask
from .cuda.spectrogram import spectrogram_power
from .hashes import generate_hashes
from .peaks import compact_plain, pack_mask_bits, peak_mask_db
from .sha1 import keys_to_hex
from .spectrogram import db_spectrogram, spectrogram_power_plain, valid_frames


class Fingerprints(NamedTuple):
    """Fixed-capacity fingerprint set (masked lanes), on any device."""

    hi: torch.Tensor       # int64 (..., H)  sha1 bits 0..31
    lo: torch.Tensor       # int64 (..., H)  sha1 bits 32..63
    ex: torch.Tensor       # int64 (..., H)  sha1 bits 64..79
    t1: torch.Tensor       # int64 (..., H)  anchor frame offset
    valid: torch.Tensor    # bool  (..., H)
    n_peaks: torch.Tensor  # int32 (...)     exact peak count (overflow check)

    @property
    def n_hashes(self) -> torch.Tensor:
        return self.valid.sum(-1)


def _hash(times, freqs, n_peaks, fan_value, min_dt, max_dt) -> Fingerprints:
    hi, lo, ex, t1, valid = generate_hashes(
        times, freqs, n_peaks, fan_value=fan_value, min_dt=min_dt,
        max_dt=max_dt)
    return Fingerprints(hi, lo, ex, t1, valid, n_peaks)


def fingerprint_batch_fused(
    samples: torch.Tensor,
    n_valid_samples: torch.Tensor,
    *,
    fs: int = 44100,
    wsize: int = 4096,
    hop: int = 2048,
    amp_min: float = 10.0,
    radius: int = 10,
    fan_value: int = 5,
    min_dt: int = 0,
    max_dt: int = 200,
    peak_capacity: int = 8192,
) -> Fingerprints:
    """(B, N) samples, (B,) valid lengths -> Fingerprints over (B, H) lanes.

    Samples past ``n_valid_samples`` must be zeros; frames that extend past
    it are zeroed, so results equal fingerprinting the unpadded signal.
    K1 -> K2 -> K3 on CUDA tensors, their plain twins on CPU tensors.
    ``n_peaks`` is exact: > ``peak_capacity`` means the peak list was cut
    and the caller retries at a larger capacity.
    """
    x = samples.to(torch.float32).contiguous()
    nvf = valid_frames(n_valid_samples.to(x.device), wsize, hop).contiguous()
    power = spectrogram_power(x, nvf, fs=fs, wsize=wsize, hop=hop)
    bits = peak_mask(power, amp_min, radius)
    times, freqs, n_peaks = compact(bits, peak_capacity)
    return _hash(times, freqs, n_peaks, fan_value, min_dt, max_dt)


def fingerprint_batch(
    samples: torch.Tensor,
    n_valid_samples: torch.Tensor,
    *,
    fs: int = 44100,
    wsize: int = 4096,
    hop: int = 2048,
    amp_min: float = 10.0,
    radius: int = 10,
    fan_value: int = 5,
    min_dt: int = 0,
    max_dt: int = 200,
    peak_capacity: int = 8192,
) -> Fingerprints:
    """The dB-domain reference pipeline over a (B, N) song matrix."""
    if amp_min <= 0:
        raise ValueError(
            "pad-to-bucket fingerprinting requires amp_min > 0: the zeroed "
            "pad columns rely on the strict amp > amp_min gate to stay "
            "peak-free")
    x = samples.to(torch.float32)
    nvf = valid_frames(n_valid_samples.to(x.device), wsize, hop)
    db = db_spectrogram(spectrogram_power_plain(x, nvf, fs=fs, wsize=wsize,
                                                hop=hop))
    bits = pack_mask_bits(peak_mask_db(db, amp_min, radius))
    times, freqs, n_peaks = compact_plain(bits, peak_capacity)
    return _hash(times, freqs, n_peaks, fan_value, min_dt, max_dt)


def fingerprint_samples(samples: torch.Tensor, n_valid_samples=None,
                        **kwargs) -> Fingerprints:
    """One channel (1-D samples) through ``fingerprint_batch``."""
    n = samples.shape[0] if n_valid_samples is None else int(n_valid_samples)
    fp = fingerprint_batch(samples[None, :],
                           torch.tensor([n], device=samples.device), **kwargs)
    return Fingerprints(*(a[0] for a in fp))


def fingerprint(samples, config: FingerprintConfig = DEFAULT_CONFIG,
                peak_capacity: int | None = None,
                device="cpu") -> Fingerprints:
    """Config-driven ``fingerprint_samples`` of one channel."""
    x = torch.as_tensor(np.asarray(samples), device=device)
    return fingerprint_samples(
        x,
        fs=config.sample_rate, wsize=config.window_size, hop=config.hop,
        amp_min=config.amp_min, radius=config.peak_neighborhood_size,
        fan_value=config.fan_value, min_dt=config.min_hash_time_delta,
        max_dt=config.max_hash_time_delta,
        peak_capacity=peak_capacity or config.peak_capacity,
    )


def _unique_pairs(hi: np.ndarray, lo: np.ndarray, ex: np.ndarray,
                  t1: np.ndarray):
    if not hi.size:
        return hi, lo, ex, t1
    stacked = np.unique(np.stack(
        [a.astype(np.uint64) for a in (hi, lo, ex, t1)], axis=1), axis=0)
    return tuple(stacked[:, i].astype(np.uint32) for i in range(4))


def fingerprints_to_pairs(fp: Fingerprints, dedup: bool = True):
    """Host-side (hi, lo, ex, t1) uint32 numpy arrays of one channel's
    valid lanes; with dedup, the unique (hash, offset) pairs sorted by key
    then offset (reference ``recognizer.py:378-382``)."""
    valid = fp.valid.cpu().numpy()
    cols = tuple(a.cpu().numpy()[valid].astype(np.uint32)
                 for a in (fp.hi, fp.lo, fp.ex, fp.t1))
    return _unique_pairs(*cols) if dedup else cols


def union_pairs(fps):
    """The set-union of (hash, offset) pairs over channels' fingerprints,
    sorted by key then offset (reference ``get_file_fingerprints``,
    ``__init__.py:254-266``, and ``recognizer.py:378-382``)."""
    cols = [fingerprints_to_pairs(fp, dedup=False) for fp in fps]
    return _unique_pairs(*(np.concatenate([c[i] for c in cols]) if cols
                           else np.zeros(0, np.uint32) for i in range(4)))


def fingerprint_to_hex_pairs(fp: Fingerprints, dedup: bool = True):
    """[(hex20, offset)] pairs for parity tests against the oracle."""
    hi, lo, ex, t1 = fingerprints_to_pairs(fp, dedup=dedup)
    return list(zip(keys_to_hex(hi, lo, ex), t1.astype(int).tolist()))
