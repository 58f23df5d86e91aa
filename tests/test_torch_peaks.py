"""Port parity, K2 and K3's contracts: the plain peak mask and compaction.

``peak_mask`` and ``compact`` on CPU tensors run the plain twins of K2 and
K3; their (times, freqs, n_peaks) must equal the interpret-mode Pallas
``peak_candidates_fused(power_domain=True)`` + ``compact_candidates`` on
the same power spectrum, including silence edges (zero frames inside and
after the signal, power-1 background cells) and a capacity overflow.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shazam_tpu_torch.ops.cuda.compact import compact
from shazam_tpu_torch.ops.cuda.peaks import peak_mask
from shazam_tpu_torch.ops.cuda.spectrogram import spectrogram_power
from shazam_tpu_torch.ops.peaks import (pack_mask_bits, peak_mask_db,
                                        unpack_mask_bits)
from shazam_tpu_torch.ops.spectrogram import db_spectrogram


def _power(kind: str) -> np.ndarray:
    """(1, T, 2049) f32 power of a seeded clip with silence edges."""
    from shazam_tpu.audio.synth import synth_song

    clip = synth_song(2, duration_s=5.0, seed=8).astype(np.float32)
    n = 1 << 18
    mat = np.zeros((1, n), np.float32)
    if kind == "silence":
        clip[60000:110000] = 0          # digital silence mid-clip
        nvf = (len(clip) - 4096) // 2048 + 1 - 10   # zeroed pad frames
    else:
        nvf = (len(clip) - 4096) // 2048 + 1
    mat[0, : len(clip)] = clip
    power = spectrogram_power(torch.from_numpy(mat),
                              torch.tensor([nvf], dtype=torch.int32)).numpy()
    if kind == "silence":
        power[0, 40:44, 300:340] = 1.0  # dB-zero background cells
    return power


def _pallas_peaks(power: np.ndarray, capacity: int):
    from jax.experimental.pallas import tpu as pltpu
    from shazam_tpu.ops.pallas.compact import compact_candidates
    from shazam_tpu.ops.pallas.peaks import peak_candidates_fused

    bsz, t, _ = power.shape
    t_pad = -(-t // 128) * 128
    spec = np.zeros((bsz, t_pad, 2432), np.float32)
    spec[:, :t, 128:128 + 2049] = power
    with pltpu.force_tpu_interpret_mode():
        table = peak_candidates_fused(jnp.asarray(spec), power_domain=True)
        times, freqs, n_peaks = compact_candidates(table, capacity)
    return np.asarray(times), np.asarray(freqs), np.asarray(n_peaks)


@pytest.mark.parametrize("kind,capacity", [
    ("clip", 1024),
    ("silence", 1024),
    ("clip", 64),       # capacity overflow: first 64 peaks, exact count
])
def test_peaks_and_compact_match_pallas(kind, capacity):
    power = _power(kind)
    bits = peak_mask(torch.from_numpy(power), 10.0)
    times, freqs, n_peaks = compact(bits, capacity)
    jt, jf, jn = _pallas_peaks(power, capacity)
    n = int(n_peaks[0])
    assert n == int(jn[0]) and n > 50
    k = min(n, capacity)
    assert np.array_equal(times[0, :k].numpy(), jt[0, :k])
    assert np.array_equal(freqs[0, :k].numpy(), jf[0, :k])
    assert not times[0, k:].any() and not freqs[0, k:].any()
    if kind == "silence":  # no peak inside the silent span or pad frames
        t = times[0, :k].numpy()
        assert not ((t >= 33) & (t <= 50)).any()


def test_power_domain_mask_equals_db_domain_mask():
    power = torch.from_numpy(_power("silence"))
    db_mask = peak_mask_db(db_spectrogram(power), 10.0)
    assert torch.equal(unpack_mask_bits(peak_mask(power, 10.0)), db_mask)


def test_mask_bits_roundtrip_and_layout():
    rng = np.random.default_rng(4)
    mask = torch.from_numpy(rng.random((2, 3, 2049)) < 0.3)
    bits = pack_mask_bits(mask)
    assert bits.shape == (2, 3, 65) and bits.dtype == torch.int32
    assert torch.equal(unpack_mask_bits(bits), mask)
    # bit j of word w is bin 32 w + j
    one = torch.zeros(1, 1, 2049, dtype=torch.bool)
    one[0, 0, 32 * 5 + 31] = True
    assert pack_mask_bits(one)[0, 0, 5].item() == -(1 << 31)


def test_wrappers_reject_unsupported_devices():
    meta = torch.empty((1, 8, 2049), device="meta")
    with pytest.raises(ValueError):
        peak_mask(meta, 10.0)
    with pytest.raises(ValueError):
        compact(torch.empty((1, 8, 65), dtype=torch.int32, device="meta"), 16)
    with pytest.raises(ValueError):
        spectrogram_power(torch.empty((1, 8192), device="meta"),
                          torch.empty((1,), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        peak_mask(torch.zeros((1, 8, 2049)), 0.0)  # amp_min must be > 0
