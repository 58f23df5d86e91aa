"""Port parity, K1's contract: the plain spectrogram against the JAX package.

``spectrogram_power`` on CPU tensors runs K1's plain twin; it is held
against the JAX XLA ``spectrogram_db`` and the interpret-mode Pallas
``spectrogram_power_fused`` with the tolerance of tests/test_pallas.py:
max |dB diff| < 0.3, < 0.02 where dB > -20 (f32 FFTs differ most on the
weakest bins), and exact zeros on pad-to-bucket frames.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shazam_tpu_torch.ops.cuda.spectrogram import spectrogram_power
from shazam_tpu_torch.ops.spectrogram import db_spectrogram, spectrogram_db


@pytest.fixture(scope="module")
def clip():
    from shazam_tpu.audio.synth import synth_song

    return synth_song(0, duration_s=4.0, seed=3).astype(np.float32)


def _close_in_db(got_db, ref_db):
    diff = np.abs(got_db - ref_db)
    assert diff.max() < 0.3, diff.max()
    strong = ref_db > -20
    assert strong.sum() > 1000
    assert diff[strong].max() < 0.02, diff[strong].max()


def test_spectrogram_db_matches_jax(clip):
    from shazam_tpu.ops.spectrogram import spectrogram_db as jax_db

    got = spectrogram_db(torch.from_numpy(clip)).numpy()
    ref = np.asarray(jax_db(jnp.asarray(clip)))
    assert got.shape == ref.shape == (2049, (len(clip) - 4096) // 2048 + 1)
    _close_in_db(got, ref)


def test_spectrogram_power_matches_fused_pallas(clip):
    from jax.experimental.pallas import tpu as pltpu
    from shazam_tpu.ops.pallas.spectrogram import spectrogram_power_fused

    n = 1 << 18
    mat = np.zeros((2, n), np.float32)
    mat[0, : len(clip)] = clip
    mat[1, : len(clip) // 2] = clip[: len(clip) // 2]
    nvf = np.array([(len(clip) - 4096) // 2048 + 1,
                    (len(clip) // 2 - 4096) // 2048 + 1], np.int32)
    got = spectrogram_power(torch.from_numpy(mat), torch.from_numpy(nvf)).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(spectrogram_power_fused(jnp.asarray(mat),
                                                 jnp.asarray(nvf)))
    t = (n - 4096) // 2048 + 1
    assert got.shape == (2, t, 2049) and got.dtype == np.float32
    # the Pallas layout: (B, T_pad, 2432), data bins at [128, 128 + 2049)
    ref = ref[:, :t, 128:128 + 2049]
    for b in range(2):
        live = slice(0, nvf[b])
        _close_in_db(db_spectrogram(torch.from_numpy(got[b, live])).numpy(),
                     db_spectrogram(torch.tensor(ref[b, live])).numpy())
        assert not got[b, nvf[b]:].any() and not ref[b, nvf[b]:].any()
    assert np.array_equal(got == 0, ref == 0)


def test_k1_twiddle_table_layout():
    """The packed float64 table the CUDA K1 reads: W_4096^k for k <= 2048,
    then pass 2's W_256^(k r) and pass 3's W_2048^(k r), rows [r - 1][k]."""
    from shazam_tpu_torch.ops.cuda.spectrogram import twiddle_table

    tab = twiddle_table()
    assert tab.shape == (4081, 2) and tab.dtype == np.float64

    def root(m, e):
        return np.exp(-2j * np.pi * e / m)

    want = ([root(4096, k) for k in range(2049)]
            + [root(256, k * r) for r in range(1, 16) for k in range(16)]
            + [root(2048, k * r) for r in range(1, 8) for k in range(256)])
    np.testing.assert_allclose(tab[:, 0] + 1j * tab[:, 1], want, rtol=0,
                               atol=1e-15)
