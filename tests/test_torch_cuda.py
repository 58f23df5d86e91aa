"""K1-K3 on the card against their plain twins, and the port on CUDA.

Marked ``cuda``: each test asks the ``cuda`` fixture for the device, which
skips when no CUDA card is visible (a CUDA kernel has no CPU or interpret
mode). On a machine with a card and nvcc run them with (the ini file and
tests/conftest.py are skipped because they need pytest-xdist and JAX,
which the port does not)

    python -m pytest -c /dev/null --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from shazam_tpu_torch.audio import synth_song

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1-K3 run only on the card")
    from shazam_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _batch(device, secs=(5.0, 3.0), n=1 << 18):
    x = np.zeros((len(secs), n), np.float32)
    nv = np.zeros(len(secs), np.int32)
    for i, s in enumerate(secs):
        song = synth_song(i, s, seed=17).astype(np.float32)
        x[i, : len(song)] = song
        nv[i] = len(song)
    return torch.from_numpy(x).to(device), torch.from_numpy(nv).to(device)


def test_kernels_match_plain_twins(cuda):
    from shazam_tpu_torch.ops.cuda import compact, peaks, spectrogram
    from shazam_tpu_torch.ops.peaks import compact_plain, peak_mask_plain
    from shazam_tpu_torch.ops.spectrogram import (db_spectrogram,
                                                  spectrogram_power_plain,
                                                  valid_frames)

    x, nv = _batch(cuda)
    nvf = valid_frames(nv, 4096, 2048)
    before = [k.KERNEL.launches for k in (spectrogram, peaks, compact)]
    power = spectrogram.spectrogram_power(x, nvf)
    ref = spectrogram_power_plain(x, nvf)
    # both float64 inside, rounded to f32 once: only that rounding may differ
    diff = (db_spectrogram(power) - db_spectrogram(ref)).abs()
    assert diff.max() < 1e-3
    assert torch.equal(power == 0, ref == 0)
    bits = peaks.peak_mask(power, 10.0)
    assert torch.equal(bits, peak_mask_plain(power, 10.0))
    for cap in (4096, 32):  # fits; overflows (first 32 peaks, exact count)
        got = compact.compact(bits, cap)
        for a, b in zip(got, compact_plain(bits, cap)):
            assert torch.equal(a, b)
    torch.cuda.synchronize()
    after = [k.KERNEL.launches for k in (spectrogram, peaks, compact)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 2]


def test_fused_fingerprint_on_cuda_equals_cpu(cuda):
    from shazam_tpu_torch.ops.fingerprint import fingerprint_batch_fused

    x, nv = _batch(cuda)
    gpu = fingerprint_batch_fused(x, nv, peak_capacity=2048)
    cpu = fingerprint_batch_fused(x.cpu(), nv.cpu(), peak_capacity=2048)
    for a, b in zip(gpu, cpu):
        assert torch.equal(a.cpu(), b)


def test_sia_on_cuda_matches_cpu(cuda):
    from shazam_tpu_torch.api import SIA
    from shazam_tpu_torch.ops.cuda import compact

    songs = [(f"s{i}", synth_song(i, 10.0, seed=5)) for i in range(4)]
    gpu, cpu = SIA(device="cuda"), SIA(device="cpu")
    gpu.ingest_arrays(songs)
    cpu.ingest_arrays(songs)
    assert np.array_equal(gpu.index.key_hi, cpu.index.key_hi)
    clip = songs[2][1][20 * 2048: 20 * 2048 + 4 * 44100]
    n = compact.KERNEL.launches
    got = gpu.recognize_clip(clip)
    assert compact.KERNEL.launches == n + 1
    assert got["results"] == cpu.recognize_clip(clip)["results"]
    assert got["results"][0]["song_name"] == "s2"
