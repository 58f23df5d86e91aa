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


@pytest.mark.parametrize("odd", [False, True])
@pytest.mark.parametrize("n_frames", [1, 2, 3, 5])
def test_spectrogram_edges_match_twin(cuda, n_frames, odd):
    """K1 at frame counts that are no multiple of its frames per block,
    with rows of 0, 1 and all valid frames; ``odd`` makes the row length
    odd, so frame starts are not 8-byte aligned (scalar sample loads)."""
    from shazam_tpu_torch.ops.cuda import spectrogram
    from shazam_tpu_torch.ops.spectrogram import (db_spectrogram,
                                                  spectrogram_power_plain)

    n = 4096 + (n_frames - 1) * 2048 + odd
    rng = np.random.default_rng(n_frames)
    x = torch.from_numpy(rng.normal(0, 2000, (3, n)).astype(np.float32))
    nvf = torch.tensor([0, 1, n_frames], dtype=torch.int32)
    x, nvf = x.to(cuda), nvf.to(cuda)
    power = spectrogram.spectrogram_power(x, nvf)
    ref = spectrogram_power_plain(x, nvf)
    torch.cuda.synchronize()
    assert power.shape == ref.shape == (3, n_frames, 2049)
    assert torch.equal(power == 0, ref == 0)
    assert bool((power[0] == 0).all()) and bool((power[1, 1:] == 0).all())
    diff = (db_spectrogram(power) - db_spectrogram(ref)).abs()
    assert diff.max() < 1e-3


@pytest.mark.parametrize("n_frames", [1, 2, 15, 16, 17, 21, 37])
def test_peak_mask_edges_match_twin(cuda, n_frames):
    """K2 bit-exact at frame counts around its 16-frame tile and below its
    21-frame window, on three rows: lognormal powers with cells just at
    and just below the gate; all zero (a padded song); and quantized
    powers (plateaus of equal values closer than 21 cells) with zero
    stretches and power-1 patches across tile edges in both axes."""
    from shazam_tpu_torch.ops.cuda import peaks
    from shazam_tpu_torch.ops.peaks import peak_mask_plain, power_threshold

    thr = np.float32(power_threshold(10.0))
    below = np.nextafter(thr, np.float32(0))
    rng = np.random.default_rng(n_frames)
    p = rng.lognormal(2.0, 1.5, (3, n_frames, 2049)).astype(np.float32)
    p[0, :, ::37] = thr
    p[0, :, 5::41] = below
    p[1] = 0
    levels = np.array([0, 1, 0.5, 3, below, thr, 20, 50], np.float32)
    p[2] = rng.choice(levels, size=(n_frames, 2049))
    p[2, :, 120:140] = 0            # across the 128-bin tile edge
    p[2, :, 600:660] = 0            # wider than the window: eroded cells
    p[2, 14:18, 250:262] = 1.0      # across the 16-frame and 256-bin edges
    p[2, :, 2030:] = 0              # into the last, one-bin tile
    power = torch.from_numpy(p).to(cuda)
    got = peaks.peak_mask(power, 10.0)
    want = peak_mask_plain(power, 10.0)
    torch.cuda.synchronize()
    assert got.shape == (3, n_frames, 65)
    assert torch.equal(got, want)
    assert not got[1].any() and got[0].any()


def _bits(shape, peaks):
    """int32 (B, T, 65) mask words with bits set at peaks = (b, t, f)
    index arrays (bit j of word w is bin 32 w + j)."""
    words = np.zeros(shape[:2] + (65,), np.uint32)
    b, t, f = (np.asarray(a, np.int64) for a in peaks)
    np.bitwise_or.at(words, (b, t, f // 32),
                     np.left_shift(np.uint32(1), (f % 32).astype(np.uint32)))
    return torch.from_numpy(words.view(np.int32))


def _random_peaks(rng, bsz, n_frames, per_frame=2.5, rows=None):
    n = int(per_frame * bsz * n_frames)
    b = rng.integers(0, bsz, n) if rows is None else rng.choice(rows, n)
    return b, rng.integers(0, n_frames, n), rng.integers(0, 2049, n)


def _compact_case(case, tile):
    """(bits, capacities) of one edge case; ``tile`` is K3's frames per
    block. Row 0 is all zero. In the frame sweeps row 1 is random and row
    2 holds a frame with all 2049 bits set and bit 2048 alone in frame 0;
    the capacities are 1, n - 1, n and n + 5 for row 1's count n, and
    row 1's count in its first tiles (a cut on a tile boundary)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    sweep = {"T0": 0, "T1": 1, "T_tile-1": tile - 1, "T_tile": tile,
             "T_tile+1": tile + 1, "T1025": 1025, "T4608": 4608}
    if case in sweep:
        n_frames = sweep[case]
        b, t, f = _random_peaks(rng, 3, max(n_frames, 1), rows=[1, 2])
        extra = ([2] * 2050, [n_frames // 2] * 2049 + [0],
                 list(range(2049)) + [2048])
        b, t, f = (np.concatenate([a, e]) for a, e in zip((b, t, f), extra))
        keep = t < n_frames
        bits = _bits((3, n_frames), (b[keep], t[keep], f[keep]))
        n1 = _count(bits[1])
        cut = _count(bits[1, : tile * max(1, (n_frames // tile) // 2)])
        return bits, sorted({1, max(n1 - 1, 1), max(n1, 1), n1 + 5,
                             max(cut, 1)})
    if case == "planted":
        frames = [0, 5, 1023, 1024, 4095, 4096, 4500, 4607]
        t = np.repeat(frames, 3)
        f = np.tile([1, 1025, 2047], len(frames)) | 1   # odd bins
        f[-1] = 2048
        bits = _bits((2, 4608), ([1] * len(t), t, f))
        return bits, [1, 9, len(t) - 1, len(t), 256]   # 9: frames < 1024
    if case == "many_tiles":   # far more tiles than resident blocks
        bits = _bits((64, 4608), _random_peaks(rng, 64, 4608,
                                               rows=range(1, 64)))
        return bits, [16384]
    raise ValueError(case)


def _count(bits):
    """Set bits in an int32 mask-word tensor (on the CPU)."""
    w = bits.cpu().numpy().view(np.uint32)
    return int(np.unpackbits(w.view(np.uint8)).sum())


@pytest.mark.parametrize("case", ["T0", "T1", "T_tile-1", "T_tile",
                                  "T_tile+1", "T1025", "T4608", "planted",
                                  "many_tiles"])
def test_compact_edges_match_twin(cuda, case):
    """K3 bit-exact against compact_plain at frame counts around its
    tile, on all-zero rows, a full frame and bin 2048 alone, planted
    peaks across frames 1023/1024 and 4095/4096, capacities that cut
    the list (1, n - 1, on a tile boundary) or hold it (n), and with far
    more tiles than the card holds blocks at once (the look-back's
    forward progress)."""
    from shazam_tpu_torch.ops.cuda import compact
    from shazam_tpu_torch.ops.peaks import compact_plain

    bits, caps = _compact_case(case, compact.TILE_FRAMES)
    bits = bits.to(cuda)
    for cap in caps:
        got = compact.compact(bits, cap)
        want = compact_plain(bits, cap)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), (case, cap)
    if bits.shape[1]:
        assert int(got[2][0]) == 0 and int(got[2].max()) > 0


def test_compact_repeat_calls_agree(cuda):
    """Three calls in a row (each a new epoch of the same status words)
    give identical outputs, equal to the twin; a smaller launch after a
    larger one reuses the grown scratch."""
    from shazam_tpu_torch.ops.cuda import compact
    from shazam_tpu_torch.ops.peaks import compact_plain

    rng = np.random.default_rng(11)
    big = _bits((8, 767), _random_peaks(rng, 8, 767)).to(cuda)
    small = big[:1, :127].contiguous()
    want = [compact_plain(x, 8192) for x in (big, small)]
    for _ in range(3):
        for x, w in zip((big, small), want):
            got = compact.compact(x, 8192)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, w))


def test_custom_config_sia_on_cuda(cuda):
    """A config outside the kernels' contract (22,050 Hz, window 2048,
    radius 5) runs the plain pipeline on the card, launches no kernel,
    and answers as the CPU does."""
    from shazam_tpu_torch.api import SIA
    from shazam_tpu_torch.config import FingerprintConfig
    from shazam_tpu_torch.ops.cuda import compact, peaks, spectrogram

    cfg = FingerprintConfig(sample_rate=22050, window_size=2048,
                            peak_neighborhood_size=5, amp_min=5.0,
                            fan_value=8)
    songs = [(f"s{i}", synth_song(i, 6.0, fs=22050, seed=13))
             for i in range(3)]
    gpu, cpu = SIA(config=cfg), SIA(config=cfg, device="cpu")
    kernels = (spectrogram.KERNEL, peaks.KERNEL, compact.KERNEL)
    before = [k.launches for k in kernels]
    gpu.ingest_arrays(songs)
    cpu.ingest_arrays(songs)
    clip = np.asarray(songs[2][1])[22050: 4 * 22050]
    got = [gpu.recognize_clip(clip), gpu.recognize_samples([clip])]
    assert [k.launches for k in kernels] == before
    assert gpu.device.type == "cuda"
    assert np.array_equal(gpu.index.key_hi, cpu.index.key_hi)
    for out, want in zip(got, (cpu.recognize_clip(clip),
                               cpu.recognize_samples([clip]))):
        assert out["results"] == want["results"]
        assert out["results"][0]["song_name"] == "s2"


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


@pytest.mark.parametrize("cfg", [
    {},                                               # dense histogram
    {"sparse_vote_threshold": 0},                     # sort rank
    {"sparse_vote_threshold": 0, "vote_rank": "pruned"},  # pruned rank
    {"sparse_vote_threshold": 0, "vote_rank": "scan", "expand_block": 128,
     "expand_block_min_capacity": 0},                 # scan, blocked
    {"sparse_vote_threshold": 0, "bounds_probe_min_rows": 1},  # decided-first
])
def test_recognize_clip_syncs_only_to_copy(cuda, cfg):
    """One recognize_clip pass syncs the host three times: the clip's two
    uploads and the single read-back. The answer equals the CPU's."""
    import warnings

    from shazam_tpu_torch.api import SIA
    from shazam_tpu_torch.config import FingerprintConfig

    songs = [(f"s{i}", synth_song(i, 10.0, seed=5)) for i in range(4)]
    gpu = SIA(config=FingerprintConfig(**cfg), device="cuda")
    cpu = SIA(config=FingerprintConfig(**cfg), device="cpu")
    gpu.ingest_arrays(songs)
    cpu.ingest_arrays(songs)
    clip = songs[1][1][30 * 2048: 30 * 2048 + 4 * 44100]
    gpu.recognize_clip(clip)        # uploads the index
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")   # may warn itself: not counted
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            got = gpu.recognize_clip(clip)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in seen if "synchroniz" in str(w.message)]
    assert got["query_time"] == 0.0          # answered in one pass
    assert len(syncs) == 3, [(w.filename, w.lineno) for w in syncs]
    timing = ("fingerprint_time", "query_time", "align_time", "total_time")
    want = cpu.recognize_clip(clip)
    assert ({k: v for k, v in got.items() if k not in timing}
            == {k: v for k, v in want.items() if k not in timing})
    assert got["results"][0]["song_name"] == "s1"
