"""K1-K3 on the card against their plain twins, and the port on CUDA.

Marked ``cuda``: each test asks the ``cuda`` fixture for the device, which
skips when no CUDA card is visible (a CUDA kernel has no CPU or interpret
mode). On a machine with a card and nvcc run them with (the ini file and
tests/conftest.py are skipped because they need pytest-xdist and JAX,
which the port does not)

    python -m pytest -c /dev/null --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import tempfile

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
    radius 5) runs the plain pipeline on the card, launches none of
    K1-K3, and answers as the CPU does."""
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


def _peak_lists(rng, rows, cap, max_t=6000):
    """Sorted (rows, cap) peak times and freqs, int32, as K3 gives them."""
    times = np.sort(rng.integers(0, max_t, (rows, cap)), axis=-1)
    freqs = rng.integers(0, 2049, (rows, cap))
    return times.astype(np.int32), freqs.astype(np.int32)


def _pair_vs_twin(times, freqs, n_peaks, **kw):
    """pair_hashes against generate_hashes_plain on the same CUDA tensors,
    all five outputs bit for bit; returns the kernel's."""
    from shazam_tpu_torch.ops.cuda import sha1
    from shazam_tpu_torch.ops.hashes import generate_hashes_plain

    before = sha1.KERNEL.launches
    got = sha1.pair_hashes(times, freqs, n_peaks, **kw)
    want = generate_hashes_plain(times, freqs, n_peaks, **kw)
    torch.cuda.synchronize()
    assert sha1.KERNEL.launches == before + (got[0].numel() > 0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    return got


@pytest.mark.parametrize("rows,cap", [(1, 8192), (16, 16384)])
def test_pair_sha1_matches_twin(cuda, rows, cap):
    """The kernel at the clip shape and the ingest shape, counts from
    empty to past the capacity, every lane (masked ones included)."""
    rng = np.random.default_rng(rows * 7 + cap)
    times, freqs = _peak_lists(rng, rows, cap)
    n = rng.integers(0, cap + 100, rows).astype(np.int32)
    n[0] = cap // 2
    got = _pair_vs_twin(torch.from_numpy(times).to(cuda),
                        torch.from_numpy(freqs).to(cuda),
                        torch.from_numpy(n).to(cuda))
    assert int(got[4].sum()) > 0


@pytest.mark.parametrize("case", ["n0", "n1", "n_cap", "n_over", "cap4_fan5",
                                  "cap2_fan5", "one_dim", "int64",
                                  "fan7_dt3_9999", "fan2_dt5_5"])
def test_pair_sha1_edges_match_twin(cuda, case):
    rng = np.random.default_rng(len(case))
    cap, kw = 256, {}
    n = {"n0": 0, "n1": 1, "n_cap": cap, "n_over": cap + 9}.get(case, 200)
    if case.startswith("cap"):
        cap = int(case[3])
        n = cap
        kw = {"fan_value": 5}
    elif case == "fan7_dt3_9999":
        kw = {"fan_value": 7, "min_dt": 3, "max_dt": 9999}
    elif case == "fan2_dt5_5":
        kw = {"fan_value": 2, "min_dt": 5, "max_dt": 5}
    times, freqs = (torch.from_numpy(a).to(cuda)
                    for a in _peak_lists(rng, 2, cap, max_t=400))
    n_peaks = torch.tensor([n, max(n - 1, 0)], dtype=torch.int32, device=cuda)
    if case == "one_dim":
        times, freqs, n_peaks = times[1], freqs[1], n_peaks[1]
    elif case == "int64":
        times, freqs, n_peaks = times.long(), freqs.long(), n_peaks.long()
    got = _pair_vs_twin(times, freqs, n_peaks, **kw)
    assert got[0].shape[-1] == (kw.get("fan_value", 5) - 1) * cap


def test_pair_sha1_digit_grid_matches_hashlib(cuda):
    """Every (f1, f2, dt) of the digit-count boundaries, one pair a row
    (anchor at t = 0 and f1, target at t = dt and f2), against hashlib's
    first 20 hex chars."""
    import hashlib
    import itertools

    from shazam_tpu_torch.ops.sha1 import keys_to_hex

    vals = (0, 9, 10, 99, 100, 999, 1000, 2048, 9999)
    trip = list(itertools.product(vals, repeat=3))
    f1, f2, dt = (np.array(v) for v in zip(*trip))
    times = np.stack([np.zeros_like(dt), dt], 1).astype(np.int32)
    freqs = np.stack([f1, f2], 1).astype(np.int32)
    n = np.full(len(trip), 2, np.int32)
    hi, lo, ex, t1, valid = _pair_vs_twin(
        *(torch.from_numpy(a).to(cuda) for a in (times, freqs, n)),
        fan_value=2, min_dt=0, max_dt=9999)
    assert bool(valid[:, 0].all()) and not bool(valid[:, 1].any())
    got = keys_to_hex(*(a[:, 0].cpu().numpy() for a in (hi, lo, ex)))
    assert got == [hashlib.sha1(f"{a}|{b}|{c}".encode()).hexdigest()[:20]
                   for a, b, c in trip]


def test_pair_sha1_one_launch_a_call(cuda):
    from shazam_tpu_torch.ops.cuda import sha1
    from shazam_tpu_torch.ops.hashes import generate_hashes

    times, freqs = (torch.from_numpy(a).to(cuda) for a in
                    _peak_lists(np.random.default_rng(3), 4, 1024))
    n = torch.full((4,), 1000, dtype=torch.int32, device=cuda)
    for k in range(1, 4):
        before = sha1.KERNEL.launches
        generate_hashes(times, freqs, n)
        assert sha1.KERNEL.launches == before + 1, k


def test_fused_fingerprint_hashes_equal_the_twins(cuda):
    """fingerprint_batch_fused on the card equals K1-K3 followed by the
    plain twin's hashes."""
    from shazam_tpu_torch.ops.cuda import compact, peaks, spectrogram
    from shazam_tpu_torch.ops.fingerprint import fingerprint_batch_fused
    from shazam_tpu_torch.ops.hashes import generate_hashes_plain
    from shazam_tpu_torch.ops.spectrogram import valid_frames

    x, nv = _batch(cuda)
    fp = fingerprint_batch_fused(x, nv, peak_capacity=2048)
    bits = peaks.peak_mask(spectrogram.spectrogram_power(
        x, valid_frames(nv, 4096, 2048).contiguous()), 10.0)
    times, freqs, n_peaks = compact.compact(bits, 2048)
    want = generate_hashes_plain(times, freqs, n_peaks)
    for a, b in zip(fp, (*want, n_peaks)):
        assert torch.equal(a, b)
    assert int(fp.n_hashes.min()) > 0


def test_recognize_clip_hashes_through_the_kernel(cuda):
    """Every ``fp.hash`` span of a clip on the card, handed off or not,
    names the kernel, and each is one launch of it: a CUDA tensor never
    runs the torch chain."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from shazam_tpu_torch import profiling
    from shazam_tpu_torch.api import SIA
    from shazam_tpu_torch.config import DEFAULT_CONFIG
    from shazam_tpu_torch.ops.cuda import sha1

    songs = [(f"s{i}", synth_song(i, 8.0, seed=31)) for i in range(3)]
    clip = np.asarray(songs[2][1])[44100: 5 * 44100]
    for cfg in (DEFAULT_CONFIG, dataclasses.replace(
            DEFAULT_CONFIG, match_capacity_fast=64,
            decision_escalation=False)):    # the second hands off
        sia = SIA(config=cfg)
        sia.ingest_arrays(songs)
        want = sia.recognize_clip(clip)
        mark = max((r.index for r in profiling.span_records()), default=-1)
        before = sha1.KERNEL.launches
        with profile(activities=[ProfilerActivity.CPU]):
            got = sia.recognize_clip(clip)
        torch.cuda.synchronize()
        assert got["results"] == want["results"]
        hashes = [r for r in profiling.span_records()
                  if r.index > mark and r.name == "fp.hash"]
        assert hashes and all(r.attrs["impl"] == "cuda" for r in hashes)
        assert sha1.KERNEL.launches - before == len(hashes)
        assert got["results"][0]["song_name"] == "s2"


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
    {"sparse_vote_threshold": 0, "vote_rank": "scan"},  # scan, row by row
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


@pytest.mark.parametrize("cfg", [
    {},                                               # dense histogram
    {"sparse_vote_threshold": 0, "bounds_probe_min_rows": 1},  # decided-first
])
def test_stereo_clip_on_cuda_equals_cpu(cuda, cfg):
    """A (2, N) clip in one pass on the card: one B = 2 launch of each
    kernel, three host syncs (the two uploads and the read-back), and the
    CPU's answer, which is ``recognize_samples`` of its channels."""
    import warnings

    from shazam_tpu_torch.api import SIA
    from shazam_tpu_torch.config import FingerprintConfig
    from shazam_tpu_torch.ops.cuda import compact

    songs = [(f"s{i}", synth_song(i, 10.0, seed=5)) for i in range(4)]
    gpu = SIA(config=FingerprintConfig(**cfg), device="cuda")
    cpu = SIA(config=FingerprintConfig(**cfg), device="cpu")
    gpu.ingest_arrays(songs)
    cpu.ingest_arrays(songs)
    left = songs[1][1][30 * 2048: 30 * 2048 + 5 * 44100]
    rng = np.random.default_rng(3)
    right = np.clip(0.7 * left + rng.normal(0, 1500, len(left)), -32768,
                    32767).astype(np.int16)
    clip = np.stack([left, right])
    gpu.recognize_clip(clip)        # uploads the index
    torch.cuda.synchronize()
    n = compact.KERNEL.launches
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            got = gpu.recognize_clip(clip)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in seen if "synchroniz" in str(w.message)]
    assert compact.KERNEL.launches == n + 1
    assert got["query_time"] == 0.0          # answered in one pass
    assert len(syncs) == 3, [(w.filename, w.lineno) for w in syncs]
    timing = ("fingerprint_time", "query_time", "align_time", "total_time")

    def strip(res):
        return {k: v for k, v in res.items() if k not in timing}

    assert strip(got) == strip(cpu.recognize_clip(clip))
    assert strip(got) == strip(gpu.recognize_samples([left, right]))
    assert got["results"][0]["song_name"] == "s1"


def test_kernels_on_a_mixed_batch(cuda):
    """K1-K3 on the shapes recognize_batch and file ingest hand them: an
    empty row (n_valid = 0, pad_to_pow2's padding), a 5 s row, a 15 s row
    and a resampled row whose length is no multiple of the hop, in one
    bucket. K1 within 1e-3 dB of its twin, K2 and K3 bit-exact; the empty
    row gives exact zeros, an empty mask and no peaks."""
    from shazam_tpu_torch.audio.resample import resample_channel
    from shazam_tpu_torch.ops.cuda import compact, peaks, spectrogram
    from shazam_tpu_torch.ops.peaks import compact_plain, peak_mask_plain
    from shazam_tpu_torch.ops.spectrogram import (db_spectrogram,
                                                  spectrogram_power_plain,
                                                  valid_frames)

    rows = [np.zeros(0, np.int16), synth_song(1, 5.0, seed=3),
            synth_song(2, 15.0, seed=3),
            resample_channel(synth_song(3, 9.0, fs=48000, seed=3), 48000,
                             44100)]
    x = np.zeros((len(rows), 786_432), np.float32)
    for i, r in enumerate(rows):
        x[i, : len(r)] = r
    nv = torch.tensor([len(r) for r in rows], dtype=torch.int32)
    xs = torch.from_numpy(x).to(cuda)
    nvf = valid_frames(nv, 4096, 2048).to(cuda)
    power = spectrogram.spectrogram_power(xs, nvf)
    ref = spectrogram_power_plain(xs, nvf)
    assert (db_spectrogram(power) - db_spectrogram(ref)).abs().max() < 1e-3
    assert torch.equal(power == 0, ref == 0) and not power[0].any()
    bits = peaks.peak_mask(power, 10.0)
    assert torch.equal(bits, peak_mask_plain(power, 10.0))
    assert not bits[0].any()
    got = compact.compact(bits, 8192)
    for a, b in zip(got, compact_plain(bits, 8192)):
        assert torch.equal(a, b)
    assert int(got[2][0]) == 0 and not got[0][0].any()
    assert all(int(n) > 0 for n in got[2][1:])


def test_recognize_batch_on_cuda_equals_cpu(cuda):
    """recognize_batch on the card answers as on the CPU, dense and sparse,
    with a padding row and mixed clip lengths."""
    import dataclasses

    from shazam_tpu_torch.api import SIA

    songs = [(f"s{i}", synth_song(i, 10.0, seed=5)) for i in range(4)]
    gpu, cpu = SIA(device="cuda"), SIA(device="cpu")
    gpu.ingest_arrays(songs)
    cpu.ingest_arrays(songs)
    clips = [songs[i][1][(10 + 9 * i) * 2048:][: int((3 + 2 * i) * 44100)]
             for i in range(3)]
    timing = ("fingerprint_time", "query_time", "align_time", "total_time",
              "batch_fingerprint_time", "batch_query_time")
    for cfg in ({}, {"sparse_vote_threshold": 0}):
        for sia in (gpu, cpu):
            sia.config = dataclasses.replace(sia.config, **cfg)
        got = gpu.recognize_batch(clips, pad_to_pow2=True)
        want = cpu.recognize_batch(clips, pad_to_pow2=True)
        for i, (g, w) in enumerate(zip(got, want)):
            assert ({k: v for k, v in g.items() if k not in timing}
                    == {k: v for k, v in w.items() if k not in timing})
            assert g["results"][0]["song_name"] == f"s{i}"


@pytest.mark.parametrize("rank", ["dense", "sort"])
def test_batched_dispatch_launches_do_not_grow(cuda, rank):
    """One match_queries_batched dispatch makes as many launches (kernels,
    copies, memsets) at B = 8 and at B = 32 as at B = 2, counted from the
    host's launch calls: the batch is one dispatch, not a loop
    over clips. The vote space is a 2,714-song catalog's (3,000 songs x
    6,144 delta bins), so the dense histogram passes 2 GB at B = 32."""
    from shazam_tpu_torch.index import store
    from shazam_tpu_torch.match.batched import match_queries_batched
    from shazam_tpu_torch.profiling import host_launches

    rng = np.random.default_rng(9)
    n = 40_000
    cols = [rng.integers(0, 1 << 9, n), rng.integers(0, 8, n),
            rng.integers(0, 4, n), rng.integers(0, 200, n),
            rng.integers(0, 600, n)]
    cols = [a.astype(np.uint32) for a in cols]
    order = np.lexsort(cols[::-1])
    ix = store.from_numpy(*(a[order] for a in cols), 200, 599)
    dev = ix.device_arrays(cuda)
    qi = rng.integers(0, n, (32, 1024))
    q = [torch.from_numpy(cols[k][order][qi].astype(np.int64)).to(cuda)
         for k in range(3)]
    q += [torch.from_numpy(rng.integers(0, 300, (32, 1024))).to(cuda),
          torch.ones((32, 1024), dtype=torch.bool, device=cuda),
          torch.ones((32, 1024), dtype=torch.bool, device=cuda)]
    kw = dict(rank=rank, n_songs=3000, delta_min=-1024, delta_range=6144,
              match_capacity=65536, topn=2,
              expand_block=128 if rank == "sort" else 0, expand_runs=1024)

    def run(bq):
        return lambda: match_queries_batched(dev, *(a[:bq] for a in q), **kw)

    for bq in (2, 8, 32):
        run(bq)()
    counts = {bq: host_launches(run(bq))[0] for bq in (2, 8, 32)}
    assert counts[2] == counts[8] == counts[32], counts


def test_compact_from_many_threads_is_exact(cuda):
    """8 threads x 50 K3 calls at once on different masks, all on the
    default stream (sharing one look-back scratch): every result equals
    the twin bit for bit."""
    import threading

    from shazam_tpu_torch.ops.cuda import compact
    from shazam_tpu_torch.ops.peaks import compact_plain

    rng = np.random.default_rng(21)
    cases = []
    for k in range(8):
        shape = (1 + k % 3, 16 * (k + 1) + k)
        bits = _bits(shape, _random_peaks(rng, *shape, per_frame=3.0 + k))
        bits = bits.to(cuda)
        cap = 64 + 97 * k
        cases.append((bits, cap, compact_plain(bits, cap)))
    torch.cuda.synchronize()
    bad = []

    def worker(k):
        for i in range(50):
            bits, cap, want = cases[(k + i) % len(cases)]
            got = compact.compact(bits, cap)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                bad.append((k, i))

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad


@pytest.mark.parametrize("engine", ["host", "device"])
def test_stream_engines_bit_equal_on_cuda(cuda, engine):
    """Both stream engines on the card, fed a 20 s song in CHUNKs: each
    15 s window's Fingerprints equal fingerprint_batch_fused of the
    window's samples on the card, every field."""
    from shazam_tpu_torch.api import _bucket_len
    from shazam_tpu_torch.config import FingerprintConfig
    from shazam_tpu_torch.ops.fingerprint import fingerprint_batch_fused
    from shazam_tpu_torch.stream import CHUNK, IncrementalFingerprinter
    from shazam_tpu_torch.stream_device import DeviceIncrementalFingerprinter

    cls = (IncrementalFingerprinter if engine == "host"
           else DeviceIncrementalFingerprinter)
    cfg = FingerprintConfig()
    inc = cls(cfg, 15.0, device=cuda)
    song = synth_song(6, 20.0, seed=3).astype(np.float32)
    fed = checks = 0
    while fed + CHUNK <= len(song):
        inc.feed(song[fed: fed + CHUNK])
        fed += CHUNK
        if not getattr(inc, "ready", True) or (fed // CHUNK) % 5:
            continue
        a, b = inc.window_sample_range()
        x = np.zeros((1, _bucket_len(b - a)), np.float32)
        x[0, : b - a] = song[a:b]
        want = fingerprint_batch_fused(
            torch.from_numpy(x).to(cuda),
            torch.tensor([b - a], device=cuda))
        got = inc.fingerprints()
        for name, g, w in zip(got._fields, got, want):
            assert torch.equal(g, w[0]), (name, a, b)
        checks += 1
    assert checks >= 3


def test_daemon_on_cuda_answers_concurrent_requests(cuda):
    """A daemon over SIA(device="cuda") answers 16 concurrent clients
    (batched, pipelined) with no error and the right songs."""
    import threading

    from shazam_tpu_torch.api import SIA
    from shazam_tpu_torch.client import SIAClient
    from shazam_tpu_torch.serve import RecognitionServer

    songs = [(f"s{i}", synth_song(i, 10.0, seed=8)) for i in range(8)]
    sia = SIA(device="cuda")
    sia.ingest_arrays(songs)
    srv = RecognitionServer(sia, port=0, max_batch=8, max_wait_ms=20.0)
    srv.start_background()
    try:
        client = SIAClient(f"http://127.0.0.1:{srv.port}")
        got = {}

        def hit(k):
            clip = songs[k % 8][1][(7 + k) * 2048:][: 5 * 44100]
            got[k] = client.recognize(clip, fs=44100)

        threads = [threading.Thread(target=hit, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = client.stats()
    finally:
        srv.close()
    assert len(got) == 16
    for k, out in got.items():
        assert out["results"][0]["song_name"] == f"s{k % 8}"
    assert stats["errors"] == 0 and stats["requests"] == 16
    assert stats["batches"] < 16


def test_device_store_on_cuda_equals_cpu(cuda):
    """The device store's merges, appends and search view on the card
    equal the same operations on the CPU, row for row."""
    from shazam_tpu_torch.index.devmerge import DeviceIndex, host_cols
    from shazam_tpu_torch.index.store import FingerprintIndex

    rng = np.random.default_rng(3)

    def run(n):
        cols = [rng.integers(0, 64, n, dtype=np.uint32),
                rng.integers(0, 1 << 32, n, dtype=np.uint32),
                rng.integers(0, 3, n, dtype=np.uint32),
                rng.integers(0, 40, n, dtype=np.uint32),
                rng.integers(0, 3000, n, dtype=np.uint32)]
        order = np.lexsort(cols[::-1])
        return FingerprintIndex(*(c[order] for c in cols), n_songs=40,
                                max_offset=int(cols[4].max()))

    base = run(70_000)
    stores = {d: DeviceIndex.from_host(base, reserve=1 << 17, device=d)
              for d in (cuda, "cpu")}
    for k in range(4):
        add = run(5_000 + 97 * k)
        for d, store in stores.items():
            if k % 2:
                cols = tuple(torch.from_numpy(c).to(d)
                             for c in host_cols(add, store.stride))
                store.append_run(cols, add.n_hashes, add.n_songs,
                                 add.max_offset)
            else:
                store.merge(add)
    gpu, cpu = (stores[d].query_cols() for d in (cuda, "cpu"))
    assert gpu.n_rows == cpu.n_rows and gpu.stride == cpu.stride
    for a, b in zip(gpu[:3], cpu[:3]):
        assert torch.equal(a.cpu(), b)
    host_gpu, host_cpu = stores[cuda].to_host(), stores["cpu"].to_host()
    for name in ("key_hi", "key_lo", "key_ex", "song_id", "offset"):
        assert np.array_equal(getattr(host_gpu, name), getattr(host_cpu, name))


def test_ingest_device_batch_on_cuda_equals_host_ingest(cuda):
    """ingest_device_batch on the card (K1-K3, the run, the merge, the
    2x retry of a row over the capacity) gives the rows and per-song
    counts of host ingest on the card."""
    from shazam_tpu_torch.api import SIA
    from shazam_tpu_torch.ops.cuda import compact

    songs = [(f"s{i}", synth_song(i, 10.0, seed=4)) for i in range(6)]
    x = np.zeros((6, 1 << 19), np.float32)
    for i, (_n, s) in enumerate(songs):
        x[i, : len(s)] = s
    nv = [len(s) for _n, s in songs]
    host, dev = SIA(device=cuda), SIA(device=cuda, device_resident=True)
    n = compact.KERNEL.launches
    peaks = [int(host._fingerprint_channel(s).n_peaks) for _n, s in songs]
    cap = sorted(peaks)[-2] + 1     # the row with the most peaks retries
    stats = dev.ingest_device_batch([n_ for n_, _s in songs],
                                    torch.from_numpy(x).to(cuda), nv,
                                    song_peak_capacity=cap)
    assert stats["ingested"] == 6 and stats["fallbacks"] == 1
    assert stats["merges"] == 2 and compact.KERNEL.launches > n + 6
    hstats = host.ingest_arrays(songs, song_peak_capacity=cap)
    assert hstats["fallbacks"] == 1
    for name in ("key_hi", "key_lo", "key_ex", "song_id", "offset"):
        assert np.array_equal(getattr(host.index, name),
                              getattr(dev.index, name)), name
    assert host.catalog.song_hashes_by_id() == dev.catalog.song_hashes_by_id()
    clip = songs[3][1][9 * 2048:][: 5 * 44100]

    def answers(sia):   # the resume keys differ: SHA-1 of name, of bytes
        return [{k: v for k, v in r.items() if k != "file_sha1"}
                for r in sia.recognize_clip(clip)["results"]]

    assert answers(dev) == answers(host)
    assert answers(dev)[0]["song_name"] == "s3"


def test_apriori_on_cuda_equals_cpu(cuda):
    """Both apriori variants on the card: the host loop's and the device
    variant's results equal each other and the CPU's, field for field and
    batch for batch, through an early exit and a full sweep."""
    from shazam_tpu_torch.api import SIA
    from shazam_tpu_torch.match.apriori import (match_query_apriori,
                                                match_query_apriori_ondevice)
    from shazam_tpu_torch.match.prepare import prepare_query

    songs = [(f"s{i}", synth_song(i, 10.0, seed=4)) for i in range(4)]
    out = {}
    for d in (cuda, "cpu"):
        sia = SIA(device=d)
        sia.ingest_arrays(songs)
        index = sia._ensure_device_index()
        clip = songs[2][1][3 * 44100: 8 * 44100]
        q = prepare_query([sia._fingerprint_channel(clip)])
        delta_min, delta_range = sia._delta_params_for(len(clip))
        res = []
        for bs in (64, 96, 1024):
            kw = dict(n_songs=sia._n_songs(), delta_min=delta_min,
                      delta_range=delta_range, batch_size=bs)
            host = match_query_apriori(index, q, **kw)
            dev = match_query_apriori_ondevice(index, q, **kw)
            assert host[1:] == dev[1:]
            res.append((host, dev))
        out[str(d)] = res
        assert sia.recognize_samples([clip], early_exit=True)[
            "results"][0]["song_name"] == "s2"
    assert any(h[1] < -(-q.n_pairs // 64) for h, _ in out["cpu"][:1])
    for (gh, gd), (ch, cd) in zip(out[str(cuda)], out["cpu"]):
        for got in (gh, gd):
            assert got[1:] == ch[1:]
            for a, b in zip(got[0], ch[0]):
                assert np.array_equal(np.asarray(a), np.asarray(b))


def test_spanned_store_on_cuda_equals_cpu(cuda):
    """A ``SpannedDeviceStore`` on the card takes the same runs as one on
    the CPU (merged, appended, host pieces, span rolls), holds the same
    spans and matches alike per span and consolidated, with the same
    ``span_max``."""
    from shazam_tpu_torch.index.devmerge import (SpannedDeviceStore,
                                                 host_cols)
    from shazam_tpu_torch.index.store import FingerprintIndex
    from shazam_tpu_torch.match.lookup import match_query_sparse_spanned

    rng = np.random.default_rng(12)

    def run(n):
        cols = [rng.integers(0, 64, n, dtype=np.uint32),
                rng.integers(0, 1 << 32, n, dtype=np.uint32),
                rng.integers(0, 3, n, dtype=np.uint32),
                rng.integers(0, 40, n, dtype=np.uint32),
                rng.integers(0, 3000, n, dtype=np.uint32)]
        order = np.lexsort(cols[::-1])
        return FingerprintIndex(*(c[order] for c in cols), n_songs=40,
                                max_offset=int(cols[4].max()))

    base = run(20_000)
    stores = {d: SpannedDeviceStore.from_host(base, 8192, device=d)
              for d in (cuda, "cpu")}
    adds = [run(3_000 + 97 * k) for k in range(6)]
    for k, add in enumerate(adds):
        for d, store in stores.items():
            if k % 3 == 0:
                store.merge(add)
            else:
                cols = tuple(torch.from_numpy(c).to(d)
                             for c in host_cols(add, store.stride))
                absorb = store.append_run if k % 3 == 1 else \
                    store.merge_device_run
                absorb(cols, add.n_hashes, add.n_songs, add.max_offset)
    gpu, cpu = stores[cuda], stores["cpu"]
    assert len(gpu.spans) == len(cpu.spans) >= 3
    q_rows = base.key_hi[::97], base.key_lo[::97], base.key_ex[::97]
    n_q = len(q_rows[0])
    q = [torch.from_numpy(np.asarray(a, np.int64)) for a in q_rows] + [
        torch.from_numpy(rng.integers(0, 50, n_q)),
        torch.ones(n_q, dtype=torch.bool), torch.ones(n_q, dtype=torch.bool)]
    kw = dict(n_songs=40, delta_min=-64, delta_range=4096 + 128,
              match_capacity=4096, topn=3)
    for _layout in ("spans", "stacked"):
        got = match_query_sparse_spanned(
            gpu.query_cols(), *(a.to(cuda) for a in q), **kw)
        want = match_query_sparse_spanned(cpu.query_cols(), *q, **kw)
        for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
            assert torch.equal(a.cpu(), b)
        gpu.consolidate()
        cpu.consolidate()
    assert gpu.is_stacked and gpu._stacked_valids == cpu._stacked_valids
    for a, b in zip(gpu._stacked, cpu._stacked):
        assert torch.equal(a.cpu(), b)
    host_gpu, host_cpu = gpu.to_host(), cpu.to_host()
    for name in ("key_hi", "key_lo", "key_ex", "song_id", "offset"):
        assert np.array_equal(getattr(host_gpu, name), getattr(host_cpu, name))


def test_spanned_round_trip_on_cuda(cuda, tmp_path):
    """A spanned SIA on the card saves the span-wise file, which loads
    straight onto a store on the card and flat on the CPU, rows equal."""
    from shazam_tpu_torch.api import SIA

    songs = [(f"s{i}", synth_song(i, 6.0, seed=4)) for i in range(8)]
    sia = SIA(device=cuda, device_span_rows=4096)
    sia.ingest_arrays(songs)
    path = str(tmp_path / "spanned.npz")
    sia.save_index(path)
    back = SIA(device=cuda, device_span_rows=4096)
    back.catalog = sia.catalog
    back.load_index(path)
    assert back._dev_store.device.type == "cuda" and back._host_stale
    flat = SIA(device="cpu")
    flat.catalog = sia.catalog
    flat.load_index(path)
    for name in ("key_hi", "key_lo", "key_ex", "song_id", "offset"):
        assert np.array_equal(getattr(back.index, name),
                              getattr(sia.index, name)), name
        assert np.array_equal(getattr(flat.index, name),
                              getattr(sia.index, name)), name
    clip = songs[5][1][44100: 5 * 44100]
    assert back.recognize_clip(clip)["results"] == \
        flat.recognize_clip(clip)["results"]


def test_one_rank_nccl_sharded_catalog_equals_sia(cuda):
    """``make_mesh()`` on the card is a one-rank NCCL group; a
    ``ShardedCatalog`` on it, in both regimes, answers as the SIA whose
    index it shards (``ShardedRecognizer`` fingerprints with K1-K3), and
    ``sequence_parallel_fingerprint`` at one rank equals the single-device
    pipeline."""
    import torch.distributed as dist

    from shazam_tpu_torch.api import SIA
    from shazam_tpu_torch.ops.fingerprint import fingerprint_samples
    from shazam_tpu_torch.parallel.mesh import make_mesh
    from shazam_tpu_torch.parallel.sequence import \
        sequence_parallel_fingerprint
    from shazam_tpu_torch.parallel.serving import (ShardedCatalog,
                                                   ShardedRecognizer)

    songs = [(f"s{i}", synth_song(i, 8.0, seed=4)) for i in range(5)]
    sia = SIA(device=cuda)
    sia.ingest_arrays(songs)
    mesh = make_mesh()
    try:
        assert (mesh.backend, mesh.size, mesh.device.type) == ("nccl", 1,
                                                               "cuda")
        clips = [songs[i][1][44100: 6 * 44100] for i in (1, 3)]
        for limit, regime in ((1 << 30, "key_range"), (1, "by_song")):
            rec = ShardedRecognizer(ShardedCatalog(
                sia.index, mesh=mesh, catalog=sia.catalog,
                dense_limit_bytes=limit))
            assert rec.cat.regime == regime
            for clip in clips:
                got = rec.recognize_samples([clip], topn=3)
                want = sia.recognize_samples([clip], topn=3)
                assert got["results"] == want["results"], regime
                assert got["total_matches"] == want["total_matches"]
        song = songs[2][1].astype(np.float32)
        pad = np.zeros(-(-len(song) // 2048) * 2048, np.float32)
        pad[: len(song)] = song
        seq = sequence_parallel_fingerprint(mesh, pad, len(song))
        ref = fingerprint_samples(torch.from_numpy(pad).to(cuda), len(song))
        assert all(torch.equal(a, b) for a, b in zip(seq, ref))
    finally:
        dist.destroy_process_group()


def _four_rank_work(rank, world, songs, cols, q):
    """Every sharded entry point at 4 ranks, for
    ``test_four_ranks_over_nccl_equal_gloo``: the matches as plain values
    (the index and query are the CPU's, so they must be equal on any
    backend), the rest as equality with the same device's single-device
    pipeline."""
    import torch.distributed as dist

    from shazam_tpu_torch.api import SIA
    from shazam_tpu_torch.index.store import from_numpy
    from shazam_tpu_torch.match.lookup import raw_to_host
    from shazam_tpu_torch.match.prepare import QueryPairs
    from shazam_tpu_torch.ops.fingerprint import (fingerprint_batch,
                                                  fingerprint_batch_fused,
                                                  fingerprint_samples)
    from shazam_tpu_torch.parallel.bigcatalog import (shard_index_by_song,
                                                      sharded_match_by_song)
    from shazam_tpu_torch.parallel.mesh import make_mesh, shard_index_arrays
    from shazam_tpu_torch.parallel.multihost import (
        SpannedCatalog, distributed_ingest_arrays)
    from shazam_tpu_torch.parallel.sequence import \
        sequence_parallel_fingerprint
    from shazam_tpu_torch.parallel.serving import (ShardedCatalog,
                                                   ShardedRecognizer)
    from shazam_tpu_torch.parallel.sharded import (sharded_ingest_step,
                                                   sharded_match_query)

    on_card = dist.get_backend() == "nccl"
    mesh = make_mesh(world, device="cuda" if on_card else "cpu")
    dev = mesh.device
    ix = from_numpy(*cols, n_songs=len(songs) + 1,
                    max_offset=int(cols[4].max()))
    q = QueryPairs(*q)
    qcols = [getattr(q, c) for c in ("hi", "lo", "ex", "t", "valid", "first")]
    kw = dict(delta_min=-1024, delta_range=4096 + 2048, topn=3)
    out = {}
    for cap in (65536, 300):   # the second clamps the shards' expansions
        raw = sharded_match_query(mesh, shard_index_arrays(ix, world), *qcols,
                                  n_songs=ix.n_songs, match_capacity=cap,
                                  offset_stride=ix.offset_stride, **kw)
        stacked, n_local, stride = shard_index_by_song(ix, world)
        raw_b = sharded_match_by_song(mesh, stacked, n_local, stride, *qcols,
                                      match_capacity=cap, **kw)
        out[cap] = [np.asarray(a).tolist() for r in (raw, raw_b)
                    for a in raw_to_host(r)[0]]
    rows = np.zeros((world, 1 << 18), np.float32)
    for i in range(world):
        rows[i, : 5 * 44100] = songs[i][1][: 5 * 44100]
    n_valid = np.full(world, 5 * 44100, np.int32)
    fp = sharded_ingest_step(mesh, rows, n_valid)
    ref = (fingerprint_batch_fused if on_card else fingerprint_batch)(
        torch.from_numpy(rows).to(dev), torch.from_numpy(n_valid).to(dev),
        peak_capacity=4096)
    out["ingest"] = all(torch.equal(a, b) for a, b in zip(fp, ref))
    song = songs[2][1].astype(np.float32)
    pad = np.zeros(-(-len(song) // (world * 2048)) * world * 2048, np.float32)
    pad[: len(song)] = song
    seq = sequence_parallel_fingerprint(mesh, pad, len(song))
    one = fingerprint_samples(torch.from_numpy(pad).to(dev), len(song))
    out["sequence"] = all(torch.equal(a, b) for a, b in zip(seq, one))
    sia = SIA(device=dev)
    sia.ingest_arrays(songs)
    clip = songs[3][1][44100: 6 * 44100]
    for limit in (1 << 30, 1):
        rec = ShardedRecognizer(ShardedCatalog(
            sia.index, mesh=mesh, catalog=sia.catalog,
            dense_limit_bytes=limit))
        if mesh.rank:
            out[limit] = rec.follow()
            continue
        try:
            got = rec.recognize_samples([clip], topn=3)["results"]
        finally:
            rec.close()
        out[limit] = (got == sia.recognize_samples([clip], topn=3)["results"],
                      got[0]["song_name"])
    cat, local = distributed_ingest_arrays(
        [name for name, _ in songs], lambda s: songs[s][1], mesh=mesh)
    q = prepare_query_of(local, clip)
    with tempfile.TemporaryDirectory() as tmp:
        cat.save_local_shards(tmp)
        back = SpannedCatalog.load_local_shards(tmp, mesh=mesh)
        answers = [c.match(q, topn=2).results for c in (cat, back)]
    out["spanned"] = (answers[0] == answers[1], answers[0][0]["song_id"])
    return out


def prepare_query_of(sia, clip):
    from shazam_tpu_torch.match.prepare import prepare_query

    return prepare_query([sia._fingerprint_channel(clip)])


def test_four_ranks_over_nccl_equal_gloo(cuda, tmp_path):
    """The sharded path at 4 ranks over NCCL, one card each, against the
    same 4 ranks over gloo on the CPU (which the CPU tests hold against
    the JAX package): key-range and by-song matches (one clamped) equal
    value for value; on each backend the ingest step equal to its
    device's pipeline, sequence parallel to the single-device one, the
    recognizer (3 ranks following) to the SIA, and distributed ingest's
    answers after a shard-file round trip. Needs 4 cards; one skips it."""
    from shazam_tpu_torch.api import SIA
    from tests.test_torch_sharding import spawn_ranks

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards")
    songs = [(f"s{i}", synth_song(i, 8.0, seed=4)) for i in range(8)]
    sia = SIA(device="cpu")
    sia.ingest_arrays(songs)
    q = prepare_query_of(sia, songs[3][1][44100: 6 * 44100])
    cols = tuple(getattr(sia.index, c) for c in (
        "key_hi", "key_lo", "key_ex", "song_id", "offset"))
    args = (songs, cols, tuple(q))
    got = spawn_ranks(_four_rank_work, 4, tmp_path / "nccl", *args,
                      backend="nccl", timeout=300.0)
    want = spawn_ranks(_four_rank_work, 4, tmp_path / "gloo", *args,
                       timeout=300.0)
    assert got == want
    assert got[0][1 << 30] == (True, "s3") and got[0][1] == (True, "s3")
    assert got[1][1 << 30] == {"matches": 1, "errors": 0}
    assert all(r["ingest"] and r["sequence"] and r["spanned"] == (True, 3)
               for r in got)
