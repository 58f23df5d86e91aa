"""The copied arithmetic on hand-made inputs."""

import pytest

from benchmark_torch.lib import roofline, stats, trace


def test_percentiles_over_every_value():
    values = list(range(1, 101))
    assert stats.percentile(values, 50) == pytest.approx(50.5)
    assert stats.percentile(values, 95) == pytest.approx(95.05)
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_idle_union_merges_overlaps_and_labels_gaps():
    busy, merged = trace.union_seconds([(0, 10), (5, 20), (30, 40),
                                        (38, 45), (100, 101)])
    assert busy == pytest.approx((20 + 15 + 1) / 1e6)
    assert merged == [[0, 20], [30, 45], [100, 101]]
    cpu = [(0, 200, "outer"), (50, 90, "inner"), (21, 29, "short")]
    gaps = trace._gap_labels(merged, cpu, top=10)
    assert gaps == [["inner", 55 / 1e6], ["short", 10 / 1e6]]
    gaps = trace._gap_labels(merged, [(1, 19, "copy"), (2, 3, "x")], top=1)
    assert gaps == [["after copy", 55 / 1e6]]
    assert trace.union_seconds([]) == (0.0, [])


def test_kernel_bounds_at_the_clip_shape():
    # one 15 s clip: 321 valid of 383 padded frames, 8,192 peaks
    b = roofline.kernel_bounds([321], 383, 8192)
    assert sum(b.values()) == pytest.approx(0.00274, abs=1e-5)
    # bytes bound K2: power in (4 B a cell), mask words out
    cells = 383 * 2049
    assert b["peak_mask"] == pytest.approx(
        1e3 * (4 * cells + 4 * 383 * 65) / roofline.HBM_BYTES_S)


def test_kernel_bounds_at_the_ingest_shape():
    # (16, 1,572,864): the device batch of PR 10, 767 frames a row
    b = roofline.kernel_bounds([767] * 16, 767, 16384)
    assert b["spectrogram_power"] == pytest.approx(0.0601, abs=5e-4)
    assert b["peak_mask"] == pytest.approx(0.0310, abs=5e-4)
    assert b["compact"] == pytest.approx(0.0016, abs=1e-4)


def test_roofline_share_counts_only_recorded_launches():
    shape = {"nvf": [321], "n_frames": 383, "cap": 8192}
    b = roofline.kernel_bounds(**shape)
    kernels = {"spectrogram_power_kernel(float const*, ...)": [2, 4e-5],
               "peak_mask_kernel": [2, 2e-5], "compact_kernel": [1, 1e-5],
               "elementwise_kernel": [100, 1.0]}
    want = 100 * (2 * b["spectrogram_power"] + 2 * b["peak_mask"]
                  + b["compact"]) / 1e3 / 7e-5
    assert roofline.share_percent(kernels, shape) == pytest.approx(want)
    assert roofline.share_percent({"other": [1, 1.0]}, shape) is None


def test_frames():
    assert roofline.frames(4095) == 0
    assert roofline.frames(4096) == 1
    assert roofline.frames(661500) == 321


def test_the_store_is_sized_for_the_catalog():
    from benchmark_torch.lib import catalog

    assert catalog.reserve_hashes({"songs": 2714, "song_s": 101.0}) == 1 << 24
    assert catalog.reserve_hashes({"songs": 7986, "song_s": 252.0}) == 1 << 27
