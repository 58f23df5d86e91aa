"""Port parity, K3's contract on the CPU: the compaction of planted peaks.

Mirrors ``tests/test_pallas.py``'s ``test_compact_exact_past_frame_4096``
and ``test_compact_slot_skip_edges``: one planted (t, f) list becomes the
JAX package's candidate table and the port's bit-packed mask. The port's
``compact`` on CPU tensors (the plain twin of K3) and the interpret-mode
Pallas ``compact_candidates`` must give the same (times, freqs, n_peaks),
equal to the planted list in (t, f) order, including cuts of the list by
the capacity. Also the host side of K3's look-back scratch.
"""

import numpy as np
import pytest
import torch

from shazam_tpu_torch.ops.cuda.compact import LookBackScratch, compact

GROUP_CAP = 8     # the JAX candidate table's slots per (frame, 128-bin group)
N_GROUPS = 17     # 128-bin groups per frame in that table


def _planted_past_4096():
    """Three odd bins in one random group at frames up to 4607 (the
    frames where an f32 scatter of t * 4096 + f would round)."""
    rng = np.random.default_rng(3)
    planted = []
    for t in [0, 5, 4095, 4096, 4500, 4607]:
        g = int(rng.integers(0, N_GROUPS))
        lanes = sorted(int(x) for x in rng.choice(128, size=3, replace=False))
        fs = sorted({(g * 128 + lane) | 1 for lane in lanes})[:3]
        planted += [(t, f) for f in fs]
    return 4608, planted


def _planted_slot_skip():
    """An empty first 128-frame tile, a row using every group slot, a row
    with one, and two mid-density rows (384 frames). The JAX test's rows
    in group 16 lie past bin 2048, outside the port's 2049-bin mask, so
    the one-slot row is bin 2048 (the last group's only bin) and the last
    row moves to group 15."""
    planted = [(130, 4 * 128 + 2 * i) for i in range(GROUP_CAP)]
    planted.append((200, 2048))
    for t, g, k in [(300, 2, 3), (383, 15, 5)]:
        planted += [(t, g * 128 + 3 * i + 1) for i in range(k)]
    return 384, planted


def _table(n_frames, planted):
    """The JAX candidate table: row t * N_GROUPS + g holds the group's
    global bins in its first slots (-1 if empty) and their count at
    column GROUP_CAP."""
    table = np.zeros((1, n_frames * N_GROUPS, 128), np.int32)
    table[:, :, :GROUP_CAP] = -1
    for t, f in planted:
        row = table[0, t * N_GROUPS + f // 128]
        row[row[GROUP_CAP]] = f
        row[GROUP_CAP] += 1
    return table


def _bits(n_frames, planted):
    """The port's int32 (1, T, 65) mask words (bit j of word w = bin 32w+j)."""
    words = np.zeros((1, n_frames, 65), np.uint32)
    for t, f in planted:
        words[0, t, f // 32] |= np.uint32(1 << (f % 32))
    return torch.from_numpy(words.view(np.int32))


@pytest.mark.parametrize("capacity", [256, 10])
@pytest.mark.parametrize("case", ["past_frame_4096", "slot_skip_edges"])
def test_compact_matches_pallas_on_planted_peaks(case, capacity):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from shazam_tpu.ops.pallas.compact import compact_candidates

    n_frames, planted = {"past_frame_4096": _planted_past_4096,
                         "slot_skip_edges": _planted_slot_skip}[case]()
    with pltpu.force_tpu_interpret_mode():
        jt, jf, jn = compact_candidates(
            jnp.asarray(_table(n_frames, planted)), capacity)
    times, freqs, n_peaks = compact(_bits(n_frames, planted), capacity)
    n = len(planted)
    k = min(n, capacity)
    assert int(n_peaks[0]) == int(jn[0]) == n   # exact past the capacity
    assert np.array_equal(times[0].numpy(), np.asarray(jt)[0].astype(np.int32))
    assert np.array_equal(freqs[0].numpy(), np.asarray(jf)[0].astype(np.int32))
    got = list(zip(times[0, :k].tolist(), freqs[0, :k].tolist()))
    assert got == sorted(planted)[:k]
    assert not times[0, k:].any() and not freqs[0, k:].any()


def test_lookback_scratch_bookkeeping():
    """The ticket base advances by each launch's blocks mod 2^32, every
    call gets a new epoch, the words grow zeroed (and the base restarts
    with the counter), and an epoch wrap zeroes the words past the
    counter once and restarts at 1."""
    s = LookBackScratch("cpu")
    words, base, epoch = s.take(5)
    assert words.numel() == 6 and (base, epoch) == (0, 1)
    s.commit(7)
    words, base, epoch = s.take(3)      # fits: no new tensor
    assert words.numel() == 6 and (base, epoch) == (7, 2)
    s.commit(2 ** 32 - 1)
    assert s.base == 6
    words[:] = 9
    grown, base, epoch = s.take(20)
    assert grown.numel() == 21 and not grown.any() and (base, epoch) == (0, 3)
    grown[:] = 5
    s.epoch = LookBackScratch.EPOCHS - 1
    words, base, epoch = s.take(1)
    assert epoch == 1 and words[0] == 5 and not words[1:].any()


def test_compact_rejects_nonpositive_capacity():
    bits = torch.zeros((1, 8, 65), dtype=torch.int32)
    for capacity in (0, -1):
        with pytest.raises(ValueError):
            compact(bits, capacity)
