"""The plain reference against the repository's test oracle
(``tests/oracle/oracle.py``: numpy, scipy, hashlib) at a tiny size, and
its control against it."""

import sys

import numpy as np
import pytest
import torch

from benchmark_torch.lib import check, music
from benchmark_torch.reference.fingerprint import (Fingerprinter, hex20,
                                                   pair_rows, unique_rows)
from benchmark_torch.reference.match import Catalog, match

from .conftest import ROOT

sys.path.insert(0, str(ROOT / "tests" / "oracle"))
oracle = pytest.importorskip("oracle")


@pytest.fixture(scope="module")
def songs():
    gen = music.make_music_gen(8.0, seed=2**32 + 5, device="cpu")
    return gen(range(3)), gen.n_samp


def test_fingerprint_equals_the_oracle(songs):
    x, n = songs
    fp = Fingerprinter({})
    b, key, t1 = fp.rows(x, n)
    for r in range(x.shape[0]):
        want = set(oracle.oracle_fingerprint(
            x[r, :n].numpy().astype(np.float64)))
        assert fp.hex_pairs(key[b == r], t1[b == r]) == want
        assert len(want) > 100


def test_match_equals_the_oracle(songs):
    x, n = songs
    fp = Fingerprinter({})
    b, key, t1 = fp.rows(x, n)
    cat = Catalog(b, key, t1)
    rows_by_hash = {}
    for s, k, t in zip(b.tolist(), key.tolist(), t1.tolist()):
        rows_by_hash.setdefault(hex20(k, fp.n_bins).upper(), []).append(
            (s, t))
    rng = np.random.default_rng(1)
    for song in range(3):
        start = int(rng.integers(0, n - 3 * 44100))
        clip = x[song, start: start + 3 * 44100]
        noisy = clip + torch.as_tensor(rng.normal(0, 800, clip.shape[0]),
                                       dtype=torch.float32)
        _, qk, qt = fp.rows(noisy[None].round(), clip.shape[0])
        got = match(cat, qk, qt)
        pairs = fp.hex_pairs(qk, qt)
        ranked, dedup = oracle.oracle_align(rows_by_hash, pairs)
        want_song, want_delta, want_votes = ranked[0]
        assert (got["song"], got["offset"], got["votes"]) == \
            (want_song, want_delta, want_votes)
        assert got["hashes_matched"] == dedup[want_song]
        assert got["pairs"] == len(pairs)
        assert got["total"] == sum(len(rows_by_hash.get(h.upper(), ()))
                                   for h, _ in pairs)
        assert got["song"] == song


def test_control_strays_from_the_reference(songs):
    x, n = songs
    ref = Fingerprinter({})
    low = Fingerprinter({}, torch.float64, torch.bfloat16)
    b, k, t = ref.rows(x, n)
    lb, lk, lt = low.rows(x, n)
    gaps = [check.gap(ref.hex_pairs(k[b == r], t[b == r]),
                      low.hex_pairs(lk[lb == r], lt[lb == r]))
            for r in range(x.shape[0])]
    assert max(gaps) > check.LIMITS["store_row_gap"]


def test_rows_keep_pairs_near_nyquist():
    # f1 = 2048 makes a key past 2^30; it keeps its row and its bits
    mask = torch.zeros(2, 30, 2049, dtype=torch.bool)
    mask[1, 3, 2048] = mask[1, 5, 2047] = True
    mask[0, 2, 10] = mask[0, 4, 12] = mask[0, 4, 13] = True
    b, key, t1 = unique_rows(*pair_rows(mask, fan=5, min_dt=0, max_dt=200))
    assert b.tolist() == [0, 0, 0, 1]
    assert key[-1] == (2048 * 2049 + 2047) * 256 + 2 > 1 << 30
    assert t1.tolist() == [2, 2, 4, 3]
