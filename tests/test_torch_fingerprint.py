"""Port parity, the fingerprint pipeline and on-device recognition.

- ``fingerprint_batch_fused`` (CPU: the kernels' plain twins) against the
  JAX XLA ``fingerprint_batch`` and the NumPy/scipy oracle: hash-set
  jaccard > 0.98 (tests/test_dsp_parity.py's gate);
- a dense spectral comb that overflows the JAX fused path's per-group cap
  (tests/test_pallas.py) fingerprints exactly in the port, which has no
  group cap;
- ``recognize_fingerprints`` (on-device dedup + dense match) against the
  JAX ``recognize_on_device`` given the same fingerprints: every field.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shazam_tpu.audio.synth import synth_song
from shazam_tpu.ops.fingerprint import fingerprint_batch as jax_fingerprint_batch
from shazam_tpu_torch.ops.fingerprint import (Fingerprints, fingerprint,
                                              fingerprint_batch,
                                              fingerprint_batch_fused,
                                              fingerprint_to_hex_pairs)


def _pair_set(fp, b):
    v = np.asarray(fp.valid[b])
    return set(zip(*(np.asarray(a[b])[v].astype(np.int64).tolist()
                     for a in (fp.hi, fp.lo, fp.ex, fp.t1))))


def _jaccard(a, b):
    return len(a & b) / max(len(a | b), 1)


def test_fused_and_db_paths_match_jax_fingerprint_batch():
    n = 1 << 18
    mat = np.zeros((2, n), np.float32)
    a = synth_song(3, 5.0, seed=21).astype(np.float32)
    b = synth_song(4, 3.0, seed=21).astype(np.float32)
    mat[0, : len(a)], mat[1, : len(b)] = a, b
    nv = np.array([len(a), len(b)], np.int32)
    jfp = jax_fingerprint_batch(jnp.asarray(mat), jnp.asarray(nv),
                                peak_capacity=2048)
    x, nvt = torch.from_numpy(mat), torch.from_numpy(nv)
    fused = fingerprint_batch_fused(x, nvt, peak_capacity=2048)
    db = fingerprint_batch(x, nvt, peak_capacity=2048)
    for row in range(2):
        ref = _pair_set(jfp, row)
        assert len(ref) > 300
        assert _jaccard(_pair_set(fused, row), ref) > 0.98
        assert _jaccard(_pair_set(db, row), ref) > 0.98
    assert fused.hi.shape == (2, 4 * 2048) and fused.valid.dtype == torch.bool


def test_fingerprint_matches_oracle(short_clip):
    from tests.oracle import oracle_fingerprint

    fp = fingerprint(short_clip, device="cpu")
    assert int(fp.n_peaks) <= 8192
    ours = set(fingerprint_to_hex_pairs(fp))
    ref = set(oracle_fingerprint(short_clip))
    assert _jaccard(ours, ref) > 0.98


def test_dense_comb_needs_no_group_cap():
    """Ten distinct maxima in one 128-bin group: the JAX fused kernel's
    GROUP_CAP=8 flags this song, the port's bit mask keeps every peak and
    equals the exact JAX XLA path."""
    rng = np.random.default_rng(5)
    n = 1 << 18
    t = np.arange(n, dtype=np.float64)
    sig = rng.normal(0, 3.0, n)
    env = np.exp(-0.5 * ((t % (30 * 2048) - 2048.0) / 1200.0) ** 2)
    for j in range(10):
        f_bin = 768 + 6 + 13 * j
        sig += env * (6000 + 700 * j) * np.sin(
            2 * np.pi * (f_bin * 44100 / 4096) * t / 44100)
    mat = sig.astype(np.float32)[None, :]
    jfp = jax_fingerprint_batch(jnp.asarray(mat), jnp.asarray([n], np.int32),
                                peak_capacity=8192)
    fp = fingerprint_batch_fused(torch.from_numpy(mat),
                                 torch.tensor([n]), peak_capacity=8192)
    assert int(fp.n_peaks[0]) == int(jfp.n_peaks[0]) <= 8192
    assert _pair_set(fp, 0) == _pair_set(jfp, 0)


@pytest.fixture(scope="module")
def catalog():
    """Four 8 s songs fingerprinted by the JAX XLA path, indexed by both."""
    from shazam_tpu.index.store import build_index
    from shazam_tpu.ops.fingerprint import fingerprints_to_pairs
    from shazam_tpu_torch.index.store import from_numpy

    n = 1 << 19
    mat = np.zeros((4, n), np.float32)
    for i in range(4):
        s = synth_song(i, 8.0, seed=31)
        mat[i, : len(s)] = s
    nv = np.full(4, int(8.0 * 44100), np.int32)
    fp = jax_fingerprint_batch(jnp.asarray(mat), jnp.asarray(nv),
                               peak_capacity=4096)
    entries = []
    for i in range(4):
        one = type(fp)(*(np.asarray(a)[i] for a in fp))
        entries.append((i + 1, *fingerprints_to_pairs(one)))
    jix = build_index(entries, n_songs=5)
    tix = from_numpy(jix.key_hi, jix.key_lo, jix.key_ex, jix.song_id,
                     jix.offset, jix.n_songs, jix.max_offset)
    return mat, jix, tix


@pytest.mark.parametrize("song,start,cap", [(2, 50, 16384), (3, 90, 64)])
def test_recognize_fingerprints_matches_jax(catalog, song, start, cap):
    from shazam_tpu.match.ondevice import recognize_on_device as jax_recognize
    from shazam_tpu_torch.match.lookup import raw_to_host
    from shazam_tpu_torch.match.ondevice import recognize_fingerprints

    mat, jix, tix = catalog
    clip = np.zeros((1, 1 << 18), np.float32)
    piece = mat[song - 1, start * 2048: start * 2048 + 4 * 44100]
    clip[0, : len(piece)] = piece
    nv = np.array([len(piece)], np.int32)
    kw = dict(n_songs=5, delta_min=-1024, delta_range=1024 + 4096,
              match_capacity=cap, topn=2, query_capacity=2048)
    jraw, jn_pairs, jn_peaks, jn_hash = jax_recognize(
        jnp.asarray(clip), jnp.asarray(nv), jix.device_arrays(),
        peak_capacity=4096, offset_stride=jix.offset_stride,
        use_fused=False, **kw)
    # the same fingerprints, handed to the port
    jfp = jax_fingerprint_batch(jnp.asarray(clip), jnp.asarray(nv),
                                peak_capacity=4096)
    fp = Fingerprints(*(torch.from_numpy(np.asarray(a).astype(
        bool if a.dtype == jnp.bool_ else np.int64)) for a in jfp))
    raw, n_pairs, n_peaks, n_hash = recognize_fingerprints(
        fp, tix.device_arrays("cpu"), **kw)
    raw, extra = raw_to_host(raw, n_pairs, n_peaks, n_hash)
    assert extra == [int(jn_pairs), int(jn_peaks), int(jn_hash)]
    for field, got, want in zip(raw._fields, raw, jraw):
        assert np.array_equal(np.asarray(got), np.asarray(want)), field
    if cap == 16384:
        assert raw.top_songs[0] == song and raw.top_deltas[0] == start
    else:
        assert raw.n_dropped > 0
