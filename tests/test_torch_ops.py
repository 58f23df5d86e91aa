"""Port parity, hashing stages: config, synth, SHA-1, fan-out pairing.

The same seeded numpy inputs go through ``shazam_tpu`` (JAX on the CPU)
and ``shazam_tpu_torch`` (PyTorch, plain CPU path); results must be
bit-equal.
"""

import dataclasses
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shazam_tpu.config import FingerprintConfig as JaxConfig
from shazam_tpu_torch.config import FingerprintConfig


def test_config_matches_jax_package():
    # every knob the port reads has the JAX package's name and default
    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(FingerprintConfig)}
    assert tf == {k: jf[k] for k in tf}
    cfg = JaxConfig(amp_min=12.0, fan_value=7, overlap_ratio=0.25)
    port = FingerprintConfig(**{k: getattr(cfg, k) for k in tf})
    assert port.hop == cfg.hop == 3072
    assert port.frames_to_seconds(77) == cfg.frames_to_seconds(77)
    for bad in ({"window_size": 3000}, {"overlap_ratio": 1.0},
                {"fan_value": 0}):
        with pytest.raises(ValueError):
            FingerprintConfig(**bad)


@pytest.mark.parametrize("song_id,seconds,seed", [(0, 1.0, 3), (7, 2.5, 99)])
def test_synth_song_matches_jax_package(song_id, seconds, seed):
    from shazam_tpu.audio.synth import synth_song as jax_synth
    from shazam_tpu_torch.audio import synth_song

    assert np.array_equal(synth_song(song_id, seconds, seed=seed),
                          jax_synth(song_id, seconds, seed=seed))


def _triples(rng, n):
    f1 = rng.integers(0, 10000, n)
    f2 = rng.integers(0, 10000, n)
    dt = rng.integers(0, 10000, n)
    # every digit-count boundary
    edge = np.array([0, 9, 10, 99, 100, 999, 1000, 9999])
    f1[:8], f2[8:16], dt[16:24] = edge, edge, edge
    return f1, f2, dt


def test_sha1_keys_match_hashlib_and_jax():
    from shazam_tpu.ops.sha1 import sha1_fingerprint_keys as jax_sha1
    from shazam_tpu_torch.ops.sha1 import keys_to_hex, sha1_fingerprint_keys

    f1, f2, dt = _triples(np.random.default_rng(20260816), 4096)
    hi, lo, ex = sha1_fingerprint_keys(
        *(torch.from_numpy(v) for v in (f1, f2, dt)))
    got = keys_to_hex(hi.numpy(), lo.numpy(), ex.numpy())
    want = [hashlib.sha1(f"{a}|{b}|{c}".encode()).hexdigest()[:20]
            for a, b, c in zip(f1, f2, dt)]
    assert got == want
    jk = jax_sha1(*(jnp.asarray(v, jnp.uint32) for v in (f1, f2, dt)))
    for t, j in zip((hi, lo, ex), jk):
        assert np.array_equal(t.numpy(), np.asarray(j).astype(np.int64))


@pytest.mark.parametrize("fan,min_dt,max_dt,n_peaks", [
    (5, 0, 200, 700),     # reference defaults, partly filled capacity
    (3, 2, 40, 1024),     # narrow window, full capacity
    (7, 0, 9999, 5),      # fan wider than the peak count
])
def test_generate_hashes_matches_jax(fan, min_dt, max_dt, n_peaks):
    from shazam_tpu.ops.hashes import generate_hashes as jax_hashes
    from shazam_tpu_torch.ops.hashes import generate_hashes

    cap = 1024
    rng = np.random.default_rng(fan)
    times = np.sort(rng.integers(0, 2000, cap)).astype(np.uint32)
    freqs = rng.integers(0, 2049, cap).astype(np.uint32)
    got = generate_hashes(torch.from_numpy(times.astype(np.int64)),
                          torch.from_numpy(freqs.astype(np.int64)),
                          torch.tensor(n_peaks), fan_value=fan,
                          min_dt=min_dt, max_dt=max_dt)
    want = jax_hashes(jnp.asarray(times), jnp.asarray(freqs),
                      jnp.uint32(n_peaks), fan_value=fan, min_dt=min_dt,
                      max_dt=max_dt)
    for g, w in zip(got, want):  # every lane, masked or not
        assert np.array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))
    assert got[4].sum() > 0


def test_generate_hashes_rejects_wide_dt():
    from shazam_tpu_torch.ops.hashes import generate_hashes

    z = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError):
        generate_hashes(z, z, torch.tensor(4), max_dt=10000)
