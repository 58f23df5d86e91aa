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
                {"fan_value": 0}, {"vote_rank": "dense"},
                {"escalation_policy": "probe"}):
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


def _lanes_by_hand(times, freqs, n, fan, min_dt, max_dt):
    """Per lane (j-major), straight from the reference's rule: the anchor
    time, whether the pair is kept, and its key where it is."""
    cap = len(times)
    out = []
    for j in range(1, fan):
        for i in range(cap):
            ok = i + j < min(n, cap)
            dt = int(times[i + j] - times[i]) if ok else 0
            keep = ok and min_dt <= dt <= max_dt
            key = (hashlib.sha1(f"{freqs[i]}|{freqs[i + j]}|{dt}".encode())
                   .hexdigest()[:20] if keep else None)
            out.append((int(times[i]), keep, key))
    return out


@pytest.mark.parametrize("cap,fan,n,min_dt,max_dt", [
    (40, 5, 33, 0, 200),
    (4, 5, 4, 0, 200),      # cap = fan - 1
    (2, 5, 2, 0, 9999),     # cap below fan - 1: targets past cap read 0
    (1, 3, 5, 0, 200),      # one slot, count past it
    (30, 2, 30, 3, 5),
])
def test_generate_hashes_plain_matches_the_rule(cap, fan, n, min_dt, max_dt):
    from shazam_tpu_torch.ops.hashes import generate_hashes_plain
    from shazam_tpu_torch.ops.sha1 import keys_to_hex

    rng = np.random.default_rng(cap + fan)
    times = np.sort(rng.integers(0, 60, cap))
    freqs = rng.integers(0, 2049, cap)
    hi, lo, ex, t1, valid = generate_hashes_plain(
        torch.from_numpy(times), torch.from_numpy(freqs), torch.tensor(n),
        fan, min_dt, max_dt)
    keys = keys_to_hex(hi.numpy(), lo.numpy(), ex.numpy())
    got = [(int(t), bool(v), k if v else None)
           for t, v, k in zip(t1.tolist(), valid.tolist(), keys)]
    assert got == _lanes_by_hand(times, freqs, n, fan, min_dt, max_dt)


@pytest.mark.parametrize("shape", ["one_dim", "batch", "int32"])
def test_generate_hashes_on_cpu_takes_the_twin(shape):
    """CPU tensors run the plain twin and never reach the kernel."""
    from shazam_tpu_torch.ops.cuda import sha1
    from shazam_tpu_torch.ops.hashes import (generate_hashes,
                                             generate_hashes_plain)

    rng = np.random.default_rng(len(shape))
    rows = 1 if shape == "one_dim" else 3
    times = torch.from_numpy(np.sort(rng.integers(0, 900, (rows, 256)), -1))
    freqs = torch.from_numpy(rng.integers(0, 2049, (rows, 256)))
    n = torch.tensor([200, 256, 0][:rows])
    if shape == "one_dim":
        times, freqs, n = times[0], freqs[0], n[0]
    elif shape == "int32":
        times, freqs, n = (x.to(torch.int32) for x in (times, freqs, n))
    before = sha1.KERNEL.launches
    got = generate_hashes(times, freqs, n, fan_value=4, min_dt=1, max_dt=90)
    want = generate_hashes_plain(times, freqs, n, 4, 1, 90)
    assert sha1.KERNEL.launches == before == 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got[0].shape == (*times.shape[:-1], 3 * 256)


@pytest.mark.parametrize("case,match", [
    ("float", "int32 or int64"),
    ("shapes", "shape"),
    ("n_peaks_shape", "shape"),
    ("fan1", "fan_value"),
    ("wide_dt", "max_dt"),
    ("cpu", "CUDA"),
])
def test_pair_hashes_checks_before_any_launch(monkeypatch, case, match):
    """The wrapper's checks raise before the kernel is reached (the
    stand-in below fails the test if it is)."""
    from shazam_tpu_torch.ops.cuda import sha1

    def launched(*args, **kwargs):
        raise AssertionError("the kernel was reached")

    monkeypatch.setattr(sha1, "KERNEL", launched)
    times = torch.zeros((2, 64), dtype=torch.int32)
    freqs, n, kw = times.clone(), torch.zeros(2, dtype=torch.int32), {}
    if case == "float":
        times = times.float()
    elif case == "shapes":
        freqs = freqs[:, :32].contiguous()
    elif case == "n_peaks_shape":
        n = n[:1]
    elif case == "fan1":
        kw = {"fan_value": 1}
    elif case == "wide_dt":
        kw = {"max_dt": 10000}
    with pytest.raises(ValueError, match=match):
        sha1.pair_hashes(times, freqs, n, **kw)


def test_hash_span_names_the_path_and_its_lanes():
    from torch.profiler import ProfilerActivity, profile

    from shazam_tpu_torch import profiling
    from shazam_tpu_torch.ops.fingerprint import fingerprint_batch_fused

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 1 << 16)).astype(np.float32))
    nv = torch.tensor([1 << 16, 40000])
    mark = max((r.index for r in profiling.span_records()), default=-1)
    with profile(activities=[ProfilerActivity.CPU]):
        fp = fingerprint_batch_fused(x, nv, peak_capacity=512)
    (rec,) = [r for r in profiling.span_records()
              if r.index > mark and r.name == "fp.hash"]
    assert rec.attrs == {"impl": "torch", "lanes": 2 * 4 * 512}
    assert fp.hi.shape == (2, 4 * 512)
