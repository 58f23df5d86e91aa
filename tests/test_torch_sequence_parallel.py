"""The port's sequence-parallel fingerprint (``parallel/sequence.py``)
against its single-device pipeline and the JAX package's, at the same
shard count.

One spawn of 4 gloo ranks (``test_torch_sharding.spawn_ranks``) runs every
case at world sizes 1, 2 and 4: the halo ring over ``batch_isend_irecv``
(none at world size 1), the peak gather and the summed overflow flag.
Mirrors ``tests/test_sequence_parallel.py``: equality with the
single-device fingerprint, the overflow signal of a dense shard, and the
refusal of a chunk shorter than its halo.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_sharding import WORLDS, cpu_meshes, spawn_ranks

HOP = 2048


def _padded(samples, n_dev):
    blen = -(-len(samples) // (n_dev * HOP)) * (n_dev * HOP)
    out = np.zeros(blen, np.float32)
    out[: len(samples)] = samples
    return out


def _fp_host(fp):
    v = fp.valid.numpy()
    return (int(fp.n_peaks), fp.hi.numpy()[v], fp.lo.numpy()[v],
            fp.t1.numpy()[v])


def _ranks_work(rank, world, song, dense):
    from shazam_tpu_torch.ops.fingerprint import fingerprint_samples
    from shazam_tpu_torch.parallel.sequence import \
        sequence_parallel_fingerprint

    out = {}
    for n, mesh in cpu_meshes(rank, WORLDS).items():
        if mesh is None:
            continue
        padded = _padded(song, n)
        seq = sequence_parallel_fingerprint(mesh, padded, len(song),
                                            peak_capacity=4096)
        ref = fingerprint_samples(torch.from_numpy(padded), len(song),
                                  peak_capacity=4096)
        out[("song", n)] = (all(torch.equal(a, b) for a, b in zip(seq, ref)),
                            _fp_host(seq))
        seq = sequence_parallel_fingerprint(mesh, dense, len(dense),
                                            peak_capacity=64)
        out[("dense", n)] = int(seq.n_peaks)
        try:
            sequence_parallel_fingerprint(
                mesh, np.zeros(n * HOP * 9, np.float32), n * HOP * 9)
        except ValueError as e:
            out[("short", n)] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from shazam_tpu_torch.audio import synth_song

    song = synth_song(4, 6.0, seed=17).astype(np.float32)
    rng = np.random.default_rng(3)
    dense = np.zeros(8 * HOP * 16, np.float32)
    # loud wideband noise confined to the first eighth of the signal
    dense[: len(dense) // 8] = rng.normal(0, 8000, len(dense) // 8)
    port = spawn_ranks(_ranks_work, 4, tmp_path_factory.mktemp("ranks"),
                       song, dense)
    return song, dense, port


def _jax_seq(samples, n_valid, n, cap):
    import jax.numpy as jnp
    from shazam_tpu.parallel.mesh import make_mesh
    from shazam_tpu.parallel.sequence import sequence_parallel_fingerprint

    return sequence_parallel_fingerprint(make_mesh(n), jnp.asarray(samples),
                                         n_valid, peak_capacity=cap)


def _pairs(hi, lo, t1):
    return set(zip(np.asarray(hi).tolist(), np.asarray(lo).tolist(),
                   np.asarray(t1).tolist()))


@pytest.mark.parametrize("n", WORLDS)
def test_sequence_parallel_matches_single(ranks, n):
    """Every rank's result equals the port's single-device fingerprint
    exactly; against the JAX package's sequence-parallel result at the
    same shard count the hash sets agree (jaccard > 0.98) and so do the
    peak counts."""
    song, _, port = ranks
    want = _jax_seq(_padded(song, n), len(song), n, 4096)
    wv = np.asarray(want.valid)
    theirs = _pairs(np.asarray(want.hi)[wv], np.asarray(want.lo)[wv],
                    np.asarray(want.t1)[wv])
    for r in range(n):
        exact, (n_peaks, hi, lo, t1) = port[r][("song", n)]
        assert exact, (n, r)
        ours = _pairs(hi, lo, t1)
        assert len(ours) > 100
        assert len(ours & theirs) / len(ours | theirs) > 0.98
        assert n_peaks == int(want.n_peaks)


@pytest.mark.parametrize("n", WORLDS)
def test_sequence_parallel_peak_overflow_detected(ranks, n):
    """A dense region that blows one shard's peak quota reports n_peaks >
    peak_capacity on every rank (never a silent drop), as the JAX
    package's does at 4 shards (one JAX compile: the JAX test's claim)."""
    _, dense, port = ranks
    if n == 4:
        assert int(_jax_seq(dense, len(dense), n, 64).n_peaks) > 64
    for r in range(n):
        assert port[r][("dense", n)] > 64


@pytest.mark.parametrize("n", WORLDS)
def test_sequence_parallel_short_input_raises(ranks, n):
    _, _, port = ranks
    for r in range(n):
        assert "too short" in port[r][("short", n)]
