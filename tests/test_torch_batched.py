"""Port parity for batched recognition: ``SIA.recognize_batch`` and
``match/batched.py`` against the port's ``recognize_samples`` and the JAX
package's ``recognize_batch``.

Mirrors ``tests/test_batched.py`` (less the spanned, head and apriori
cases, which have no port yet) on a 10 x 8 s seeded corpus with 4 s
clips: batch == single, empty, pad_to_pow2, per-clip escalation with a
tiny ``match_capacity``, the whole-batch re-dispatch when most clips
clamp, sparse == dense, a capacity override, and on a "big" index
(``bounds_probe_min_rows=1``) the decided-first policy, with and without
an accepted clamp (the latter against the JAX package's bounds-first
batch). Each case compares every clip's song, offset, total matches and
input hashes with both references.
"""

import dataclasses

import numpy as np
import pytest
import torch

from shazam_tpu_torch.api import SIA
from shazam_tpu_torch.audio import synth_song
from shazam_tpu_torch.config import FingerprintConfig
from shazam_tpu_torch.match.tiers import match_tiers

FS = 44100
N_SONGS, SONG_S, CLIP_S = 10, 8.0, 4.0
TIGHT = dict(match_capacity=64, match_capacity_fast=64,
             match_capacity_max=4096)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs files in parallel worker processes: torch's CPU ops
    here use one thread so that the workers do not oversubscribe cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _song(i):
    return synth_song(i, SONG_S, seed=11)


def _clips(ids, shift=0):
    """A CLIP_S clip of each song, cut at a frame-aligned offset."""
    out = []
    for k, i in enumerate(ids):
        start = (1 + (i + k + shift) % 3) * 21 * 2048
        out.append(_song(i)[start: start + int(CLIP_S * FS)])
    return out


def _pair(n_songs=N_SONGS, **cfg):
    """The port (CPU) and the JAX package over the same songs and config."""
    from shazam_tpu.api import SIA as JaxSIA
    from shazam_tpu.config import FingerprintConfig as JaxConfig

    songs = [(f"track{i:06d}", _song(i)) for i in range(n_songs)]
    port = SIA(FingerprintConfig(**cfg), device="cpu")
    port.ingest_arrays(songs, batch_size=5)
    ref = JaxSIA(JaxConfig(**cfg))
    ref.ingest_arrays(songs, batch_size=5)
    return port, ref


@pytest.fixture(scope="module")
def engines():
    return _pair()


@pytest.fixture(scope="module")
def tight():
    return _pair(3, **TIGHT)


def _key(res):
    top = res["results"][0] if res["results"] else {}
    return (top.get("song_id"), top.get("offset"), res["total_matches"],
            res["input_hashes"])


def _check(port, ref, clips, topn=2, **kw):
    """Each clip's batch answer equals the port's solo answer and the JAX
    package's batch answer; returns the port's batch and solo answers."""
    got = port.recognize_batch(clips, topn=topn, **kw)
    want = ref.recognize_batch(clips, topn=topn, **kw)
    assert len(got) == len(want) == len(clips)
    solos = [port.recognize_samples([clip], topn=topn) for clip in clips]
    for g, solo, w in zip(got, solos, want):
        assert _key(g) == _key(solo) == _key(w)
        # the batch dispatches at the JAX batch's tier, so its counts are
        # the JAX batch's; no clip here is decided under clamps that differ
        # between the batch and the solo ladder, so they are the solo ones
        assert _triples(g) == _triples(w) == _triples(solo)
        assert g["partial_counts"] == solo["partial_counts"]
        assert g["batch_size"] == len(clips)
    return got, solos


def _triples(res):
    return [(r["song_id"], r["offset"], r["hashes_matched_in_input"])
            for r in res["results"]]


def test_batched_matches_single(engines):
    port, ref = engines
    clips = _clips(range(N_SONGS))
    got, solos = _check(port, ref, clips, topn=3)
    for i, (g, solo) in enumerate(zip(got, solos)):
        assert g["results"][0]["song_name"] == f"track{i:06d}"
        assert _triples(g) == _triples(solo)
        assert g["batch_query_time"] >= 0 and g["align_time"] >= 0


def test_batched_empty():
    assert SIA(device="cpu").recognize_batch([]) == []
    assert SIA(device="cpu").prepare_batch([]) is None


def test_batched_pad_to_pow2(engines):
    """Empty rows pad the batch to a power of two; no real clip's result
    changes and exactly one output per clip comes back. Mixed clip
    lengths share one bucket."""
    port, ref = engines
    clips = _clips(range(3))
    clips[1] = _song(1)[: int(7.5 * FS)]
    plain = port.recognize_batch(clips, topn=3)
    padded, _ = _check(port, ref, clips, topn=3, pad_to_pow2=True)
    pb = port.prepare_batch(clips, pad_to_pow2=True)
    assert len(pb.queries) == 4 and pb.queries[3].n_pairs == 0
    for a, b in zip(plain, padded):
        assert a["results"] == b["results"]
        assert a["total_matches"] == b["total_matches"]
        assert b["batch_size"] == 3


def test_batched_overflow_escalates(tight):
    """Mirrors test_batched.py:67: a clip past the base tier re-runs alone
    from the tier its total fits; results equal recognize_samples."""
    port, ref = tight
    clip = _clips([1])[0]
    (out,), (single,) = _check(port, ref, [clip])
    assert single["total_matches"] > 64
    assert not out["overflowed"]
    assert _triples(out) == _triples(single)


def _counting(monkeypatch, port):
    """Count batched dispatches and solo retries of ``port``."""
    from shazam_tpu_torch import api

    calls = {"batch": 0, "solo": 0}
    batched, solo = api.match_queries_batched, port._match_prepared

    def count_batch(*a, **kw):
        calls["batch"] += 1
        return batched(*a, **kw)

    def count_solo(*a, **kw):
        calls["solo"] += 1
        return solo(*a, **kw)

    monkeypatch.setattr(api, "match_queries_batched", count_batch)
    monkeypatch.setattr(port, "_match_prepared", count_solo)
    return calls


def _batch_caps(monkeypatch):
    """The capacity of every batched dispatch the api makes."""
    from shazam_tpu_torch import api

    caps = []
    real = api.match_queries_batched

    def spy(*a, **kw):
        caps.append(kw["match_capacity"])
        return real(*a, **kw)

    monkeypatch.setattr(api, "match_queries_batched", spy)
    return caps


def test_batched_base_tier_is_match_capacity(engines, monkeypatch):
    """The batch starts at match_capacity, as the JAX batch does, not at
    the solo ladder's fast tier: clips whose totals lie between the two
    fit in one dispatch with exact counts, where recognize_samples clamps
    at the fast tier and reports lower bounds (or escalates)."""
    port, ref = engines
    clips = _clips(range(3))
    kw = dict(match_capacity=8192, match_capacity_fast=64)
    base_p, base_r = port.config, ref.config
    try:
        port.config = dataclasses.replace(base_p, **kw)
        ref.config = dataclasses.replace(base_r, **kw)
        calls = _counting(monkeypatch, port)
        got = port.recognize_batch(clips, topn=2)
        assert calls == {"batch": 1, "solo": 0}
        monkeypatch.undo()
        want = ref.recognize_batch(clips, topn=2)
        solos = [port.recognize_samples([clip], topn=2) for clip in clips]
    finally:
        port.config, ref.config = base_p, base_r
    for g, solo, w in zip(got, solos, want):
        assert 64 < g["total_matches"] <= 8192
        assert _key(g) == _key(solo) == _key(w)
        assert _triples(g) == _triples(w)
        assert not g["partial_counts"] and not g["overflowed"]
        for a, b in zip(_triples(solo), _triples(g)):
            assert a[:2] == b[:2]
            assert a[2] <= b[2] if solo["partial_counts"] else a[2] == b[2]


def test_batched_mass_overflow_redispatches_whole_batch(tight, monkeypatch):
    """Mirrors test_batched.py:96: when most clips clamp, one whole-batch
    dispatch at the fitting tier replaces the solo retries."""
    port, ref = tight
    clips = _clips(range(3))
    calls = _counting(monkeypatch, port)
    outs = port.recognize_batch(clips, topn=2)
    assert calls == {"batch": 2, "solo": 0}
    monkeypatch.undo()
    want = ref.recognize_batch(clips, topn=2)
    for clip, out, w in zip(clips, outs, want):
        single = port.recognize_samples([clip], topn=2)
        assert single["total_matches"] > 64
        assert not out["overflowed"]
        assert _key(out) == _key(single) == _key(w)
        assert _triples(out) == _triples(single)


def _random_world(seed=7, n=50_000, n_songs=300, stride=512):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << 10, n, dtype=np.uint32)
    lo = rng.integers(0, 1 << 4, n, dtype=np.uint32)
    ex = rng.integers(0, 1 << 2, n, dtype=np.uint32)
    sid = rng.integers(0, n_songs, n, dtype=np.uint32)
    off = rng.integers(0, 500, n, dtype=np.uint32)
    key = (hi.astype(np.uint64) << 40 | lo.astype(np.uint64) << 36
           | ex.astype(np.uint64) << 34 | sid.astype(np.uint64) << 16 | off)
    _, keep = np.unique(key, return_index=True)
    cols = [a[keep] for a in (hi, lo, ex, sid, off)]
    order = np.lexsort(cols[::-1])
    return [a[order] for a in cols], rng


@pytest.mark.parametrize("expand_block", [0, 128])
@pytest.mark.parametrize("cap", [16384, 512])
def test_batched_sparse_equals_dense(expand_block, cap):
    """Mirrors test_batched.py:127: the batched sort rank equals the
    batched dense one, every row equals the solo matcher on that query
    alone, and unclamped row-by-row rows equal the JAX package's batch."""
    import jax.numpy as jnp

    from shazam_tpu.match.batched import match_queries_batched as jmqb
    from shazam_tpu.match.batched import query_totals_batched as jqtb
    from shazam_tpu_torch.index import store
    from shazam_tpu_torch.match import batched, lookup

    (hi, lo, ex, sid, off), rng = _random_world()
    ix = store.from_numpy(hi, lo, ex, sid, off, 300, int(off.max()))
    dev = ix.device_arrays("cpu")
    Bq, Q = 3, 256
    qi = rng.integers(0, len(hi), (Bq, Q))
    q_np = (hi[qi], lo[qi], ex[qi],
            rng.integers(0, 100, (Bq, Q)).astype(np.uint32),
            rng.random((Bq, Q)) < 0.9, np.ones((Bq, Q), bool))
    q = [torch.from_numpy(a.astype(np.int64) if a.dtype != bool else a)
         for a in q_np]
    kw = dict(n_songs=300, delta_min=-128, delta_range=768,
              match_capacity=cap, topn=2)
    dense = batched.match_queries_batched(dev, *q, rank="dense", **kw)
    sparse = batched.match_queries_batched(
        dev, *q, rank="sort", expand_block=expand_block, expand_runs=64,
        **kw)
    rank = "sort" if expand_block else "dense"
    for r in range(Bq):
        solo = lookup.match_by_rank(dev, *(a[r] for a in q), rank=rank,
                                    expand_block=expand_block,
                                    expand_runs=64, **kw)
        for a, b in zip(sparse if expand_block else dense, solo):
            assert np.array_equal(np.asarray(a[r]), np.asarray(b))
    if not expand_block:
        for a, b in zip(sparse, dense):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    stride = 512
    jcols = tuple(jnp.asarray(a) for a in (hi, lo, ex))
    jcols += (jnp.asarray(sid * np.uint32(stride) + off),)
    if cap == 16384 and not expand_block:   # no clamp, no run budget
        want = jmqb(jcols, *(jnp.asarray(a) for a in q_np), sparse=True,
                    offset_stride=stride, **kw)
        for a, b in zip(sparse, want):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    # each clip's total_rows is its exact total, clamped or not: the JAX
    # package's batched probe
    totals, lb, _ub = jqtb(jcols, *(jnp.asarray(q_np[i]) for i in (0, 1, 2,
                                                                   4)))
    assert np.array_equal(np.asarray(totals), sparse.total_rows.numpy())
    assert np.array_equal(np.asarray(totals), dense.total_rows.numpy())
    assert lb.shape == (Bq, Q)


def test_batched_capacity_override_identical(engines):
    """Mirrors test_batched.py:223: a larger base tier gives the same
    results."""
    port, ref = engines
    clips = _clips([0, 2])
    base = port.recognize_batch(clips, topn=2)
    hi, _ = _check(port, ref, clips,
                   match_capacity=4 * port.config.match_capacity)
    for a, b in zip(base, hi):
        assert a["results"] == b["results"]
        assert a["total_matches"] == b["total_matches"]


@pytest.mark.parametrize("policy", ["decide", "bounds"])
@pytest.mark.parametrize("tiers", ["default", "tight"])
def test_batched_big_index_policies(engines, monkeypatch, policy, tiers):
    """Decided-first on a 'big' index (every index is, at
    bounds_probe_min_rows=1; sparse ranks from 0 vote bins), its first
    batch dispatch at the decide tier: every clip answers as
    recognize_samples and the JAX batch do, and with no clamp accepted
    (the port's path in place of bounds-first) as the JAX package's
    bounds-first batch; tight tiers make the clips clamp, be decided or
    escalate."""
    port, ref = engines
    kw = dict(bounds_probe_min_rows=1, sparse_vote_threshold=0,
              escalation_policy=policy)
    if tiers == "tight":
        kw.update(match_capacity=128, match_capacity_fast=64,
                  match_capacity_max=1 << 16)
    port_kw = dict(kw, escalation_policy="auto",
                   decision_escalation=policy == "decide")
    base_p, base_r = port.config, ref.config
    try:
        port.config = dataclasses.replace(base_p, **port_kw)
        ref.config = dataclasses.replace(base_r, **kw)
        decide_cap = port.decide.cap(port.config,
                                     match_tiers(port.config))
        caps = _batch_caps(monkeypatch)
        _check(port, ref, _clips(range(4), shift=1))
        assert caps[0] == decide_cap
    finally:
        port.config, ref.config = base_p, base_r
