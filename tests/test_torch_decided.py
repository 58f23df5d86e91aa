"""Port parity, the provably-exact early accept and the big-index
escalation ladder (decided-first).

Mirrors ``tests/test_decided.py`` on the port and holds each result
against the JAX package's on the same inputs:

- the whole-run budget of the row-by-row expansion (shortest first,
  exact n_dropped and total);
- soundness: a clamped result that is decided has the full expansion's
  top-1 song and delta (randomized);
- the api accepts decided clamps in one dispatch, escalates undecided
  ones, and with decision_escalation off always escalates;
- decided-first answers as the JAX package's; with no clamp accepted
  (the port's path in place of the JAX package's bounds-first) it gives
  the JAX bounds-first dict exactly, probe or not;
- the self-tuning decide tier (``match/tiers.DecideTier``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shazam_tpu.match import lookup as jl
from shazam_tpu_torch.api import SIA
from shazam_tpu_torch.audio import synth_song
from shazam_tpu_torch.config import FingerprintConfig
from shazam_tpu_torch.match import lookup as tl
from shazam_tpu_torch.match import tiers

TIMING = ("fingerprint_time", "query_time", "align_time", "total_time")
# tiers 64, 128, 512, ...: a 5 s clip's 100-250 rows clamp both the fast
# and the decide tier
TIGHT = dict(match_capacity=128, match_capacity_fast=64,
             match_capacity_max=1 << 16)
BIG = dict(TIGHT, bounds_probe_min_rows=1, sparse_vote_threshold=0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs files in parallel worker processes: torch's CPU ops
    here use one thread so that the workers do not oversubscribe cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a if a.dtype == bool else a.astype(np.int64))


def _world(seed, n_rows, n_songs, n_pairs, max_off=3000, q_lanes=64,
           plant=False):
    """A JAX and a port device index over few keys (long runs) with
    distinct (song, offset) per key, and query lanes hitting them; with
    ``plant``, lanes taken from song 0's rows at one delta (10)."""
    from shazam_tpu.index import store as jstore
    from shazam_tpu_torch.index import store

    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 50, n_rows, dtype=np.uint32)
    lo = rng.integers(0, 4, n_rows, dtype=np.uint32)
    ex = np.zeros(n_rows, np.uint32)
    sid = rng.integers(0, n_songs, n_rows, dtype=np.uint32)
    off = rng.integers(0, max_off, n_rows, dtype=np.uint32)
    key = ((hi.astype(np.uint64) << 40) | (lo.astype(np.uint64) << 32)
           | (sid.astype(np.uint64) << 16) | off)
    _, keep = np.unique(key, return_index=True)
    cols = [a[keep] for a in (hi, lo, ex, sid, off)]
    order = np.lexsort(cols[::-1])
    cols = [a[order] for a in cols]
    jix = jstore.FingerprintIndex(*cols, n_songs=n_songs,
                                  max_offset=int(cols[4].max()))
    tix = store.from_numpy(*cols, n_songs, int(cols[4].max()))

    if plant:
        own = np.flatnonzero((cols[3] == 0) & (cols[4] >= 10))
        pick = rng.choice(own, n_pairs, replace=False)
    else:
        pick = rng.integers(0, len(cols[0]), n_pairs)
    q = [np.zeros(q_lanes, np.uint32) for _ in range(4)]
    q[0][:n_pairs], q[1][:n_pairs] = cols[0][pick], cols[1][pick]
    q[3][:n_pairs] = (cols[4][pick] - 10 if plant
                      else rng.integers(0, 50, n_pairs))
    valid = np.arange(q_lanes) < n_pairs
    first = np.zeros(q_lanes, bool)
    seen = set()
    for i in range(n_pairs):
        k = (int(q[0][i]), int(q[1][i]))
        first[i] = k not in seen
        seen.add(k)
    return jix, tix, (*q, valid, first)


def test_run_budget_invariants_match_jax():
    jix, tix, q = _world(0, 4000, 20, 40)
    cap = 256
    got = tl._expand(tix.device_arrays("cpu"), *(_t(a) for a in q[:5]),
                     match_capacity=cap)
    want = jax.device_get(jl._expand(
        jix.device_arrays(), *(jnp.asarray(a) for a in q[:5]),
        match_capacity=cap, offset_stride=jix.offset_stride))
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))

    # against run lengths counted on the host
    keys = list(zip(jix.key_hi.tolist(), jix.key_lo.tolist()))
    lens = np.array([keys.count((int(h), int(lo))) if v else 0
                     for h, lo, v in zip(q[0], q[1], q[4])])
    _sid, _delta, p, valid, total, n_dropped = got
    assert int(total) == lens.sum() > cap
    order = np.argsort(lens, kind="stable")
    included = np.cumsum(lens[order]) <= cap
    assert int(n_dropped) == int(((lens[order] > 0) & ~included).sum())
    counts = np.bincount(p[valid].numpy(), minlength=len(lens))
    assert int(valid.sum()) == lens[order][included].sum()
    assert all(c in (0, n) for c, n in zip(counts, lens))


@pytest.mark.parametrize("sparse", [False, True])
def test_decided_soundness_randomized_matches_jax(sparse):
    tmatch = tl.match_query_sparse if sparse else tl.match_query
    jmatch = jl.match_query_sparse if sparse else jl.match_query
    checked = decided = 0
    for seed in range(12):
        jix, tix, q = _world(seed, 3000, 12, 48, plant=seed % 2 == 0)
        kw = dict(n_songs=12, delta_min=-64, delta_range=3200, topn=2)
        tdev, tq = tix.device_arrays("cpu"), [_t(a) for a in q]
        small, _ = tl.raw_to_host(tmatch(tdev, *tq, match_capacity=512, **kw))
        want = jmatch(jix.device_arrays(), *(jnp.asarray(a) for a in q),
                      match_capacity=512, offset_stride=jix.offset_stride,
                      **kw)
        for field, g, w in zip(small._fields, small, want):
            assert np.array_equal(np.asarray(g), np.asarray(w)), (seed, field)
        if small.total_rows <= 512:
            continue
        checked += 1
        full_cap = 1 << int(np.ceil(np.log2(small.total_rows + 1)))
        full, _ = tl.raw_to_host(tmatch(tdev, *tq, match_capacity=full_cap,
                                        **kw))
        assert full.n_dropped == 0
        if small.top_votes[0] - small.runner_votes > small.n_dropped:
            decided += 1
            assert small.top_songs[0] == full.top_songs[0]
            assert small.top_deltas[0] == full.top_deltas[0]
    assert checked >= 6 and decided >= 1, (checked, decided)


@pytest.fixture(scope="module")
def corpus():
    return [(f"s{i}", synth_song(i, 6.0, seed=50 + i)) for i in range(6)]


def _strip(res):
    return {k: v for k, v in res.items() if k not in TIMING}


def _pair(corpus, port_cfg=None, **cfg):
    """The port's and the JAX package's SIA on one config (the port's on
    ``port_cfg`` where the JAX config names a path the port does not
    have) and corpus."""
    from shazam_tpu.api import SIA as JaxSIA
    from shazam_tpu.config import FingerprintConfig as JaxConfig

    port = SIA(config=FingerprintConfig(**(port_cfg or cfg)), device="cpu")
    ref = JaxSIA(config=JaxConfig(**cfg))
    for sia in (port, ref):
        sia.ingest_arrays(corpus)
    return port, ref


@pytest.fixture(scope="module")
def engines(corpus):
    return {
        "decided": _pair(corpus, **TIGHT),
        "exact": _pair(corpus, **TIGHT, decision_escalation=False),
        "auto": _pair(corpus, **BIG),
        # the JAX package's bounds-first, the port's decide-first with no
        # clamp accepted
        "bounds": _pair(corpus, dict(BIG, decision_escalation=False), **BIG,
                        escalation_policy="bounds"),
    }


def _count_calls(monkeypatch, *names):
    """Record (name, rank, match_capacity) of every call the api makes to
    the named functions of ``shazam_tpu_torch.api``."""
    import shazam_tpu_torch.api as api

    calls = []
    for name in names:
        real = getattr(api, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append((_name, k.get("rank"), k.get("match_capacity")))
            return _real(*a, **k)

        monkeypatch.setattr(api, name, spy)
    return calls


@pytest.mark.parametrize("song", [1, 3, 5])
def test_fast_tier_clamp_is_decided_or_escalates(engines, corpus, monkeypatch,
                                                  song):
    port, ref = engines["decided"]
    exact, _ = engines["exact"]
    clip = corpus[song][1][44100: 44100 * 5]
    calls = _count_calls(monkeypatch, "match_by_rank")
    got = port.recognize_samples([clip])
    assert _strip(got) == _strip(ref.recognize_samples([clip]))
    assert got["results"][0]["song_name"] == f"s{song}"
    assert got["total_matches"] > 64, "the fast tier must clamp"
    assert {c[1] for c in calls} == {"dense"}
    # decided at the fast tier: one dispatch; else one escalation
    assert len(calls) == (1 if got["partial_counts"] else 2)
    want = exact.recognize_samples([clip])["results"][0]
    top = got["results"][0]
    assert (top["song_id"], top["offset"]) == (want["song_id"],
                                               want["offset"])


@pytest.mark.parametrize("song", [0, 2])
def test_exact_mode_still_escalates(engines, corpus, monkeypatch, song):
    port, ref = engines["exact"]
    clip = corpus[song][1][44100: 44100 * 5]
    calls = _count_calls(monkeypatch, "match_by_rank")
    got = port.recognize_samples([clip])
    assert _strip(got) == _strip(ref.recognize_samples([clip]))
    assert got["results"][0]["song_name"] == f"s{song}"
    assert got["total_matches"] > 64 and not got["partial_counts"]
    assert len(calls) == 2 and calls[-1][2] >= got["total_matches"]


@pytest.mark.parametrize("song", [1, 3, 5])
def test_decide_first_matches_bounds_policy(engines, corpus, monkeypatch,
                                            song):
    """Decided-first dispatches first at the decide tier (128) and answers
    as the JAX package's; with no clamp accepted it answers as the JAX
    bounds-first policy, which probes the exact total first."""
    dec, ref = engines["auto"]
    bnd, jbnd = engines["bounds"]
    clip = corpus[song][1][44100: 44100 * 5]
    calls = _count_calls(monkeypatch, "match_by_rank")
    a = dec.recognize_samples([clip], topn=2)
    assert calls[0][2] == 128
    calls.clear()
    b = bnd.recognize_samples([clip], topn=2)
    assert calls[0][2] == 128
    assert len(calls) == (1 if b["total_matches"] <= 128 else 2)
    assert _strip(a) == _strip(ref.recognize_samples([clip], topn=2))
    assert _strip(b) == _strip(jbnd.recognize_samples([clip], topn=2))
    assert a["results"][0]["song_name"] == f"s{song}"
    assert ((a["results"][0]["offset"], a["total_matches"])
            == (b["results"][0]["offset"], b["total_matches"]))


@pytest.mark.parametrize("song", [0, 2, 4])
def test_forced_escalation_equals_bounds_policy(engines, corpus, monkeypatch,
                                                song):
    """Decided-first with the certificate forced to fail re-dispatches at
    the fitting tier with the bounds it kept: the bounds-first dict."""
    dec = SIA(config=FingerprintConfig(**BIG, escalation_policy="decide"),
              device="cpu")
    dec.ingest_arrays(corpus)
    monkeypatch.setattr(tiers, "decided", lambda raw, config: False)
    bnd, jbnd = engines["bounds"]
    clip = corpus[song][1][44100: 44100 * 5]
    calls = _count_calls(monkeypatch, "match_by_rank")
    got = _strip(dec.recognize_samples([clip], topn=2))
    assert [c[:2] for c in calls] == [("match_by_rank", "scan")] * len(calls)
    assert got == _strip(bnd.recognize_samples([clip], topn=2))
    assert got == _strip(jbnd.recognize_samples([clip], topn=2))


@pytest.mark.parametrize("policy,song", [("auto", 0), ("auto", 4),
                                         ("bounds", 0), ("bounds", 4)])
def test_recognize_clip_on_big_index_matches_jax(engines, corpus, policy,
                                                 song):
    port, ref = engines[policy]
    clip = corpus[song][1][44100: 44100 * 5]
    got = _strip(port.recognize_clip(clip))
    assert got["results"][0]["song_name"] == f"s{song}"
    assert got == _strip(ref.recognize_clip(clip))
    two = _strip(port.recognize_samples([clip]))
    assert got["results"][0] == two["results"][0]


def test_decide_tier_self_tuning(engines, corpus, monkeypatch):
    """More than half undecided over a window raises the decide tier one
    step, never past decide_adapt_max; decided windows leave it; window
    0 disables it. The JAX package's SIA takes the same steps."""
    from shazam_tpu.api import SIA as JaxSIA
    from shazam_tpu.config import FingerprintConfig as JaxConfig

    cfg = dict(BIG, decide_adapt_window=4, decide_adapt_max=1 << 14)
    sia = SIA(config=FingerprintConfig(**cfg), device="cpu")
    ref = JaxSIA(config=JaxConfig(**cfg))
    tier, conf = sia.decide, sia.config
    caps = tiers.match_tiers(conf)
    assert caps == ref._match_tiers() and tier.cap(conf, caps) == 128
    assert tier.stats(conf) == {}
    for a, u, boost in [(4, 3, 1), (4, 0, 1)] + [(4, 4, None)] * 10:
        tier.record(conf, a, u)
        ref._decide_record(a, u)
        assert tier.state()[1] == ref._decide_boost
        assert boost is None or tier.state()[1] == boost
        assert tier.cap(conf, caps) == ref._decide_cap(caps) <= 1 << 14
    assert tier.state() == ((0, 0), 11)
    assert tier.stats(conf) == {"decide_boost": 11,
                                "decide_tier": tier.cap(conf, caps)}

    # recognition records, and still answers, while boosted: the boosted
    # tier (8192) holds the whole clip, so the dispatch counts as decided
    # even with the certificate forced off
    sia.ingest_arrays(corpus)
    monkeypatch.setattr(tiers, "decided", lambda raw, config: False)
    out = sia.recognize_samples([corpus[1][1][44100: 44100 * 5]])
    assert out["results"][0]["song_name"] == "s1"
    assert tier.cap(conf, caps) == 8192 and tier.state() == ((1, 0), 11)

    off = SIA(config=FingerprintConfig(**dict(cfg, decide_adapt_window=0)),
              device="cpu")
    off.decide.record(off.config, 8, 8)
    assert off.decide.state() == ((0, 0), 0)


@pytest.mark.parametrize("vote_rank,fast,above", [
    ("auto", "sort", "scan"), ("pruned", "refused", "refused"),
    ("sort", "sort", "sort"), ("scan", "scan", "scan")])
def test_rank_for_each_tier(vote_rank, fast, above):
    """The port's "auto" is the sort rank at the fast tier (the JAX
    package's is pruned, which gives the same answer) and scan above it;
    a named rank holds at every tier, and under the sparse threshold the
    dense histogram at every tier. The JAX package's "pruned" is refused,
    naming the ranks the port runs instead."""
    if fast == "refused":
        with pytest.raises(ValueError, match="no pruned rank.*'sort'"):
            FingerprintConfig(**TIGHT, vote_rank=vote_rank)
        return
    cfg = FingerprintConfig(**TIGHT, vote_rank=vote_rank)
    assert [tiers.rank_for(cfg, cap, True) for cap in (64, 128)] \
        == [fast, above]
    assert {tiers.rank_for(cfg, cap, False) for cap in (64, 128)} \
        == {"dense"}
