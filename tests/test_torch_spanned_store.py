"""Port parity for the spanned device store and its matchers, on the CPU.

``index/devmerge.SpannedDeviceStore`` (spans, consolidation, span-wise
files) and the spanned matchers (``match/lookup``, ``match/ondevice``,
``match/batched``) against the JAX package's on the same seeded inputs:
every ``RawMatch`` field and ``span_max`` equal, rows equal after
``to_host``, span-wise files across the packages both ways. The JAX side
runs as ``tests/test_spanned.py`` runs it (bucket-CDF heads; its unique
view in one case); the port takes neither and answers alike.
"""

import dataclasses

import numpy as np
import pytest
import torch

from shazam_tpu_torch.api import SIA
from shazam_tpu_torch.audio import synth_song
from shazam_tpu_torch.index import devmerge
from shazam_tpu_torch.index.devmerge import SENTINEL, SpannedDeviceStore
from shazam_tpu_torch.index.store import DeviceIndex as View
from shazam_tpu_torch.index.store import build_index, search_keys
from shazam_tpu_torch.match.batched import match_queries_batched_spanned
from shazam_tpu_torch.match.lookup import (match_query_sparse,
                                           match_query_sparse_spanned)
from shazam_tpu_torch.match.ondevice import recognize_on_device_spanned

COLS = ("key_hi", "key_lo", "key_ex", "song_id", "offset")
FIELDS = ("top_songs", "top_deltas", "top_votes", "row_counts", "total_rows",
          "n_ranked", "n_dropped", "runner_votes")
SPAN = 4096


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- helpers -------------------------------------------------------------
def _random_index(n_rows, n_songs, stride, seed=0, hot=0):
    """``tests/test_spanned.py``'s sorted random rows; ``hot`` rows share
    one key (a run long enough to clamp)."""
    rng = np.random.default_rng(seed)
    hi = np.sort(rng.integers(0, 2**32, n_rows, dtype=np.uint32))
    lo = rng.integers(0, 2**32, n_rows, dtype=np.uint32)
    ex = rng.integers(0, 2**16, n_rows, dtype=np.uint32)
    sid = rng.integers(0, n_songs, n_rows, dtype=np.uint32)
    off = rng.integers(0, stride, n_rows, dtype=np.uint32)
    if hot:
        hi[:hot], lo[:hot], ex[:hot] = hi[hot], lo[hot], ex[hot]
    order = np.lexsort((off, sid, ex, lo, hi))
    return tuple(a[order] for a in (hi, lo, ex, sid, off))


def _host_index(rows, n_songs, max_offset):
    hi, lo, ex, sid, off = rows
    return build_index([(s, hi[sid == s], lo[sid == s], ex[sid == s],
                         off[sid == s]) for s in range(n_songs)],
                       n_songs=n_songs)


def _queries(rows, q_n, seed, n_valid=None, hot_lanes=0, hot=0):
    """JAX (uint32) and port (int64 / bool) query columns of rows picked
    from the index."""
    hi, lo, ex = rows[:3]
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, len(hi), q_n)
    pick[:hot_lanes] = hot
    valid = np.ones(q_n, bool)
    if n_valid is not None:
        valid[n_valid:] = False
    cols = (hi[pick], lo[pick], ex[pick],
            rng.integers(0, 50, q_n).astype(np.uint32), valid, valid)
    port = [torch.from_numpy(c.astype(bool if c.dtype == bool else np.int64))
            for c in cols]
    return cols, port


def _jax_q(cols):
    import jax.numpy as jnp

    return [jnp.asarray(c) for c in cols]


def _port_view(hi, lo, ex, packed, stride, rows=None):
    """A port search view (``index/store.DeviceIndex``) of sorted host
    rows, padded with sentinels to ``rows`` (default: a multiple of 512)."""
    k64, sub = search_keys(hi, lo, ex)
    n = len(hi)
    cap = rows or max(-(-n // 512), 1) * 512
    out = [np.full(cap, SENTINEL, np.int64) for _ in range(2)] + \
        [np.zeros(cap, np.int64)]
    for o, a in zip(out, (k64, sub, packed.astype(np.int64))):
        o[:n] = a
    return View(*(torch.from_numpy(o) for o in out), n, stride)


def _round_robin(rows, n_spans, stride):
    """Per-span (hi, lo, ex, packed) of a round-robin partition: each a
    sorted subsequence holding the whole key range, like ingest-time spans
    whose key ranges overlap."""
    hi, lo, ex, sid, off = rows
    packed = sid * np.uint32(stride) + off
    return [tuple(a[k::n_spans] for a in (hi, lo, ex, packed))
            for k in range(n_spans)]


def _stacked_pair(parts, stride):
    """The same equal-capacity spans stacked for JAX (uint32 columns and
    bucket-CDF heads) and for the port (one view of (S, span_rows)
    columns)."""
    import jax
    import jax.numpy as jnp
    from shazam_tpu.index.search import build_head, stacked_head_bits

    span_rows = max(len(p[0]) for p in parts)
    jax_cols = tuple(
        jnp.asarray(np.stack([np.concatenate(
            [p[c], np.full(span_rows - len(p[c]), 0xFFFFFFFF, np.uint32)])
            for p in parts])) for c in range(4))
    bits = stacked_head_bits(span_rows)
    heads = jax.vmap(lambda h: build_head(h, bits=bits))(jax_cols[0])
    views = [_port_view(*p, stride, rows=span_rows) for p in parts]
    port = View(*(torch.stack([getattr(v, f) for v in views])
                  for f in ("key64", "key_sub", "payload")),
                sum(v.n_rows for v in views), stride)
    return jax_cols, heads, port


def _assert_raw_equal(got, want, what=""):
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(got, f)),
                              np.asarray(getattr(want, f))), (what, f)


def _index_equal(a, b):
    for c in COLS:
        assert np.array_equal(np.asarray(getattr(a, c)),
                              np.asarray(getattr(b, c))), c
    assert a.n_songs == b.n_songs


def _songs(n, secs=3.0):
    return [(f"s{i}", synth_song(i, duration_s=secs, seed=11))
            for i in range(n)]


def _clip(songs, i, start=11025, secs=2.0):
    return songs[i][1][start: start + int(secs * 44100)]


def _answer(res):
    top = res["results"][0] if res["results"] else {}
    return (top.get("song_name"), top.get("offset"),
            top.get("hashes_matched_in_input"), res["total_matches"],
            res["input_hashes"])


def _jax_sia(**kw):
    from shazam_tpu.api import SIA as JaxSIA
    from shazam_tpu.config import FingerprintConfig as JaxConfig

    if "config" in kw:
        kw["config"] = JaxConfig(**dataclasses.asdict(kw["config"]))
    return JaxSIA(**kw)


def _device_ingest(sia, songs, jax_side=False):
    blen = 1 << 18
    for i in range(0, len(songs), 2):
        chunk = songs[i:i + 2]
        mat = np.zeros((len(chunk), blen), np.float32)
        for r, (_n, s) in enumerate(chunk):
            mat[r, : len(s)] = s
        if jax_side:
            import jax.numpy as jnp

            mat = jnp.asarray(mat)
        else:
            mat = torch.from_numpy(mat)
        st = sia.ingest_device_batch([n for n, _s in chunk], mat,
                                     [len(s) for _n, s in chunk],
                                     per_song_hash_capacity=4096,
                                     defer_sort=True)
        assert st["overflowed"] == []


def _jax_store_spans(store):
    return [s.to_host() for s in store.spans if s.n_valid > 0]


# ---- matchers -------------------------------------------------------------
@pytest.mark.parametrize("n_spans", [1, 3])
def test_spanned_matcher_equals_flat(n_spans):
    """``test_spanned.py:60``: per-span views over a round-robin partition
    match as the flat index, and as JAX's per-span matcher field for field,
    ``span_max`` included."""
    from shazam_tpu.index.search import maybe_build_head
    from shazam_tpu.match.lookup import query_total_spanned
    from shazam_tpu.match.lookup import \
        match_query_sparse_spanned as jax_spanned

    n_rows, n_songs, stride = 30000, 40, 4096
    rows = _random_index(n_rows, n_songs, stride)
    parts = _round_robin(rows, n_spans, stride)
    jq, pq = _queries(rows, 256, seed=7)
    kw = dict(n_songs=n_songs, delta_min=-64, delta_range=stride + 128,
              match_capacity=16384, topn=5)
    jax_spans = tuple(tuple(_jax_q(p)) for p in parts)
    heads = tuple(maybe_build_head(s[0]) for s in jax_spans)
    want, want_max = jax_spanned(jax_spans, *_jax_q(jq), heads=heads,
                                 offset_stride=stride, **kw)
    views = tuple(_port_view(*p, stride) for p in parts)
    got, span_max = match_query_sparse_spanned(views, *pq, **kw)
    _assert_raw_equal(got, want)
    assert int(span_max) == int(want_max) <= int(got.total_rows)
    flat = _port_view(rows[0], rows[1], rows[2],
                      rows[3] * np.uint32(stride) + rows[4], stride)
    _assert_raw_equal(got, match_query_sparse(flat, *pq, **kw), "flat")
    jq4 = _jax_q(jq)
    assert int(query_total_spanned(jax_spans, jq4[0], jq4[1], jq4[2], jq4[4],
                                   heads=heads)) == int(got.total_rows)


def test_stacked_matcher_equals_flat():
    """``test_spanned.py:189``: the stacked (n_spans, span_rows) view,
    padding lanes included, against JAX's stacked matcher and the flat
    match; the search's bounds (JAX's probe's) give the same match
    again."""
    from shazam_tpu.match.lookup import query_total_spanned
    from shazam_tpu.match.lookup import \
        match_query_sparse_spanned as jax_spanned

    n_rows, n_songs, stride = 30000, 40, 4096
    rows = _random_index(n_rows, n_songs, stride, seed=1)
    jax_cols, heads, port = _stacked_pair(_round_robin(rows, 3, stride),
                                          stride)
    jq, pq = _queries(rows, 256, seed=9, n_valid=200)
    kw = dict(n_songs=n_songs, delta_min=-64, delta_range=stride + 128,
              match_capacity=16384, topn=5)
    want, want_max = jax_spanned(jax_cols, *_jax_q(jq), heads=heads,
                                 offset_stride=stride, **kw)
    got, span_max, lb, ub = match_query_sparse_spanned(
        port, *pq, with_bounds=True, **kw)
    _assert_raw_equal(got, want)
    assert int(span_max) == int(want_max) == int(got.total_rows)
    assert lb.shape == (3, 256)
    again, _ = match_query_sparse_spanned(port, *pq, bounds=(lb, ub), **kw)
    _assert_raw_equal(again, got, "bounds")
    jq4 = _jax_q(jq)
    total, lb2, ub2 = query_total_spanned(jax_cols, jq4[0], jq4[1], jq4[2],
                                          jq4[4], heads=heads,
                                          with_bounds=True)
    assert int(total) == int(got.total_rows)
    assert np.array_equal(np.asarray(lb2), lb.numpy())
    assert np.array_equal(np.asarray(ub2), ub.numpy())
    flat = _port_view(rows[0], rows[1], rows[2],
                      rows[3] * np.uint32(stride) + rows[4], stride)
    _assert_raw_equal(got, match_query_sparse(flat, *pq, **kw), "flat")


def test_stacked_joint_budget_clamp_and_escalation():
    """``test_spanned.py:644``: one budget across the stacked spans. At a
    small capacity the clamp signal is the total and whole runs drop, in
    both packages field for field; at the capacity that fits, the flat
    answer; JAX's pruned matcher equal to it at every candidate count; and
    the blocked expansion's joint run budget (``expand_block_runs`` x
    n_spans) as JAX's, with the row-by-row fallback exact."""
    import jax.numpy as jnp
    from shazam_tpu.match.lookup import \
        match_query_pruned_spanned as jax_pruned
    from shazam_tpu.match.lookup import \
        match_query_sparse_spanned as jax_spanned

    n_rows, n_songs, stride, n_spans = 30000, 40, 4096, 3
    hot = n_rows // 4
    rows = _random_index(n_rows, n_songs, stride, seed=3, hot=hot)
    parts = _round_robin(rows, n_spans, stride)
    jax_cols, heads, port = _stacked_pair(parts, stride)
    jq, pq = _queries(rows, 128, seed=11, hot_lanes=8, hot=hot)
    kw = dict(n_songs=n_songs, delta_min=-64, delta_range=stride + 128,
              topn=5)

    for cap in (2048, 1 << 14):
        want, want_c = jax_spanned(jax_cols, *_jax_q(jq), heads=heads,
                                   offset_stride=stride, match_capacity=cap,
                                   **kw)
        got, clamp = match_query_sparse_spanned(port, *pq,
                                                match_capacity=cap, **kw)
        _assert_raw_equal(got, want, cap)
        assert int(clamp) == int(want_c) == int(got.total_rows)
    total = int(got.total_rows)
    assert total > 2048 and int(got.n_dropped) > 0
    fit = 4096
    while fit < total:
        fit *= 2
    big, clamp = match_query_sparse_spanned(port, *pq, match_capacity=fit,
                                            **kw)
    assert int(clamp) == total and int(big.n_dropped) == 0
    flat = _port_view(rows[0], rows[1], rows[2],
                      rows[3] * np.uint32(stride) + rows[4], stride)
    _assert_raw_equal(big, match_query_sparse(flat, *pq, match_capacity=fit,
                                              **kw), "flat")
    for n_cand in (2, 16, n_songs):
        want_p, clamp_p, _ok = jax_pruned(
            jax_cols, *_jax_q(jq), heads=heads, offset_stride=stride,
            match_capacity=fit, n_candidates=n_cand, **kw)
        _assert_raw_equal(big, want_p, n_cand)
        assert int(clamp_p) == total

    # blocked: 2 runs a span is too few for these queries; JAX stacks
    # rows of 10,000, the port needs a block size that divides them
    blk_kw = dict(match_capacity=fit, expand_block=8, expand_runs=2, **kw)
    views = tuple(_port_view(*p, stride, rows=10240) for p in parts)
    blocked_port = View(*(torch.stack([getattr(v, f) for v in views])
                          for f in ("key64", "key_sub", "payload")),
                        n_rows, stride)
    jax_blk_cols = tuple(jnp.asarray(np.stack([np.concatenate(
        [p[c], np.full(10240 - len(p[c]), 0xFFFFFFFF, np.uint32)])
        for p in parts])) for c in range(4))
    want_b, want_bc = jax_spanned(
        jax_blk_cols, *_jax_q(jq), heads=None, offset_stride=stride,
        **blk_kw)
    got_b, clamp_b = match_query_sparse_spanned(blocked_port, *pq, **blk_kw)
    _assert_raw_equal(got_b, want_b, "blocked")
    assert int(clamp_b) == int(want_bc) == total
    assert int(got_b.n_dropped) > 0
    row_by_row, _ = match_query_sparse_spanned(
        blocked_port, *pq, **dict(blk_kw, expand_block=0))
    _assert_raw_equal(row_by_row, big, "fallback")


def test_stacked_uview_and_port_give_equal_answers():
    """``test_spanned.py:732``: JAX through its stacked unique-key view and
    through its heads, the port with neither: every field equal."""
    from shazam_tpu.index.search import build_unique_view_spans
    from shazam_tpu.match.lookup import \
        match_query_sparse_spanned as jax_spanned

    n_rows, n_songs, stride = 30000, 40, 4096
    rows = _random_index(n_rows, n_songs, stride, seed=3)
    parts = _round_robin(rows, 3, stride)
    jax_cols, heads, port = _stacked_pair(parts, stride)
    uview, usteps = build_unique_view_spans([p[:3] for p in parts])
    assert uview is not None and usteps > 0
    jq, pq = _queries(rows, 128, seed=11, n_valid=100)
    jq = list(jq)
    jq[0] = jq[0].copy()
    jq[0][100:] = 0xFFFFFFFF          # padding lanes: all-ones keys
    pq[0] = torch.from_numpy(jq[0].astype(np.int64))
    kw = dict(n_songs=n_songs, delta_min=-64, delta_range=stride + 128,
              match_capacity=16384, topn=5)
    via_uview, sm_u = jax_spanned(jax_cols, *_jax_q(jq), uviews=uview,
                                  u_steps=usteps, offset_stride=stride, **kw)
    via_heads, sm_h = jax_spanned(jax_cols, *_jax_q(jq), heads=heads,
                                  offset_stride=stride, **kw)
    got, sm = match_query_sparse_spanned(port, *pq, uviews="ignored", **kw)
    _assert_raw_equal(got, via_uview, "uview")
    _assert_raw_equal(got, via_heads, "heads")
    assert int(sm) == int(sm_u) == int(sm_h)


def test_batched_spanned_matcher_equals_jax():
    """``match_queries_batched_spanned`` per span and stacked: every clip's
    row and span_max as JAX's batch, and as the solo matcher; each clip
    whose certificate holds in JAX's pruned batch is the port's row."""
    from shazam_tpu.index.search import maybe_build_head
    from shazam_tpu.match.batched import \
        match_queries_batched_spanned as jax_batched

    n_rows, n_songs, stride = 30000, 40, 4096
    hot = 600
    rows = _random_index(n_rows, n_songs, stride, seed=5, hot=hot)
    parts = _round_robin(rows, 3, stride)
    jax_cols, heads, stacked = _stacked_pair(parts, stride)
    stacks = [_queries(rows, 96, seed=s, n_valid=80, hot_lanes=s % 3,
                       hot=hot) for s in range(4)]
    jq = [np.stack([q[0][c] for q in stacks]) for c in range(6)]
    pq = [torch.stack([q[1][c] for q in stacks]) for c in range(6)]
    kw = dict(n_songs=n_songs, delta_min=-64, delta_range=stride + 128,
              match_capacity=4096, topn=3)
    per_span = tuple(_port_view(*p, stride) for p in parts)
    jax_spans = tuple(tuple(_jax_q(p)) for p in parts)
    jax_heads = tuple(maybe_build_head(s[0]) for s in jax_spans)
    for name, port, jcols, jh in (("spans", per_span, jax_spans, jax_heads),
                                  ("stacked", stacked, jax_cols, heads)):
        want, want_sm = jax_batched(jcols, *_jax_q(jq), heads=jh,
                                    offset_stride=stride, vote_rank="sort",
                                    **kw)
        got, sm = match_queries_batched_spanned(port, *pq, vote_rank="sort",
                                                **kw)
        _assert_raw_equal(got, want, name)
        assert np.array_equal(sm.numpy(), np.asarray(want_sm)), name
        for i in range(len(stacks)):
            solo, solo_sm = match_query_sparse_spanned(
                port, *(c[i] for c in pq), **kw)
            _assert_raw_equal(type(got)(*(a[i] for a in got)), solo, i)
            assert int(solo_sm) == int(sm[i])
        # every song a candidate: each certificate holds
        pr, sm_p, oks = jax_batched(jcols, *_jax_q(jq), heads=jh,
                                    offset_stride=stride,
                                    rank_candidates=n_songs,
                                    vote_rank="pruned", **kw)
        assert np.array_equal(np.asarray(sm_p), sm.numpy()), name
        assert np.asarray(oks).all(), name
        for i in np.nonzero(np.asarray(oks))[0]:
            _assert_raw_equal(type(got)(*(a[i] for a in got)),
                              type(got)(*(a[i] for a in pr)), (name, i))


def test_spanned_single_dispatch_vote_key_guard():
    """``test_spanned.py:597``: the single-dispatch spanned recognizer
    refuses an overflowing vote key, as JAX's does."""
    dummy = torch.zeros(512, dtype=torch.int64)
    view = View(dummy, dummy, dummy, 0, 1)
    with pytest.raises(ValueError, match="int32 vote key"):
        recognize_on_device_spanned(
            torch.zeros((1, 1 << 18)), torch.tensor([100], dtype=torch.int32),
            (view,), n_songs=1 << 20, delta_min=-1024, delta_range=4608)


def test_single_dispatch_spanned_equals_jax():
    """``recognize_on_device_spanned`` on a spanned store's per-span and
    stacked views: the RawMatch, span_max and counts of JAX's."""
    import jax.numpy as jnp
    from shazam_tpu.match.ondevice import \
        recognize_on_device_spanned as jax_recognize

    songs = _songs(4)
    sia = SIA(device="cpu", device_span_rows=SPAN)
    sia.ingest_arrays(songs)
    ref = _jax_sia(device_span_rows=SPAN)
    ref.ingest_arrays(songs)
    clip = np.zeros(1 << 18, np.float32)
    clip[: 2 * 44100] = _clip(songs, 2)
    kw = dict(n_songs=5, delta_min=-128, delta_range=4096 + 256,
              match_capacity=2048, topn=2, vote_rank="sort",
              query_capacity=2048)
    for stacked in (False, True):
        if stacked:
            sia.consolidate_index()
            ref.consolidate_index()
        got = recognize_on_device_spanned(
            torch.from_numpy(clip)[None], torch.tensor([2 * 44100],
                                                       dtype=torch.int32),
            sia._ensure_device_index(), **kw)
        want = jax_recognize(
            jnp.asarray(clip)[None], jnp.asarray([2 * 44100], np.int32),
            ref._ensure_device_index(), offset_stride=ref._offset_stride,
            use_fused=False, **kw)
        _assert_raw_equal(got[0], want[0], stacked)
        assert [int(a) for a in got[1:]] == [int(a) for a in want[1:]]


# ---- the store ------------------------------------------------------------
def test_spanned_device_ingest_rolls_spans_as_jax():
    """Device ingest rolls the port's spans at the same runs as JAX's: the
    same number of spans, each holding the same rows, and the flat store's
    rows in all."""
    songs = _songs(6)
    port = SIA(device="cpu", device_span_rows=SPAN)
    flat = SIA(device="cpu", device_resident=True)
    ref = _jax_sia(device_span_rows=SPAN)
    _device_ingest(port, songs)
    _device_ingest(flat, songs)
    _device_ingest(ref, songs, jax_side=True)
    store = port._dev_store
    store.finalize()
    ref._dev_store.finalize()
    mine = [s.to_host() for s in store.spans if s.n_valid]
    theirs = _jax_store_spans(ref._dev_store)
    assert len(mine) == len(theirs) >= 2
    for a, b in zip(mine, theirs):
        for c in COLS:
            assert np.array_equal(getattr(a, c), getattr(b, c)), c
    _index_equal(store.to_host(), flat.index)
    assert all(s.capacity == SPAN for s in store.spans)


def test_consolidate_store_end_to_end():
    """``test_spanned.py:242``: consolidation stacks the spans and keeps
    every answer, in both packages alike; the host index round-trips
    through the stacked layout; ingest then raises JAX's message."""
    songs = _songs(6)
    sia = SIA(device="cpu", device_span_rows=SPAN)
    ref = _jax_sia(device_span_rows=SPAN)
    _device_ingest(sia, songs)
    _device_ingest(ref, songs, jax_side=True)
    clip = _clip(songs, 4)
    batch = [clip, songs[1][1][:44100]]
    before = _answer(sia.recognize_samples([clip]))
    host_before = sia.index
    store = sia._dev_store
    assert len([s for s in store.spans if s.n_valid]) >= 2
    sia.consolidate_index()
    ref.consolidate_index()
    sia._host_stale = True         # to_host through the stacked layout
    assert store.is_stacked and store.query_cols().key64.ndim == 2
    after = _answer(sia.recognize_samples([clip]))
    assert after == before == _answer(ref.recognize_samples([clip]))
    assert after[0] == "s4"
    assert _answer(sia.recognize_clip(clip)) == \
        _answer(ref.recognize_clip(clip))
    assert [_answer(r) for r in sia.recognize_batch(batch)] == \
        [_answer(r) for r in ref.recognize_batch(batch)]
    _index_equal(host_before, sia.index)
    mat = np.zeros((1, 1 << 18), np.float32)
    mat[0, : len(songs[0][1])] = songs[0][1]
    for s_, x in ((sia, torch.from_numpy(mat)), (ref, None)):
        if x is None:
            import jax.numpy as jnp

            x = jnp.asarray(mat)
        with pytest.raises(ValueError, match="consolidated"):
            s_.ingest_device_batch(["fresh"], x, [len(songs[0][1])],
                                   per_song_hash_capacity=4096,
                                   defer_sort=True)


def test_spanned_run_too_large_raises():
    """``test_spanned.py:326``: one run longer than a span is refused, in
    JAX's words."""
    from shazam_tpu.index.devmerge import SpannedDeviceStore as JaxStore
    import jax.numpy as jnp

    store = SpannedDeviceStore(span_rows=4096, n_songs=1, max_offset=100,
                               stride=128)
    cols = devmerge.empty_cols(8192, "cpu")
    with pytest.raises(ValueError, match="exceeds span_rows") as mine:
        store.append_run(cols, 8000, 1, 100)
    ref = JaxStore(span_rows=4096, n_songs=1, max_offset=100, stride=128)
    jcols = tuple(jnp.full(8192, 0xFFFFFFFF, jnp.uint32) for _ in range(4))
    with pytest.raises(ValueError, match="exceeds span_rows") as theirs:
        ref.append_run(jcols, 8000, 1, 100)
    assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="span_rows 100 is below"):
        SpannedDeviceStore(span_rows=100)


def test_spanned_save_load_roundtrip(tmp_path):
    """``test_spanned.py:341``: the span-wise file round-trips at the saved
    span_rows and cut into smaller spans, and crosses the packages both
    ways, spans and rows equal; ``load_flat`` gives the same rows."""
    from shazam_tpu.index.devmerge import SpannedDeviceStore as JaxStore
    from shazam_tpu.index.store import build_index as jax_build

    rows = _random_index(20_000, 12, 512, seed=3)
    ix = _host_index(rows, 12, 511)
    store = SpannedDeviceStore.from_host(ix, span_rows=8192)
    ref = JaxStore.from_host(jax_build(
        [(s, *(a[rows[3] == s] for a in (rows[0], rows[1], rows[2], rows[4])))
         for s in range(12)], n_songs=12), span_rows=8192)
    flat = store.to_host()
    _index_equal(flat, ref.to_host())
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    store.save(mine)
    ref.save(theirs)
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    for path in (mine, theirs):
        back = SpannedDeviceStore.load(path)
        assert back.span_rows == 8192 and back.stride == store.stride
        assert back.n_valid == store.n_valid
        _index_equal(back.to_host(), flat)
        resplit = SpannedDeviceStore.load(path, span_rows=4096)
        assert len(resplit.spans) > len(back.spans)
        _index_equal(resplit.to_host(), flat)
        _index_equal(SpannedDeviceStore.load_flat(path), flat)
        _index_equal(JaxStore.load(path, span_rows=4096).to_host(), flat)


def test_consolidated_save_load(tmp_path):
    """``test_spanned.py:411``: a consolidated store saves span-wise and
    loads back per span (in both packages), consolidating again."""
    from shazam_tpu.index.devmerge import SpannedDeviceStore as JaxStore

    rows = _random_index(12_000, 6, 512, seed=9)
    store = SpannedDeviceStore.from_host(_host_index(rows, 6, 511),
                                         span_rows=4096)
    flat = store.to_host()
    store.consolidate()
    assert store.is_stacked and store._stacked_valids == [4096, 4096, 3808]
    path = str(tmp_path / "cons.npz")
    store.save(path)
    back = SpannedDeviceStore.load(path)
    assert not back.is_stacked
    _index_equal(back.to_host(), flat)
    back.consolidate()
    assert back.is_stacked
    _index_equal(back.to_host(), flat)
    _index_equal(JaxStore.load(path).to_host(), flat)


def test_stacked_load_equals_consolidate(tmp_path):
    """``test_spanned.py:507``: ``load(stacked=True)`` gives load +
    ``consolidate()``'s columns exactly, also re-split, with JAX's span
    valids."""
    from shazam_tpu.index.devmerge import SpannedDeviceStore as JaxStore

    rows = _random_index(12_000, 6, 512, seed=21)
    store = SpannedDeviceStore.from_host(_host_index(rows, 6, 511),
                                         span_rows=8192)
    flat = store.to_host()
    path = str(tmp_path / "span.npz")
    store.save(path)
    for span_rows in (0, 4096):
        ref = SpannedDeviceStore.load(path, span_rows=span_rows)
        ref.consolidate()
        got = SpannedDeviceStore.load(path, span_rows=span_rows,
                                      stacked=True)
        assert got.is_stacked
        assert got._stacked_valids == ref._stacked_valids == \
            JaxStore.load(path, span_rows=span_rows,
                          stacked=True)._stacked_valids
        assert got.n_valid == store.n_valid
        for a, b in zip(got._stacked, ref._stacked):
            assert torch.equal(a, b)
        for f in ("key64", "key_sub", "payload"):
            assert torch.equal(getattr(got.query_cols(), f),
                               getattr(ref.query_cols(), f))
        _index_equal(got.to_host(), flat)


def test_consolidate_rollback_on_midway_fault(monkeypatch):
    """``test_spanned.py:450``: a fault while stacking a later column
    leaves the per-span layout whole (released columns restored from
    their stacked copies), queries unchanged, and a retry consolidates."""
    songs = _songs(8)
    sia = SIA(device="cpu", device_span_rows=SPAN)
    _device_ingest(sia, songs)
    clip = _clip(songs, 2)
    before = sia.recognize_samples([clip])
    assert before["results"][0]["song_name"] == "s2"
    store = sia._ensure_dev_store()
    cols_before = [tuple(c.clone() for c in s.cols) for s in store.spans]
    n_live = len([s for s in store.spans if s.n_valid > 0])
    assert n_live >= 2

    real = devmerge._stack_row
    calls = {"n": 0}

    def flaky(big, row, i):
        calls["n"] += 1
        if calls["n"] > n_live:          # after the first column stacked
            raise RuntimeError("injected device fault")
        return real(big, row, i)

    monkeypatch.setattr(devmerge, "_stack_row", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        store.consolidate()
    monkeypatch.setattr(devmerge, "_stack_row", real)
    assert not store.is_stacked and store.host_staged == 0
    for s, cols in zip(store.spans, cols_before):
        assert all(torch.equal(a, b) for a, b in zip(s.cols, cols))
    assert sia.recognize_samples([clip])["results"] == before["results"]
    store.consolidate()
    assert store.is_stacked
    assert sia.recognize_samples([clip])["results"] == before["results"]


def test_consolidate_oom_falls_back_to_host_staging(monkeypatch, capsys):
    """``test_spanned.py:566``: out of device memory while stacking, the
    columns are staged through the host instead, to the same stacked
    layout; the store counts it and says so."""
    rows = _random_index(9_000, 6, 512, seed=33)
    ix = _host_index(rows, 6, 511)
    ref = SpannedDeviceStore.from_host(ix, span_rows=4096)
    ref.consolidate()
    store = SpannedDeviceStore.from_host(ix, span_rows=4096)

    def oom(big, row, i):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setattr(devmerge, "_stack_row", oom)
    store.consolidate()
    assert store.is_stacked and store.host_staged == 1 and ref.host_staged == 0
    assert "staging the rest through host memory" in capsys.readouterr().err
    assert store._stacked_valids == ref._stacked_valids
    for a, b in zip(store._stacked, ref._stacked):
        assert torch.equal(a, b)


def test_consolidate_other_fault_is_not_staged(monkeypatch):
    """Only a device OOM takes the host staging; any other fault rolls
    back and is raised."""
    rows = _random_index(9_000, 6, 512, seed=34)
    store = SpannedDeviceStore.from_host(_host_index(rows, 6, 511),
                                         span_rows=4096)
    flat = store.to_host()

    def boom(big, row, i):
        raise ValueError("not an OOM")

    monkeypatch.setattr(devmerge, "_stack_row", boom)
    with pytest.raises(ValueError, match="not an OOM"):
        store.consolidate()
    assert not store.is_stacked and store.host_staged == 0
    _index_equal(store.to_host(), flat)


# ---- SIA surfaces -------------------------------------------------------
def test_recognize_batch_on_spanned_sia_equals_jax():
    """``recognize_batch`` on a spanned SIA, per span and consolidated,
    under the default config and past the sparse threshold (JAX's pruned
    rank, the port's sort rank in its place): answers equal to JAX's
    spanned SIA and to ``recognize_samples`` alone."""
    from shazam_tpu.config import FingerprintConfig as JaxConfig
    from shazam_tpu_torch.config import FingerprintConfig

    songs = _songs(6)
    clips = [_clip(songs, i) for i in (0, 3, 5)] + [songs[2][1][:44100]]
    cfgs = ((FingerprintConfig(), JaxConfig()),
            (FingerprintConfig(vote_rank="sort", sparse_vote_threshold=0),
             JaxConfig(vote_rank="pruned", rank_candidates=2,
                       sparse_vote_threshold=0)))
    for cfg, jax_cfg in cfgs:
        sia = SIA(device="cpu", device_span_rows=SPAN, config=cfg)
        ref = _jax_sia(device_span_rows=SPAN, config=jax_cfg)
        _device_ingest(sia, songs)
        _device_ingest(ref, songs, jax_side=True)
        for _layout in ("spans", "stacked"):
            got = [_answer(r) for r in sia.recognize_batch(clips)]
            assert got == [_answer(r) for r in ref.recognize_batch(clips)]
            assert got == [_answer(sia.recognize_samples([c])) for c in clips]
            assert [g[0] for g in got[:3]] == ["s0", "s3", "s5"]
            sia.consolidate_index()
            ref.consolidate_index()


def test_daemon_and_stream_on_a_spanned_sia():
    """``tests/test_serve.py::test_serve_spanned_consolidated``: the daemon
    answers from a consolidated spanned SIA as ``recognize_samples`` does;
    a stream over it too."""
    import io
    import json
    import urllib.request
    import wave

    from shazam_tpu_torch.serve import RecognitionServer
    from shazam_tpu_torch.stream import StreamRecognizer

    songs = [(f"s{i}", synth_song(i, duration_s=8.0, seed=31))
             for i in range(2)]
    sia = SIA(device="cpu", device_span_rows=SPAN)
    sia.ingest_arrays(songs)
    sia.consolidate_index()
    assert sia._dev_store.is_stacked
    clip = songs[1][1][44100: 6 * 44100]
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(44100)
        wf.writeframes(clip.astype(np.int16).tobytes())
    srv = RecognitionServer(sia, port=0, max_batch=4, max_wait_ms=50.0,
                            request_timeout_s=600.0)
    srv.start_background()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/recognize", data=buf.getvalue(),
            method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
    finally:
        srv.close()
    want = sia.recognize_samples([clip])
    assert out["results"][0]["song_name"] == "s1"
    assert out["results"][0]["offset"] == want["results"][0]["offset"]
    assert out["total_matches"] == want["total_matches"]
    rec = StreamRecognizer(sia, channels=1, window_seconds=5.0)
    rec.feed(clip.astype(np.int16))
    got = rec.recognize()
    assert got["results"][0]["song_name"] == "s1"
    assert got["total_matches"] == _answer(
        sia.recognize_samples(rec._window_channels()))[3]
