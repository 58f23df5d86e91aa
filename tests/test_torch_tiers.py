"""The dispatch sequence of every escalation regime, pinned.

Each regime drives one public ``SIA`` call on the CPU and records, in
order, every match dispatch the port makes (``match_by_rank``,
``match_query_sparse_spanned``, ``match_queries_batched`` and the
spanned single pass ``recognize_on_device_spanned``: the rank, the
capacity, the effective blocked-expansion width, whether the search
bounds were asked back and whether earlier ones were passed in), then
every host ``RawMatch`` handed to ``align_results`` with the capacity it
reads. ``PINNED`` holds the sequences the capacity ladder gives; a change
to the ladder that moves a dispatch, a tier, a bound's reuse or an align
capacity shows here.
"""

import numpy as np
import pytest
import torch

from shazam_tpu_torch.api import SIA
from shazam_tpu_torch.audio import synth_song
from shazam_tpu_torch.config import FingerprintConfig

FS, HOP = 44100, 2048
N_SONGS, SONG_S = 6, 12.0
DISPATCHES = ("match_by_rank", "match_query_sparse_spanned",
              "match_queries_batched", "recognize_on_device_spanned")
TIGHT = dict(match_capacity_fast=64, match_capacity=128,
             match_capacity_max=1 << 16)
# every index is big and every catalog sparse: decide-first on each match
BIG = dict(TIGHT, sparse_vote_threshold=0, bounds_probe_min_rows=1,
           escalation_policy="decide")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def songs():
    return [(f"song{i}", synth_song(i, SONG_S, seed=300 + i))
            for i in range(N_SONGS)]


def _clip(songs, k, secs=5.0):
    start = (20 + 7 * k) * HOP
    return songs[k][1][start: start + int(secs * FS)]


def _noise():
    """Two 12 s channels of white noise: past 2 x 4,096 query lanes, the
    stereo pass's width before its query held every fingerprint lane."""
    rng = np.random.default_rng(0)
    return rng.normal(0, 8000, (2, 12 * FS)).astype(np.float32)


# name -> (config, SIA keywords, consolidate, call)
REGIMES = {
    "dense_fast_hit": (
        {}, {}, False, lambda s, songs: s.recognize_clip(_clip(songs, 1))),
    "dense_undecided": (
        dict(TIGHT, decision_escalation=False), {}, False,
        lambda s, songs: s.recognize_clip(_clip(songs, 2))),
    "wide_query": (
        {}, {}, False, lambda s, songs: s.recognize_clip(_noise())),
    "wide_query_decide": (
        BIG, {}, False, lambda s, songs: s.recognize_clip(_noise())),
    "sparse_decided": (
        dict(BIG, match_capacity=512), {}, False,
        lambda s, songs: s.recognize_clip(_clip(songs, 3))),
    "sparse_undecided_clip": (
        dict(BIG, decision_escalation=False), {}, False,
        lambda s, songs: s.recognize_clip(_clip(songs, 4))),
    "sparse_undecided_samples": (
        dict(BIG, decision_escalation=False), {}, False,
        lambda s, songs: s.recognize_samples([_clip(songs, 4)])),
    "blocked_fallback": (
        dict(sparse_vote_threshold=0, match_capacity_fast=1024,
             match_capacity=4096, expand_block=128,
             expand_block_min_capacity=1024, expand_block_runs=2),
        {}, False, lambda s, songs: s.recognize_samples([_clip(songs, 5)])),
    "spanned_stacked": (
        dict(TIGHT, decision_escalation=False),
        dict(device_span_rows=4096), True,
        lambda s, songs: s.recognize_samples([_clip(songs, 1)])),
    "spanned_per_span": (
        dict(TIGHT, decision_escalation=False),
        dict(device_span_rows=4096), False,
        lambda s, songs: s.recognize_samples([_clip(songs, 1)])),
    "spanned_stacked_decide": (
        BIG, dict(device_span_rows=4096), True,
        lambda s, songs: s.recognize_samples([_clip(songs, 3)])),
    "spanned_clip": (
        {}, dict(device_span_rows=4096), False,
        lambda s, songs: s.recognize_clip(_clip(songs, 2))),
    "batch_solo_retry": (
        dict(match_capacity=64, match_capacity_fast=64,
             match_capacity_max=4096, decision_escalation=False), {}, False,
        lambda s, songs: s.recognize_batch(
            [_clip(songs, 0, 4.0), np.zeros(4 * FS, np.int16),
             np.zeros(3 * FS, np.int16)])),
    "batch_decide_first": (
        BIG, {}, False,
        lambda s, songs: s.recognize_batch(
            [_clip(songs, k, 4.0) for k in range(4)])),
}


def _record(monkeypatch, regime, songs):
    """The regime's dispatches and align inputs, in call order."""
    from shazam_tpu_torch import api
    from shazam_tpu_torch.match import batched, lookup, ondevice

    cfg, kw, consolidate, call = REGIMES[regime]
    sia = SIA(config=FingerprintConfig(**cfg), device="cpu", **kw)
    sia.ingest_arrays(songs)
    if consolidate:
        sia.consolidate_index()
    seen = []
    for mod in (api, ondevice, lookup, batched):
        for name in DISPATCHES:
            if not hasattr(mod, name):
                continue

            def spy(*a, _real=getattr(mod, name), _name=name, **k):
                rank = k.get("rank", k.get("vote_rank"))
                blk = 0 if rank == "dense" else k.get("expand_block", 0)
                seen.append((_name, rank, k.get("match_capacity"), blk,
                             bool(k.get("with_bounds")),
                             k.get("bounds") is not None))
                return _real(*a, **k)

            monkeypatch.setattr(mod, name, spy)
    real_align = api.align_results

    def align(raw, *a, **k):
        seen.append(("align", k.get("match_capacity"),
                     tuple(np.asarray(f).tolist() for f in raw)))
        return real_align(raw, *a, **k)

    monkeypatch.setattr(api, "align_results", align)
    call(sia, songs)
    return seen


PINNED = {
    'dense_fast_hit': [
        ('match_by_rank', 'dense', 16384, 0, False, False),
        ('align', 16384,
         ([2, 1], [27, 133], [1019, 3], [1028, 6], 1054, 6, 0, 5)),
    ],
    'dense_undecided': [
        ('match_by_rank', 'dense', 64, 0, False, False),
        ('match_by_rank', 'dense', 2048, 0, False, False),
        ('align', 2048,
         ([3, 1], [34, 47], [954, 6], [984, 20], 1081, 6, 0, 6)),
    ],
    'wide_query': [
        ('match_by_rank', 'dense', 16384, 0, False, False),
        ('align', 16384,
         ([5, 2], [-42, -169], [3, 1], [6, 3], 35, 5, 0, 1)),
    ],
    'wide_query_decide': [
        ('match_by_rank', 'scan', 128, 0, True, False),
        ('align', 128,
         ([5, 2], [-42, -169], [3, 1], [6, 3], 35, 5, 0, 1)),
    ],
    'sparse_decided': [
        ('match_by_rank', 'scan', 512, 0, True, False),
        ('align', 999,
         ([4, 3], [41, 40], [511, 1], [511, 1], 999, 2, 449, 1)),
    ],
    'sparse_undecided_clip': [
        ('match_by_rank', 'scan', 128, 0, True, False),
        ('match_by_rank', 'scan', 2048, 0, False, True),
        ('align', 2048,
         ([5, 1], [48, 23], [1145, 6], [1165, 28], 1438, 6, 0, 7)),
    ],
    'sparse_undecided_samples': [
        ('match_by_rank', 'scan', 128, 0, True, False),
        ('match_by_rank', 'scan', 2048, 0, False, True),
        ('align', 2048,
         ([5, 1], [48, 23], [1145, 6], [1165, 28], 1438, 6, 0, 7)),
    ],
    'blocked_fallback': [
        ('match_by_rank', 'sort', 1024, 128, False, False),
        ('match_by_rank', 'sort', 1024, 0, False, False),
        ('align', 1024,
         ([6, 5], [55, 85], [939, 6], [953, 8], 982, 6, 0, 10)),
    ],
    'spanned_stacked': [
        ('match_query_sparse_spanned', 'sort', 64, 0, False, False),
        ('match_query_sparse_spanned', 'scan', 2048, 0, False, False),
        ('align', 2048,
         ([2, 1], [27, 133], [1019, 3], [1028, 6], 1054, 6, 0, 5)),
    ],
    'spanned_per_span': [
        ('match_query_sparse_spanned', 'sort', 64, 0, False, False),
        ('match_query_sparse_spanned', 'scan', 512, 0, False, False),
        ('align', 1054,
         ([2, 1], [27, 133], [1019, 3], [1028, 6], 1054, 6, 0, 5)),
    ],
    'spanned_stacked_decide': [
        ('match_query_sparse_spanned', 'scan', 128, 0, True, False),
        ('match_query_sparse_spanned', 'scan', 2048, 0, False, True),
        ('align', 2048,
         ([4, 2], [41, 16], [958, 3], [965, 11], 999, 6, 0, 3)),
    ],
    'spanned_clip': [
        ('recognize_on_device_spanned', 'sort', 16384, 0, False, False),
        ('align', 16384,
         ([3, 1], [34, 47], [954, 6], [984, 20], 1081, 6, 0, 6)),
    ],
    'batch_solo_retry': [
        ('match_queries_batched', 'dense', 64, 0, False, False),
        ('match_by_rank', 'dense', 4096, 0, False, False),
        ('align', 4096,
         ([1, 2], [20, 143], [1069, 6], [1082, 25], 1203, 6, 0, 6)),
        ('align', 64,
         ([0, 1], [-1024, -1024], [0, 0], [0, 0], 0, 0, 0, 0)),
        ('align', 64,
         ([0, 1], [-1024, -1024], [0, 0], [0, 0], 0, 0, 0, 0)),
    ],
    'batch_decide_first': [
        ('match_queries_batched', 'sort', 128, 0, False, False),
        ('match_queries_batched', 'sort', 2048, 0, False, False),
        ('align', 2048,
         ([1, 2], [20, 143], [1069, 6], [1082, 25], 1203, 6, 0, 6)),
        ('align', 2048,
         ([2, 1], [27, 133], [754, 3], [763, 4], 783, 6, 0, 5)),
        ('align', 2048,
         ([3, 1], [34, 47], [746, 6], [776, 20], 872, 6, 0, 6)),
        ('align', 2048,
         ([4, 2], [41, 16], [738, 3], [744, 9], 769, 6, 0, 3)),
    ],
}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_dispatch_sequence_is_pinned(regime, songs, monkeypatch):
    assert _record(monkeypatch, regime, songs) == PINNED[regime]
