"""Stereo clips through ``SIA.recognize_clip``'s single pass.

A (2, N) clip is fingerprinted as one B = 2 batch, the union of its two
rows' (hash, offset) pairs is deduped on the device and matched once
(the reference's one-shot recognizer, ``recognizer.py:355-382``). Its
answer must equal ``recognize_samples([L, R])`` in every ``RawMatch``
field and every key of the result, on the dense, sparse decide-first
(with and without an accepted clamp) and spanned stores; equal the JAX package's
``recognize_samples([L, R])``; and equal the benchmark's plain reference
(``benchmark_torch/reference``: the stereo union and ``match``). The
pass's query holds every lane of the clip's fingerprint, so a union of
any width is matched in the pass; a match clamped and not provably
decided goes on from the pass's query on the device (``sia.rematch``)
and still equals ``recognize_samples``; a channel past the peak capacity
hands off with its reason; more than two channels raise. The root span carries
``channels``, ``lanes`` and ``pairs``, the dedup span ``rows`` and
``query_capacity``, all set before the span closes.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from shazam_tpu_torch import profiling
from shazam_tpu_torch.api import SIA
from shazam_tpu_torch.audio import synth_song
from shazam_tpu_torch.config import FingerprintConfig

N_SONGS, SONG_S, CLIP_S = 8, 12.0, 5.0
FS, HOP = 44100, 2048
TIMING = ("fingerprint_time", "query_time", "align_time", "total_time")
SPARSE = dict(sparse_vote_threshold=0, bounds_probe_min_rows=1)
STORES = {
    "dense": dict(config={}),
    "sparse_decide": dict(config=dict(SPARSE, escalation_policy="decide")),
    "decide_no_accept": dict(config=dict(SPARSE, decision_escalation=False)),
    "spanned": dict(config={}, device_span_rows=4096),
}


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


def _mic(x, k, level=0.7, noise=1500.0):
    """A second microphone's take of ``x``: scaled, with its own noise."""
    rng = np.random.default_rng(k)
    y = level * x.astype(np.float64) + rng.normal(0.0, noise, len(x))
    return np.clip(y, -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def clips(songs):
    """{name: (2, N) int16 clip}: two mics of a catalog song, a clip whose
    channels hold two songs, silence and a song not in the catalog."""
    n = int(CLIP_S * FS)
    out = {}
    for i in (1, 4, 6):
        start = (20 + 7 * i) * HOP
        left = songs[i][1][start: start + n]
        out[f"mics{i}"] = np.stack([left, _mic(left, i)])
    a, b = songs[2][1][10 * HOP: 10 * HOP + n], songs[5][1][40 * HOP:
                                                          40 * HOP + n]
    out["two_songs"] = np.stack([a, b])
    out["silence"] = np.zeros((2, 3 * FS), np.int16)
    other = synth_song(999, CLIP_S, seed=123)
    out["unknown"] = np.stack([other, _mic(other, 9)])
    return out


def _strip(res):
    return {k: v for k, v in res.items() if k not in TIMING}


def _sia(store, songs):
    spec = dict(STORES[store])
    sia = SIA(config=FingerprintConfig(**spec.pop("config")), device="cpu",
              **spec)
    sia.ingest_arrays(songs)
    return sia


@pytest.fixture(scope="module")
def engines(songs):
    return {name: _sia(name, songs) for name in STORES}


def _raw_of(monkeypatch):
    """The host RawMatch that every call hands to ``align_results``."""
    import shazam_tpu_torch.api as api

    seen = []
    real = api.align_results

    def spy(raw, *a, **k):
        seen.append((raw, k.get("match_capacity")))
        return real(raw, *a, **k)

    monkeypatch.setattr(api, "align_results", spy)
    return seen


@pytest.mark.parametrize("store", list(STORES))
def test_stereo_clip_equals_recognize_samples(engines, clips, store,
                                              monkeypatch):
    sia = engines[store]
    seen = _raw_of(monkeypatch)
    one_pass = 0
    for name, clip in clips.items():
        seen.clear()
        got = sia.recognize_clip(clip)
        one_pass += got["query_time"] == 0.0
        clip_raw = seen[-1][0]
        seen.clear()
        want = sia.recognize_samples([clip[0], clip[1]])
        assert _strip(got) == _strip(want), name
        if not want["results"]:
            continue
        (raw, _cap), = seen
        for field in raw._fields:
            assert np.array_equal(np.asarray(getattr(clip_raw, field)),
                                  np.asarray(getattr(raw, field))), (name,
                                                                     field)
        if name.startswith("mics"):
            i = int(name[4:])
            assert got["results"][0]["song_name"] == f"song{i}"
    assert one_pass >= 4, one_pass        # the single pass answered them


def test_dual_mono_gives_the_mono_answer(engines, clips):
    sia = engines["dense"]
    mono = clips["mics4"][0]
    assert (_strip(sia.recognize_clip(np.stack([mono, mono])))
            == _strip(sia.recognize_clip(mono)))


def _handoffs(monkeypatch):
    calls = []
    real = SIA.recognize_samples

    def spy(self, channels, topn=None):
        calls.append(len(channels))
        return real(self, channels, topn=topn)

    monkeypatch.setattr(SIA, "recognize_samples", spy)
    return calls


def _records_of(fn, monkeypatch):
    """(fn's result, the span records it made under a CPU profiler, each
    with its attributes as they were when the span closed)."""
    recs = []
    add = profiling._add

    def closed(rec):
        recs.append(rec._replace(attrs=dict(rec.attrs)))
        add(rec)

    monkeypatch.setattr(profiling, "_add", closed)
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    monkeypatch.setattr(profiling, "_add", add)
    return out, recs


def _continued(recs, reason):
    """The one ``sia.rematch`` record under the clip's root, with
    ``reason``; no ``sia.handoff``, no host dedup (``query.prepare``) and
    no second fingerprint (``fp.peaks``) anywhere in the clip."""
    (root,) = [r for r in recs if r.name == "sia.recognize_clip"]
    (rematch,) = [r for r in recs if r.name == "sia.rematch"]
    assert rematch.parent == root.index
    assert rematch.attrs["reason"] == reason
    names = [r.name for r in recs]
    assert "sia.handoff" not in names and "query.prepare" not in names
    assert names.count("fp.peaks") == 1
    return root, rematch


def test_a_union_past_the_lanes_hands_off(engines, monkeypatch):
    """White noise fills a channel with peaks: two 12 s channels of it
    pass 2 x 4,096 lanes, the stereo pass's query before it held every
    lane. Nothing is handed on: the pass dedups all 2 x 32,768 lanes of
    the fingerprint once, matches them once, and its answer and
    ``RawMatch`` equal ``recognize_samples``'."""
    sia = engines["dense"]
    rng = np.random.default_rng(0)
    noise = rng.normal(0, 8000, (2, 12 * FS)).astype(np.float32)
    calls = _handoffs(monkeypatch)
    seen = _raw_of(monkeypatch)
    got, recs = _records_of(lambda: sia.recognize_clip(noise),
                            monkeypatch)
    assert calls == []
    names = [r.name for r in recs]
    assert "sia.handoff" not in names and "sia.rematch" not in names
    (root,) = [r for r in recs if r.name == "sia.recognize_clip"]
    assert root.attrs["lanes"] > 8192
    assert [r.attrs["query_capacity"] for r in recs
            if r.name == "match.dedup"] == [65536]
    assert root.attrs["pairs"] == got["input_hashes"] > 8192
    (clip_raw, _cap), = seen
    seen.clear()
    assert _strip(got) == _strip(sia.recognize_samples(list(noise)))
    (raw, _cap), = seen
    for field in raw._fields:
        assert np.array_equal(np.asarray(getattr(clip_raw, field)),
                              np.asarray(getattr(raw, field))), field


@pytest.fixture(scope="module")
def long_songs():
    return [(f"song{i}", synth_song(i, 20.0, seed=300 + i))
            for i in range(4)]


# undecided: every clamp of the 64-row fast tier goes on up the tiers;
# lanes: a fan value of 15 and 0 dB noise put a clip's lanes past 4,096
# a row, the pass's query width before it held every fingerprint lane,
# at the fast tier and (lanes_decide) at the decide tier of a big index
CONTINUED = {"undecided": dict(match_capacity_fast=64,
                               decision_escalation=False),
             "lanes": dict(fan_value=15),
             "lanes_decide": dict(SPARSE, fan_value=15,
                                  escalation_policy="decide")}
OLD_ROW_LANES = 4096


@pytest.fixture(scope="module")
def continued_engines(long_songs):
    out = {}
    for reason, cfg in CONTINUED.items():
        sia = SIA(config=FingerprintConfig(**cfg), device="cpu")
        sia.ingest_arrays(long_songs)
        out[reason] = sia
    return out


def _noisy(x, k):
    """``x`` under white noise of its own power (0 dB SNR)."""
    x = x.astype(np.float64)
    y = x + np.random.default_rng(k).normal(0.0, x.std(), x.shape)
    return y.astype(np.float32)


def _listen_clip(songs, shape, k, noisy):
    """A 15 s mono or a 5 s stereo clip of song ``k``, clean or at 0 dB
    SNR."""
    song = songs[k][1]
    if shape == "mono15":
        rows = [song[2 * FS: 17 * FS]]
    else:
        part = song[3 * FS: 8 * FS]
        rows = [part, _mic(part, k)]
    if noisy:
        rows = [_noisy(r, k + 50 * j) for j, r in enumerate(rows)]
    return rows[0] if shape == "mono15" else np.stack(rows)


@pytest.mark.parametrize("reason", list(CONTINUED))
@pytest.mark.parametrize("shape", ["mono15", "stereo5"])
def test_continued_clip_equals_recognize_samples(continued_engines,
                                                 long_songs, shape, reason,
                                                 monkeypatch):
    """A clip the single pass cannot answer goes on on the device, with
    no ``recognize_samples`` call, and its result and ``RawMatch`` equal
    ``recognize_samples`` of its channels: mono and stereo alike. A clip
    past the old query width is deduped and matched once in the pass,
    and goes on only as ``undecided``."""
    sia = continued_engines[reason]
    wide = reason != "undecided"
    clip = _listen_clip(long_songs, shape, 1, noisy=wide)
    calls = _handoffs(monkeypatch)
    seen = _raw_of(monkeypatch)
    got, recs = _records_of(lambda: sia.recognize_clip(clip), monkeypatch)
    assert calls == []
    names = [r.name for r in recs]
    assert names.count("match.dedup") == 1
    rematches = [r for r in recs if r.name == "sia.rematch"]
    if wide:
        (root,) = [r for r in recs if r.name == "sia.recognize_clip"]
        assert root.attrs["lanes"] > OLD_ROW_LANES * root.attrs["channels"]
        assert "sia.handoff" not in names
    else:
        rematches = [_continued(recs, reason)[1]]
    assert all(r.attrs["reason"] == "undecided" for r in rematches)
    (clip_raw, clip_cap), = seen
    assert all(r.attrs["cap"] == clip_cap for r in rematches)
    seen.clear()
    want = sia.recognize_samples(list(np.atleast_2d(clip)))
    assert _strip(got) == _strip(want)
    assert got["results"][0]["song_name"] == "song1"
    (raw, cap), = seen
    assert cap == clip_cap
    for field in raw._fields:
        assert np.array_equal(np.asarray(getattr(clip_raw, field)),
                              np.asarray(getattr(raw, field))), field


def test_decide_first_continuation_adapts_as_the_handoff(long_songs):
    """On a store counted as big (decided-first at a 64-row decide tier
    over a window of 4), the continued clips give the answers and leave
    the decide tier's statistics and boost that handing them to
    ``recognize_samples`` leaves. The window records a clip only when its
    pass is continued (clamped and not decided: one undecided attempt),
    whatever its lanes; a pass that is decided or fits is not recorded."""
    cfg = FingerprintConfig(**SPARSE, escalation_policy="decide",
                            match_capacity_fast=64, match_capacity=256,
                            decide_capacity=64, decide_adapt_window=4)
    sia, twin = SIA(config=cfg, device="cpu"), SIA(config=cfg, device="cpu")
    for engine in (sia, twin):
        engine.ingest_arrays(long_songs)
    recorded = []
    record = sia.decide.record
    sia.decide.record = lambda c, a, u: (recorded.append((a, u)),
                                         record(c, a, u))
    clips = [_listen_clip(long_songs, shape, k, noisy)
             for k in range(len(long_songs))
             for shape in ("mono15", "stereo5") for noisy in (False, True)]
    clips += [long_songs[k][1][FS: 6 * FS] for k in range(len(long_songs))]
    continued = 0
    for clip in clips:
        # the twin hands the clip to recognize_samples, as the
        # continuation's callers did before it
        twin._rematch = (lambda *a, clip=clip, topn=None, **k:
                         twin.recognize_samples(list(np.atleast_2d(clip))))
        got, recs = _records_of(lambda: sia.recognize_clip(clip),
                                pytest.MonkeyPatch())
        continued += any(r.name == "sia.rematch" for r in recs)
        assert _strip(got) == _strip(twin.recognize_clip(clip))
        assert sia.decide.state() == twin.decide.state()
    assert continued >= 4 and sia.decide.state()[1] > 0
    assert recorded == [(1, 1)] * continued


def test_a_channel_past_the_peak_capacity_hands_off(songs, monkeypatch):
    """One loud channel past ``peak_capacity``, one silent: the clip hands
    off with reason ``peaks`` and answers as recognize_samples."""
    sia = SIA(config=FingerprintConfig(peak_capacity=64), device="cpu")
    sia.ingest_arrays(songs[:3])
    left = songs[1][1][30 * HOP: 30 * HOP + int(CLIP_S * FS)]
    clip = np.stack([np.zeros_like(left), left])
    calls = _handoffs(monkeypatch)
    got, recs = _records_of(lambda: sia.recognize_clip(clip),
                            monkeypatch)
    assert calls == [2]
    (handoff,) = [r for r in recs if r.name == "sia.handoff"]
    assert handoff.attrs == {"reason": "peaks"}
    assert got["results"][0]["song_name"] == "song1"
    assert _strip(got) == _strip(sia.recognize_samples([clip[0], clip[1]]))


@pytest.mark.parametrize("shape", [(3, 4410), (2, 2, 4410)])
def test_more_than_two_channels_raise(engines, shape):
    with pytest.raises(ValueError, match="recognize_samples"):
        engines["dense"].recognize_clip(np.zeros(shape, np.int16))


def test_stereo_clip_matches_jax_recognize_samples(engines, songs, clips):
    from shazam_tpu.api import SIA as JaxSIA

    ref = JaxSIA()
    ref.ingest_arrays(songs)
    for name in ("mics1", "two_songs", "unknown"):
        clip = clips[name]
        want = _strip(ref.recognize_samples([clip[0], clip[1]]))
        assert _strip(engines["dense"].recognize_clip(clip)) == want, name


def test_stereo_clip_matches_the_plain_reference(engines, songs, clips):
    """The benchmark's plain reference (its catalog rows, the stereo union
    of ``reference/stereo.py`` and ``reference/match.py``) gives each
    clip's answer and counts exactly."""
    from benchmark_torch.lib import check, refrun
    from benchmark_torch.reference.fingerprint import Fingerprinter
    from benchmark_torch.reference.match import Catalog, match
    from benchmark_torch.reference.stereo import union_rows

    fp = Fingerprinter({}, *refrun.PRECISIONS[refrun.REFERENCE])
    n = len(songs[0][1])
    audio = torch.from_numpy(np.stack([s for _, s in songs])).float()
    cat = Catalog(*fp.rows(audio, n))
    for name, clip in clips.items():
        key, t1 = union_rows(fp, torch.from_numpy(clip).float(),
                             clip.shape[1])
        ref = match(cat, key, t1)
        got = engines["dense"].recognize_clip(clip)
        wrong, gap, why = check.answer_gap(got, ref,
                                           lambda s: int(s[4:]))
        assert (wrong, gap) == (0, 0.0), (name, why)


def test_span_attributes_are_set_inside_the_span(engines, clips,
                                                 monkeypatch):
    """The root's ``channels``, and its ``lanes`` and ``pairs`` after the
    read-back, and the dedup's ``rows`` and ``query_capacity`` are in
    each record when it is written."""
    from shazam_tpu_torch.match import ondevice

    inner = ondevice._fingerprint_clip
    fps = []

    def capture(*a, **k):
        fps.append(inner(*a, **k))
        return fps[-1]

    monkeypatch.setattr(ondevice, "_fingerprint_clip", capture)
    sia = engines["dense"]
    lanes = (sia.config.fan_value - 1) * sia.config.peak_capacity
    for clip, rows, cap in ((clips["mics1"], 2, 2 * lanes),
                            (clips["mics1"][0], 1, lanes)):
        fps.clear()
        got, recs = _records_of(lambda: sia.recognize_clip(clip),
                                monkeypatch)
        (root,) = [r for r in recs if r.name == "sia.recognize_clip"]
        (dedup,) = [r for r in recs if r.name == "match.dedup"]
        assert root.attrs == {"channels": rows,
                              "lanes": int(fps[0].valid.sum()),
                              "pairs": got["input_hashes"]}
        assert dedup.attrs == {"rows": rows, "query_capacity": cap}
    assert fps[0].hi.shape[0] == 1


@pytest.mark.parametrize("engine", list(CONTINUED))
@pytest.mark.parametrize("shape", ["mono15", "stereo5"])
def test_the_pass_query_holds_every_fingerprint_lane(continued_engines,
                                                     long_songs, shape,
                                                     engine, monkeypatch):
    """The single pass sizes its query from the clip's rows and the
    config alone, rows x (fan_value - 1) x peak_capacity, the lanes of
    the fingerprint it builds, so no clip's lanes pass it: its one
    ``match.dedup`` span carries that width, and no pass is continued or
    handed off for its lanes."""
    from shazam_tpu_torch.match import ondevice

    sia = continued_engines[engine]
    cfg = sia.config
    fps, reasons = [], []
    inner, why = ondevice._fingerprint_clip, SIA._handoff_reason
    monkeypatch.setattr(ondevice, "_fingerprint_clip",
                        lambda *a, **k: fps.append(inner(*a, **k)) or fps[-1])
    monkeypatch.setattr(SIA, "_handoff_reason", lambda self, *a:
                        reasons.append(why(self, *a)) or reasons[-1])
    clip = _listen_clip(long_songs, shape, 2, noisy=True)
    rows = len(np.atleast_2d(clip))
    _got, recs = _records_of(lambda: sia.recognize_clip(clip), monkeypatch)
    (dedup,) = [r for r in recs if r.name == "match.dedup"]
    assert dedup.attrs == {
        "rows": rows,
        "query_capacity": rows * (cfg.fan_value - 1) * cfg.peak_capacity}
    assert dedup.attrs["query_capacity"] == fps[0].hi.numel()
    assert len(reasons) == 1 and reasons[0] in (None, "undecided")
    assert all(r.attrs["reason"] == "undecided" for r in recs
               if r.name in ("sia.rematch", "sia.handoff"))
