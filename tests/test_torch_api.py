"""Port parity for the public surface: config files, ``SIA`` signatures,
``q_pad_to`` and the backend registry.

A config file either package writes loads in the other (the JAX
package's ``to_json`` through the port's CLI, the port's through JAX's
``from_json``); every public method the two ``SIA`` classes share takes
JAX's parameters in JAX's order as its positional ones, the port's own
keyword-only; ``q_pad_to`` raises the query padding and never changes an
answer; ``index/registry.py`` mirrors ``tests/test_aux.py``.
"""

import dataclasses
import inspect
import json
import os

import numpy as np
import pytest
import torch

from shazam_tpu_torch import cli
from shazam_tpu_torch.api import SIA
from shazam_tpu_torch.audio import synth_song
from shazam_tpu_torch.config import DEFAULT_CONFIG, FIXED, FingerprintConfig

FS = 44100


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def built():
    sia = SIA(device="cpu")
    sia.ingest_arrays([(f"s{i}", synth_song(i, duration_s=6.0, seed=11))
                       for i in range(4)])
    return sia


def _clip(i, start_s=1.0, secs=4.0):
    song = synth_song(i, duration_s=6.0, seed=11)
    return song[int(start_s * FS): int((start_s + secs) * FS)]


def _strip(res):
    return [{k: v for k, v in r.items()} for r in res["results"]], \
        res["total_matches"], res["input_hashes"], res["overflowed"]


# ---- config files ----------------------------------------------------------
def test_jax_config_file_loads_through_the_port_cli(tmp_path):
    from shazam_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT
    from shazam_tpu.config import FingerprintConfig as JaxConfig

    path = tmp_path / "jax.json"
    path.write_text(JAX_DEFAULT.to_json())
    assert cli.load_config(str(path)) == DEFAULT_CONFIG
    path.write_text(JaxConfig(fan_value=7, amp_min=12.0, topn=5,
                              vote_rank="sort").to_json())
    assert cli.load_config(str(path)) == FingerprintConfig(
        fan_value=7, amp_min=12.0, topn=5, vote_rank="sort")


def test_config_json_roundtrip(tmp_path):
    """The port's mirror of ``tests/test_aux.py::test_config_json_roundtrip``
    with the derived quantities held to the JAX package's."""
    from shazam_tpu.config import FingerprintConfig as JaxConfig

    cfg = FingerprintConfig(fan_value=7, amp_min=12.0, topn=5)
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    back = FingerprintConfig.from_json(path.read_text())
    assert back == cfg
    assert back.hop == 2048 and back.n_freqs == 2049
    assert back.frames_to_seconds(43) == round(43 / 44100 * 4096 * 0.5, 5)
    jax_cfg = JaxConfig(fan_value=7, amp_min=12.0, topn=5,
                        peak_neighborhood_size=7, window_size=2048)
    port = cfg.replace(peak_neighborhood_size=7, window_size=2048)
    assert port.neighborhood_width == jax_cfg.neighborhood_width == 15
    assert port.n_freqs == jax_cfg.n_freqs == 1025
    for n in (0, 2047, 2048, 2049, 44100, 441001):
        assert port.num_frames(n) == jax_cfg.num_frames(n)


def test_jax_reads_the_port_config_file():
    """JAX's ``from_json`` of the port's ``to_json``: equal field by field
    (the two files are the same text)."""
    from shazam_tpu.config import FingerprintConfig as JaxConfig

    kw = dict(fan_value=7, amp_min=12.0, topn=5, vote_rank="scan",
              decision_escalation=False, sparse_vote_threshold=1000)
    port = FingerprintConfig(**kw)
    jax_cfg = JaxConfig.from_json(port.to_json())
    for f in dataclasses.fields(JaxConfig):
        assert getattr(jax_cfg, f.name) == getattr(port, f.name), f.name
    assert port.to_json() == JaxConfig(**kw).to_json()


@pytest.mark.parametrize("field,value", [
    ("hash_capacity", 4), ("connectivity_mask", 1), ("peak_sort", False),
    ("fingerprint_reduction", 10), ("spectrogram_dtype", "bfloat16")])
def test_fixed_fields_refuse_other_values(field, value, tmp_path):
    """The five fields the port takes only at the JAX package's default:
    any other value is refused by the config and by the CLI."""
    assert getattr(DEFAULT_CONFIG, field) == FIXED[field]
    with pytest.raises(ValueError, match=field):
        FingerprintConfig(**{field: value})
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({field: value}))
    with pytest.raises(SystemExit, match=field):
        cli.load_config(str(path))


# ---- signatures --------------------------------------------------------------
def _public(cls):
    return {n for n, v in vars(cls).items()
            if callable(v) and (not n.startswith("_") or n == "__init__")}


def test_public_sia_signatures_follow_jax():
    """Every public method of the JAX package's SIA exists in the port, and
    JAX's parameters, names and order, are the port's positional ones; the
    port's own parameters are keyword-only."""
    from shazam_tpu.api import SIA as JaxSIA

    assert _public(JaxSIA) <= _public(SIA)
    for name in sorted(_public(JaxSIA)):
        want = list(inspect.signature(getattr(JaxSIA, name)).parameters)
        params = inspect.signature(getattr(SIA, name)).parameters.values()
        got = [p.name for p in params
               if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD]
        assert got == want, name
        assert all(p.kind is not inspect.Parameter.VAR_POSITIONAL
                   for p in params), name


def test_positional_construction_means_what_it_means_in_jax():
    cfg = FingerprintConfig()
    resident = SIA(cfg, ":memory:", None, True, device="cpu")
    assert resident.device_resident and not resident.device_span_rows
    spanned = SIA(cfg, ":memory:", None, False, 0, 4096, device="cpu")
    assert spanned.device_resident and spanned.device_span_rows == 4096
    with pytest.raises(TypeError):
        SIA(cfg, ":memory:", None, False, 0, 0, True, "cpu")


# ---- q_pad_to ------------------------------------------------------------------
def test_q_pad_to_raises_the_padding_and_never_lowers_it(built, monkeypatch):
    clip = _clip(2)
    seen = []
    orig = SIA._match_prepared

    def spy(self, q, *a, **k):
        seen.append(len(q.hi))
        return orig(self, q, *a, **k)

    monkeypatch.setattr(SIA, "_match_prepared", spy)
    plain = built.recognize_samples([clip])
    padded = built.recognize_samples([clip], None, False, 8192)
    lowered = built.recognize_samples([clip], q_pad_to=16)
    natural = seen[0]
    assert natural < 8192 and seen == [natural, 8192, natural]
    assert _strip(plain) == _strip(padded) == _strip(lowered)
    assert plain["results"][0]["song_name"] == "s2"


def test_batch_q_pad_to_is_the_fourth_argument(built):
    """``recognize_batch(clips, topn, pad_to_pow2, q_pad_to)``: the JAX
    package's order. The stack is padded, never narrowed, and the answers
    are the unpadded batch's."""
    clips = [_clip(0), _clip(3, 0.5)]
    pb = built.prepare_batch(clips, None, False, 8192)
    assert pb.stack["hi"].shape == (2, 8192)
    assert pb.match_capacity is None
    natural = built.prepare_batch(clips).stack["hi"].shape[1]
    assert built.prepare_batch(clips, q_pad_to=16).stack["hi"].shape[1] \
        == natural < 8192
    want = [_strip(r) for r in built.recognize_batch(clips)]
    assert [_strip(r) for r in built.match_prepared_batch(pb)] == want
    assert [_strip(r) for r in built.recognize_batch(clips, None, True,
                                                     4096)] == want


def test_warmup_pads_queries_as_jax_does(built, monkeypatch):
    """``serve.warmup`` runs its silent clip at JAX's "auto" pair buckets
    through ``q_pad_to``: 1,024 and twice the warm clip's bucket, less the
    buckets the warm clips already took."""
    from shazam_tpu_torch.serve import warmup

    pads = {"samples": [], "batch": []}
    orig_s, orig_b = SIA.recognize_samples, SIA.recognize_batch

    def samples(self, channels, topn=None, early_exit=False, q_pad_to=None):
        out = orig_s(self, channels, topn, early_exit, q_pad_to)
        pads["samples"].append((q_pad_to, out["input_hashes"]))
        return out

    def batch(self, clips, topn=None, pad_to_pow2=False, q_pad_to=None,
              match_capacity=None):
        pads["batch"].append(q_pad_to)
        return orig_b(self, clips, topn, pad_to_pow2, q_pad_to,
                      match_capacity)

    monkeypatch.setattr(SIA, "recognize_samples", samples)
    monkeypatch.setattr(SIA, "recognize_batch", batch)
    warmup(built, seconds=2.0, max_batch=2)
    (first, n_pairs), *rest = pads["samples"]
    natural = 1 << max(n_pairs - 1, 1023).bit_length()
    want = sorted({1024, 2 * natural} - {natural})
    assert first is None and [p for p, _ in rest] == want
    assert all(n == 0 for _, n in rest)          # the silent clip
    assert pads["batch"] == [None, None] + [p for p in want for _ in (1, 2)]


# ---- registry ------------------------------------------------------------------
def test_backend_registry(tmp_path):
    """The port's mirror of ``tests/test_aux.py::test_backend_registry``."""
    from shazam_tpu_torch.index.registry import get_backend, register_backend

    mem = get_backend("memory")("", device="cpu")
    assert mem.index.n_hashes == 0 and mem.device == torch.device("cpu")

    local = get_backend("local")(str(tmp_path / "cat"), device="cpu")
    assert os.path.exists(str(tmp_path / "cat.sqlite"))
    local.ingest_arrays([("s0", synth_song(0, duration_s=4.0, seed=3))])
    local.save_index(str(tmp_path / "cat.npz"))
    again = get_backend("local")(str(tmp_path / "cat"), device="cpu")
    assert again.index.n_hashes == local.index.n_hashes > 0
    cfg = FingerprintConfig(topn=3)
    assert get_backend("local")(str(tmp_path / "cat"), cfg,
                                device="cpu").config is cfg

    with pytest.raises(TypeError, match="Unsupported backend"):
        get_backend("postgres")  # the reference's dangling backend

    register_backend("custom", "shazam_tpu_torch.index.registry",
                     "_memory_backend")
    assert get_backend("custom")("", device="cpu").index.n_hashes == 0
    with pytest.raises(TypeError):
        get_backend("memory")("", None, "cpu")   # device is keyword-only
    np.testing.assert_array_equal(again.index.key_hi, local.index.key_hi)
