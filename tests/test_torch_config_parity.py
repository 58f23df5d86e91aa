"""Port parity for NON-reference configs, and the choice of pipeline.

The kernels (K1 -> K2 -> K3) are compiled for the reference window (4096)
and peak radius (10). ``api._fused_ok`` admits a config to them, as the
JAX package's ``_fused_ok`` does; any other config takes the plain
``fingerprint_batch`` on the same device. These tests hold the port's
fingerprints against the JAX package's for the custom configs of
``tests/test_config_parity.py`` plus a window wider than the reference's
(8192: 4097 bins, past the kernels' 65 mask words), and a custom-config
catalog end to end through ``SIA(device="cpu")``.
"""

import numpy as np
import pytest
import torch

from shazam_tpu_torch import api
from shazam_tpu_torch.audio import synth_song
from shazam_tpu_torch.config import FingerprintConfig

CONFIGS = {
    # the three of tests/test_config_parity.py
    "small-win": dict(sample_rate=22050, window_size=2048,
                      peak_neighborhood_size=5, amp_min=5.0, fan_value=8),
    "tiny-win": dict(sample_rate=44100, window_size=1024,
                     peak_neighborhood_size=3, amp_min=15.0, fan_value=3,
                     max_hash_time_delta=100),
    "dense-hop": dict(sample_rate=44100, window_size=4096, overlap_ratio=0.75,
                      peak_neighborhood_size=10, amp_min=10.0, fan_value=5,
                      min_hash_time_delta=2),
    # wider than the reference window: more bins than the kernels' words
    "wide-win": dict(window_size=8192),
}
SMALL_WIN = CONFIGS["small-win"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs files in parallel worker processes: torch's CPU ops
    here use one thread so that the workers do not oversubscribe cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_custom_config_matches_jax(name):
    from shazam_tpu.config import FingerprintConfig as JaxConfig
    from shazam_tpu.ops.fingerprint import fingerprint as jax_fingerprint
    from shazam_tpu.ops.fingerprint import (
        fingerprint_to_hex_pairs as jax_hex_pairs)

    from shazam_tpu_torch.ops.fingerprint import (fingerprint,
                                                  fingerprint_to_hex_pairs)

    kw = CONFIGS[name]
    cfg = FingerprintConfig(**kw)
    clip = np.asarray(synth_song(9, duration_s=2.5, fs=cfg.sample_rate,
                                 seed=77), dtype=np.float32)
    fp = fingerprint(clip, config=cfg, device="cpu")
    jfp = jax_fingerprint(clip, config=JaxConfig(**kw))
    n, jn = int(fp.n_peaks), int(jfp.n_peaks)
    assert 0 < jn <= cfg.peak_capacity
    assert abs(n - jn) <= 0.01 * jn, (n, jn)
    ours, ref = set(fingerprint_to_hex_pairs(fp)), set(jax_hex_pairs(jfp))
    assert ref
    jaccard = len(ours & ref) / len(ours | ref)
    assert jaccard > 0.98, (jaccard, len(ours), len(ref))


@pytest.mark.parametrize("name,fused", [("reference", True),
                                        ("small-win", False),
                                        ("tiny-win", False),
                                        ("dense-hop", True),
                                        ("wide-win", False)])
def test_fused_ok_admits_only_the_kernels_configs(name, fused):
    cfg = FingerprintConfig(**CONFIGS.get(name, {}))
    assert api._fused_ok(cfg) is fused


def test_fused_ok_refuses_a_non_positive_gate():
    assert not api._fused_ok(FingerprintConfig(amp_min=0.0))


@pytest.mark.parametrize("name", ["reference", "small-win"])
def test_sia_takes_the_pipeline_its_config_admits(name, monkeypatch):
    """Ingest and recognize_clip call the kernels' pipeline exactly for a
    config that ``_fused_ok`` admits, the plain one otherwise."""
    from shazam_tpu_torch.match import ondevice
    from shazam_tpu_torch.ops import fingerprint as fpmod

    calls = {"fused": 0, "plain": 0}

    def spy(kind, fn):
        def wrapped(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return wrapped

    for mod in (api, ondevice):
        monkeypatch.setattr(mod, "fingerprint_batch_fused",
                            spy("fused", fpmod.fingerprint_batch_fused))
        monkeypatch.setattr(mod, "fingerprint_batch",
                            spy("plain", fpmod.fingerprint_batch))
    cfg = FingerprintConfig(**CONFIGS.get(name, {}))
    fs = cfg.sample_rate
    songs = [(f"s{i}", synth_song(i, duration_s=6.0, fs=fs, seed=13))
             for i in range(2)]
    sia = api.SIA(config=cfg, device="cpu")
    sia.ingest_arrays(songs)
    out = sia.recognize_clip(np.asarray(songs[1][1])[fs: 4 * fs])
    assert out["results"][0]["song_name"] == "s1"
    want = "fused" if name == "reference" else "plain"
    other = "plain" if name == "reference" else "fused"
    assert calls[want] >= 2 and calls[other] == 0, calls


def test_custom_config_end_to_end_recognition():
    """A catalog built under a custom config identifies clips through both
    recognition entry points, with the JAX package's answer."""
    from shazam_tpu.api import SIA as JaxSIA
    from shazam_tpu.config import FingerprintConfig as JaxConfig

    cfg = FingerprintConfig(**SMALL_WIN)
    sia = api.SIA(config=cfg, device="cpu")
    songs = [(f"s{i}", synth_song(i, duration_s=6.0, fs=22050, seed=13))
             for i in range(3)]
    sia.ingest_arrays(songs)
    ref = JaxSIA(config=JaxConfig(**SMALL_WIN))
    ref.ingest_arrays(songs)
    for name in ("key_hi", "key_lo", "key_ex", "song_id", "offset"):
        assert np.array_equal(getattr(sia.index, name),
                              getattr(ref.index, name))
    clip = np.asarray(songs[2][1])[22050: 4 * 22050]
    want = ref.recognize_samples([clip])["results"][0]
    for out in (sia.recognize_samples([clip]), sia.recognize_clip(clip)):
        top = out["results"][0]
        assert top["song_name"] == "s2" == want["song_name"]
        assert top["offset"] == want["offset"]


@pytest.mark.parametrize("field,value,instead", [
    ("escalation_policy", "bounds", "one big-index policy, decide-first"),
    ("vote_rank", "pruned", "no pruned rank: 'sort', 'scan', or 'auto'"),
    ("rank_candidates", 2, "ranks with the sort or scan rank"),
    ("rank_candidates", 0, "ranks with the sort or scan rank"),
])
def test_config_refuses_a_deleted_path(field, value, instead):
    """A value that names a JAX path the port does not have (its
    bounds-first escalation, its pruned rank and that rank's candidate
    count) is refused, in a config and in a JAX config file, with what the
    port runs instead; the JAX package takes it."""
    import re

    from shazam_tpu.config import FingerprintConfig as JaxConfig

    jax_cfg = JaxConfig(**{field: value})
    for make in (lambda: FingerprintConfig(**{field: value}),
                 lambda: FingerprintConfig.from_json(jax_cfg.to_json())):
        with pytest.raises(ValueError, match=re.escape(instead)):
            make()


@pytest.mark.parametrize("field,values", [
    ("escalation_policy", ("auto", "decide")),
    ("vote_rank", ("auto", "sort", "scan")),
])
def test_config_takes_the_kept_paths(field, values):
    for value in values:
        assert getattr(FingerprintConfig(**{field: value}), field) == value
