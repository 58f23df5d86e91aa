"""Port parity for the recognition sweep, its report, the profiling
utilities, the plot tool and the CLI's ``bench`` and ``plot``.

``bench/report.py`` writes its files with ``csv`` and numpy where the JAX
package's uses pandas and scikit-learn: the five files must be the same
bytes and the returned paths equal. ``bench/harness.py`` draws from one
seeded generator in the JAX package's order, so on
``tests/test_harness.py``'s corpus the JAX ``SIA()`` and the port's
``SIA(device="cpu")`` see the same clips in every mode (clean, AWGN, a
noise file, the acoustic channel) and give the same rows, bar the times.
"""

import csv
import datetime
import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from shazam_tpu.bench import harness as jharness
from shazam_tpu.bench import report as jreport
from shazam_tpu_torch.bench import harness as tharness
from shazam_tpu_torch.bench import report as treport

N_SONGS = 4
DUR = 10.0
NOW = datetime.datetime(2026, 3, 4, 5, 6, 7)
TIME_COLS = ("fingerprint_times", "query_time", "align_time", "total_time")
KINDS = ("results", "cm", "cmsk", "crsk", "assk")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs files in parallel worker processes: torch's CPU ops
    here use one thread so that the workers do not oversubscribe cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _FixedNow(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return NOW


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both reports stamp their file names with the same time."""
    for mod in (jreport, treport):
        monkeypatch.setattr(mod, "datetime",
                            types.SimpleNamespace(datetime=_FixedNow))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from shazam_tpu_torch.audio.synth import synth_corpus

    d = tmp_path_factory.mktemp("hcorpus")
    return [f for f, _ in synth_corpus(str(d), N_SONGS, duration_s=DUR,
                                       seed=21)]


@pytest.fixture(scope="module")
def engines(corpus):
    from shazam_tpu import SIA as JSIA
    from shazam_tpu_torch.api import SIA

    jsia = JSIA()
    jsia.ingest_files(corpus, batch_size=4)
    tsia = SIA(device="cpu")
    tsia.ingest_files(corpus, batch_size=4)
    return jsia, tsia


@pytest.fixture(scope="module")
def noise_path(tmp_path_factory):
    from shazam_tpu_torch.audio.io import write_wav

    rng = np.random.default_rng(8)
    noise = np.clip(rng.normal(0, 0.3, 44100 * 20) * 32767, -32768, 32767)
    path = str(tmp_path_factory.mktemp("noise") / "noise.wav")
    write_wav(path, noise.astype(np.int16), 44100)
    return path


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _trials(rng, n, names):
    songs = [f"/corpus/{n_}.wav" for n_ in names]
    times = [{"song_start_time": int(rng.integers(0, 200)),
              "fingerprint_times": float(rng.random()),
              "query_time": float(rng.random()) / 7,
              "align_time": 1e-5 * (i + 1), "total_time": 0.1 * i + 0.3}
             for i in range(n)]
    return songs, times


def _predictions(rng, names, kind):
    if kind == "all_right":
        return list(names)
    if kind == "wrong_and_unseen":
        return [names[1], names[0], "track999999"] + list(names[3:])
    if kind == "no_results":
        return ["No results"] + list(names[1:-1]) + ["No results"]
    pred = []
    for name in names:
        u = rng.random()
        pred.append(name if u < 0.7 else "No results" if u < 0.8
                    else f"track{int(rng.integers(0, 140)):06d}")
    return pred


@pytest.mark.parametrize("snr", (None, 0.0, -5.0))
@pytest.mark.parametrize("kind,n", (("all_right", 5),
                                    ("wrong_and_unseen", 6),
                                    ("no_results", 5), ("random", 100)))
def test_report_files_byte_equal(tmp_path, kind, n, snr):
    rng = np.random.default_rng(n)
    names = [f"track{i:06d}" for i in range(n)]
    songs, times = _trials(rng, n, names)
    pred = _predictions(rng, names, kind)
    finals = [str([{"song_name": p, "offset": i}]) for i, p in enumerate(pred)]
    for it in sorted({0, n // 2, n - 1}):    # checkpoints of a sweep
        args = (songs[: it + 1], pred[: it + 1], times[: it + 1],
                finals[: it + 1], it)
        kw = dict(out_dir=str(tmp_path), record_seconds=5.0, snr=snr,
                  now=NOW)
        want = jreport.generate_csv_results(*args, **kw)
        want_bytes = {k: _read(want[k]) for k in KINDS}
        for k in KINDS:
            os.unlink(want[k])
        got = treport.generate_csv_results(*args, **kw)
        assert got == want
        assert {k: _read(got[k]) for k in KINDS} == want_bytes


def test_report_names_and_columns():
    assert treport.CSV_COLUMNS == jreport.CSV_COLUMNS
    for args in ((100, 5.0, None, 24), (4, 2.5, 0.0, 3), (7, 5, -5.0, 0)):
        assert treport._csv_name(*args, now=NOW) == \
            jreport._csv_name(*args, now=NOW)


def test_report_imports_neither_pandas_nor_sklearn():
    code = ("import sys, shazam_tpu_torch.bench\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('pandas', 'sklearn', 'jax', 'shazam_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(__file__)))


def _top1(final):
    m = re.search(r"'song_name': '([^']*)'", final)
    return m.group(1) if m else final


MODES = {
    "clean": dict(seed=3),
    "awgn": dict(add_noise=True, snr_db=0.0, noise_kind="awgn", seed=4),
    "file": dict(add_noise=True, snr_db=0.0, noise_kind="file", seed=6),
    "channel": dict(channel=True, channel_severity=0.5, seed=4),
}


@pytest.mark.parametrize("mode", MODES)
def test_sweep_parity_with_jax(engines, corpus, noise_path, tmp_path,
                               fixed_clock, mode):
    jsia, tsia = engines
    kw = dict(MODES[mode])
    if mode == "file":
        kw["noise_file"] = noise_path
    out = {}
    for label, harness, sia in (("jax", jharness, jsia),
                                ("port", tharness, tsia)):
        cfg = harness.BenchConfig(record_seconds=5.0,
                                  out_dir=str(tmp_path / label), **kw)
        out[label] = harness.run_recognition_sweep(sia, corpus, cfg)
    j, t = out["jax"], out["port"]
    assert t["predicted"] == j["predicted"]
    assert (t["n"], t["correct"], t["accuracy"]) == \
        (j["n"], j["correct"], j["accuracy"])
    assert len(t["artifacts"]) == len(j["artifacts"]) == 3   # songs 2, 3, 4
    if mode == "clean":
        assert t["accuracy"] == 1.0
    for ta, ja in zip(t["artifacts"], j["artifacts"]):
        assert ta["accuracy"] == ja["accuracy"]
        assert ({k: os.path.basename(ta[k]) for k in KINDS}
                == {k: os.path.basename(ja[k]) for k in KINDS})
        for k in KINDS[1:]:
            assert _read(ta[k]) == _read(ja[k]), k
        with open(ta["results"]) as a, open(ja["results"]) as b:
            rows_t, rows_j = list(csv.DictReader(a)), list(csv.DictReader(b))
        assert len(rows_t) == len(rows_j)
        for rt, rj in zip(rows_t, rows_j):
            for col in TIME_COLS:
                assert float(rt.pop(col)) >= 0 and float(rj.pop(col)) >= 0
            assert _top1(rt.pop("final_results")) == \
                _top1(rj.pop("final_results"))
            rt["file_name_played"] = os.path.basename(rt["file_name_played"])
            rj["file_name_played"] = os.path.basename(rj["file_name_played"])
            assert rt == rj        # incl. song_start_time and correct


class _Engine:
    """A duck-typed engine (the sweep needs config.sample_rate and
    recognize_samples), as a ShardedRecognizer is."""

    def __init__(self, sia):
        self.config = sia.config
        self._sia = sia

    def recognize_samples(self, channels, topn=None):
        return self._sia.recognize_samples(channels, topn=topn)


def test_sweep_takes_any_engine(engines, corpus, tmp_path):
    _, tsia = engines
    cfg = tharness.BenchConfig(record_seconds=5.0, out_dir=str(tmp_path),
                               seed=3, checkpoints=False)
    s = tharness.run_recognition_sweep(_Engine(tsia), corpus, cfg)
    assert s["accuracy"] == 1.0 and len(s["artifacts"]) == 1
    assert "0SNR" not in os.path.basename(s["artifacts"][0]["results"])


def test_sweep_rate_guards(engines, corpus, tmp_path):
    from shazam_tpu_torch.audio.io import write_wav

    _, tsia = engines
    odd = str(tmp_path / "track_48k.wav")
    write_wav(odd, np.zeros(48000 * 6, np.int16), 48000)
    for harness, sia in ((jharness, engines[0]), (tharness, tsia)):
        with pytest.raises(ValueError, match="sample rate 48000"):
            harness.run_recognition_sweep(sia, [odd], harness.BenchConfig(
                out_dir=str(tmp_path / "a")))
        with pytest.raises(ValueError, match="noise sample rate 48000"):
            harness.run_recognition_sweep(sia, corpus, harness.BenchConfig(
                add_noise=True, noise_file=odd, out_dir=str(tmp_path / "b")))
        with pytest.raises(ValueError, match="requires noise_file"):
            harness.run_recognition_sweep(sia, corpus, harness.BenchConfig(
                add_noise=True, out_dir=str(tmp_path / "c")))


def test_device_trace(tmp_path):
    from shazam_tpu_torch.profiling import device_trace

    with device_trace(None):
        torch.ones(8).sum()
    with device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    (trace,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / trace) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("sum" in str(e.get("name", "")) for e in events)


def test_atomic_savez_lives_in_utils():
    from shazam_tpu_torch.index import devmerge, store
    from shazam_tpu_torch.parallel import multihost
    from shazam_tpu_torch.utils.persist import atomic_savez

    assert store.atomic_savez is devmerge.atomic_savez is \
        multihost.atomic_savez is atomic_savez


def test_plot_tool(tmp_path):
    from shazam_tpu_torch.audio.synth import synth_song
    from shazam_tpu_torch.tools.plot import plot_constellation

    clip = synth_song(0, duration_s=3.0, seed=21)
    out = plot_constellation(clip, str(tmp_path / "c.png"), device="cpu")
    assert os.path.getsize(out) > 10_000


def test_cli_bench_and_plot_end_to_end(tmp_path):
    from shazam_tpu_torch.audio.synth import synth_corpus
    from shazam_tpu_torch.config import FingerprintConfig

    corpus_dir = tmp_path / "songs"
    synth_corpus(str(corpus_dir), 3, duration_s=8.0, seed=77)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(FingerprintConfig().to_json())
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(*args):
        r = subprocess.run(
            [sys.executable, "-m", "shazam_tpu_torch.cli", "--device", "cpu",
             "--db", str(tmp_path / "cat"), *args],
            capture_output=True, text=True, cwd=root, timeout=300)
        assert r.returncode == 0, r.stderr
        return r.stdout

    run("ingest", str(corpus_dir))
    out = json.loads(run("bench", str(corpus_dir), "--snr", "0", "--awgn",
                         "--out-dir", str(tmp_path / "bench")))
    assert out["n"] == 3 and "predicted" not in out
    assert len(out["artifacts"]) == 2      # songs 1 and 3 of 3
    assert "0SNR" in os.path.basename(out["artifacts"][-1]["results"])
    png = str(tmp_path / "p.png")
    out = run("--config", str(cfg), "plot",
              str(corpus_dir / "track000001.wav"), "--out", png,
              "--limit", "4")
    assert json.loads(out) == {"plot": png}
    assert os.path.getsize(png) > 10_000
