"""Port parity for the CLI (shazam_tpu_torch/cli.py) on the CPU.

Mirrors ``tests/test_cli.py``: drives ``cli.main(argv)`` in-process over
one tmp ``--db`` through the reference's workflows (synth corpus ->
ingest -> stats -> recognize -> fsck -> sanity -> bench sweep ->
metadata import), every run with ``--device cpu``. Also: ``synth`` writes
the JAX package's files, flags the port cannot honor are refused, and
``serve`` runs as a subprocess that answers and stops on SIGTERM.
"""

import json
import os
import signal
import subprocess
import sys

import pytest
import torch

from shazam_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(capsys, *argv):
    cli.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    # first JSON document on stdout (recognize may append metadata lines)
    dec = json.JSONDecoder()
    obj, _ = dec.raw_decode(out[out.index("{"):])
    return obj


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("cliws")
    return {"db": str(root / "db"), "songs": str(root / "songs"),
            "root": root}


def test_synth_and_ingest(workspace, capsys):
    out = _run(capsys, "synth", workspace["songs"], "-n", "3",
               "--seconds", "8")
    assert out["generated"] == 3
    out = _run(capsys, "--db", workspace["db"], "ingest", workspace["songs"])
    assert out["ingested"] == 3 and not out["overflowed"]
    assert os.path.exists(workspace["db"] + ".npz")
    # resume dedup: a second ingest skips everything
    out = _run(capsys, "--db", workspace["db"], "ingest", workspace["songs"])
    assert out["skipped"] == 3 and out["ingested"] == 0


def test_stats_and_fsck(workspace, capsys):
    csv = str(workspace["root"] / "hashes.csv")
    out = _run(capsys, "--db", workspace["db"], "stats", "--out", csv)
    assert out["n_songs"] == 3 and out["index_hashes"] > 1000
    assert os.path.exists(csv)
    out = _run(capsys, "--db", workspace["db"], "fsck")
    assert out["ok"] and not out["errors"]


def test_recognize_file(workspace, capsys):
    track = sorted(os.listdir(workspace["songs"]))[1]
    out = _run(capsys, "--db", workspace["db"], "recognize",
               os.path.join(workspace["songs"], track), "--limit", "5")
    assert out["results"][0]["song_name"] == os.path.splitext(track)[0]
    assert out["results"][0]["input_confidence"] > 0.5


def test_sanity(workspace, capsys, tmp_path, monkeypatch):
    out = _run(capsys, "--db", workspace["db"], "sanity", workspace["songs"])
    assert out["checked"] == 3 and not out.get("deleted")
    monkeypatch.chdir(tmp_path)         # the failures' log lands in the cwd
    out = _run(capsys, "sanity", workspace["songs"], "--seconds", "9")
    assert out["bad"] == 3 and (tmp_path / "songs_deleted.csv").exists()


def test_metadata_import(workspace, capsys):
    csv = workspace["root"] / "meta.csv"
    csv.write_text(  # FMA-style schema (reference metadatatable.sql)
        "track_id,track_title,artist_name\n1,Track Zero,Synth\n")
    out = _run(capsys, "--db", workspace["db"], "metadata", str(csv))
    assert out["imported"] == 1


def test_recognize_without_index_exits(tmp_path, capsys):
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "--db", str(tmp_path / "nodb"),
                  "recognize", "x.wav"])


def test_synth_writes_the_jax_corpus(tmp_path, capsys):
    from shazam_tpu.audio.synth import synth_corpus

    out = _run(capsys, "synth", str(tmp_path / "port"), "-n", "2",
               "--seconds", "2", "--seed", "9")
    assert out["generated"] == 2
    synth_corpus(str(tmp_path / "jax"), 2, duration_s=2.0, seed=9)
    for name in ("track000000.wav", "track000001.wav"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("argv", [["bench", "x"], ["plot", "x.wav"]])
def test_flags_the_port_cannot_honor_are_refused(argv, tmp_path):
    """``bench`` and ``plot`` parse (the port has them); a ``--config``
    the port cannot honor is refused before either reads anything."""
    args = cli.build_parser().parse_args(argv)
    assert args.fn is {"bench": cli.cmd_bench, "plot": cli.cmd_plot}[argv[0]]
    bad = tmp_path / "cfg.json"
    bad.write_text(json.dumps({"no_such_field": 1}))
    with pytest.raises(SystemExit) as ei:
        cli.main(["--device", "cpu", "--db", str(tmp_path / "db"),
                  "--config", str(bad), *argv])
    assert "fields the port does not honor" in str(ei.value.code)


def test_bench_sweep(workspace, capsys):
    """``tests/test_cli.py::test_sanity_and_bench_sweep``'s bench half."""
    out_dir = str(workspace["root"] / "bench")
    out = _run(capsys, "--db", workspace["db"], "bench", workspace["songs"],
               "--limit-songs", "2", "--seconds", "4", "--seed", "7",
               "--out-dir", out_dir)
    assert out["n"] == 2 and out["accuracy"] == 1.0
    assert any(f.startswith("shazam_results") for f in os.listdir(out_dir))


def test_device_resident_ingest_then_recognize(workspace, tmp_path, capsys):
    """--device-resident on ingest and recognize: the songs merge into a
    store on the device, the saved index equals a host-backed ingest's,
    and recognize answers from a store built from that file."""
    import numpy as np

    from shazam_tpu_torch.index.store import FingerprintIndex

    db = str(tmp_path / "resident")
    out = _run(capsys, "--db", db, "ingest", workspace["songs"],
               "--device-resident")
    assert out["ingested"] == 3 and not out["overflowed"]
    got = FingerprintIndex.load(db + ".npz")
    want = FingerprintIndex.load(workspace["db"] + ".npz")
    for name in ("key_hi", "key_lo", "key_ex", "song_id", "offset"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    track = sorted(os.listdir(workspace["songs"]))[2]
    out = _run(capsys, "--db", db, "recognize",
               os.path.join(workspace["songs"], track), "--limit", "5",
               "--device-resident")
    assert out["results"][0]["song_name"] == os.path.splitext(track)[0]
    assert cli.build_parser().parse_args(
        ["serve", "--device-resident"]).device_resident


def test_span_rows_ingest_writes_spanwise(workspace, tmp_path, capsys):
    """ingest --span-rows: a spanned SIA whose saved index is the span-wise
    file, holding the host-backed ingest's rows; recognize --span-rows
    loads it straight into a store and answers."""
    import numpy as np

    from shazam_tpu_torch.index.devmerge import (is_spanned_file,
                                                 load_spanned_flat)
    from shazam_tpu_torch.index.store import FingerprintIndex

    db = str(tmp_path / "spanned")
    out = _run(capsys, "--db", db, "ingest", workspace["songs"],
               "--span-rows", "4096")
    assert out["ingested"] == 3
    assert is_spanned_file(db + ".npz")
    with np.load(db + ".npz") as z:
        assert int(z["spanned_meta"][0]) == 4096
    got = load_spanned_flat(db + ".npz")
    want = FingerprintIndex.load(workspace["db"] + ".npz")
    for name in ("key_hi", "key_lo", "key_ex", "song_id", "offset"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    track = sorted(os.listdir(workspace["songs"]))[1]
    out = _run(capsys, "--db", db, "recognize",
               os.path.join(workspace["songs"], track), "--limit", "5",
               "--span-rows", "4096")
    assert out["results"][0]["song_name"] == os.path.splitext(track)[0]


def test_recognize_early_exit(workspace, capsys):
    """recognize --early-exit: the apriori match answers the same song and
    offset as the full match."""
    track = os.path.join(workspace["songs"],
                         sorted(os.listdir(workspace["songs"]))[0])
    full = _run(capsys, "--db", workspace["db"], "recognize", track,
                "--limit", "5")
    fast = _run(capsys, "--db", workspace["db"], "recognize", track,
                "--limit", "5", "--early-exit")
    assert fast["results"][0]["song_name"] == os.path.splitext(
        os.path.basename(track))[0]
    for key in ("song_name", "offset"):
        assert fast["results"][0][key] == full["results"][0][key]


class _StubServer:
    """Stands in for RecognitionServer: records the SIA, serves nothing."""

    seen = []

    def __init__(self, sia, **kw):
        self.sia, self.port = sia, 0
        self.batcher = type("B", (), {"stats": {}})()
        _StubServer.seen.append(sia)

    def install_signal_handlers(self):
        pass

    def serve_forever(self):
        pass


def _serve(monkeypatch, capsys, db, *flags):
    from shazam_tpu_torch import serve

    _StubServer.seen.clear()
    monkeypatch.setattr(serve, "RecognitionServer", _StubServer)
    out = _run(capsys, "--db", db, "serve", "--warmup", "0", *flags)
    return _StubServer.seen[0], out


def test_serve_span_rows(workspace, tmp_path, monkeypatch, capsys):
    """serve --span-rows: the daemon's SIA is spanned, its store uploaded
    straight from the span-wise file, and /save's save_index writes that
    format again."""
    from shazam_tpu_torch.index.devmerge import is_spanned_file

    db = str(tmp_path / "served")
    _run(capsys, "--db", db, "ingest", workspace["songs"], "--span-rows",
         "4096")
    sia, out = _serve(monkeypatch, capsys, db, "--span-rows", "4096")
    assert sia.device_span_rows == 4096 and sia.device_resident
    assert sia._dev_store is not None and sia._host_stale
    assert out["hashes"] == sia._dev_store.n_valid > 0
    sia.save_index(str(tmp_path / "again.npz"))
    assert is_spanned_file(str(tmp_path / "again.npz"))


def test_serve_consolidate(workspace, tmp_path, monkeypatch, capsys):
    """serve --consolidate calls consolidate_index, which stacks the store
    for serving; ingest into it then raises, as in the JAX package."""
    from shazam_tpu_torch.api import SIA
    from shazam_tpu_torch.audio import synth_song

    calls = []
    orig = SIA.consolidate_index
    monkeypatch.setattr(SIA, "consolidate_index",
                        lambda self: calls.append(self) or orig(self))
    db = str(tmp_path / "consolidated")
    _run(capsys, "--db", db, "ingest", workspace["songs"], "--span-rows",
         "4096")
    sia, _ = _serve(monkeypatch, capsys, db, "--span-rows", "4096",
                    "--consolidate")
    assert calls == [sia] and sia._dev_store.is_stacked
    n0 = sia._dev_store.n_valid
    with pytest.raises(ValueError, match="consolidated"):
        sia.ingest_arrays([("fresh", synth_song(7, duration_s=4.0, seed=5))])
    assert sia._dev_store.n_valid == n0 > 0


def test_config_file(workspace, tmp_path, capsys):
    """--config takes the port's fields; a field it does not have is
    refused instead of silently ignored."""
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"topn": 1}))
    track = sorted(os.listdir(workspace["songs"]))[2]
    out = _run(capsys, "--config", str(good), "--db", workspace["db"],
               "recognize", os.path.join(workspace["songs"], track),
               "--limit", "4", "--topn", "1")
    assert len(out["results"]) == 1
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"hash_capacity": 4}))
    with pytest.raises(SystemExit, match="hash_capacity"):
        cli.load_config(str(bad))


def test_default_device_is_the_card():
    args = cli.build_parser().parse_args(["stats"])
    assert args.device == "cuda"


def test_serve_subprocess_answers_and_stops_on_sigterm(workspace):
    """`serve --port 0 --warmup 0` in its own process: it prints where it
    listens, answers a client, and SIGTERM stops it gracefully."""
    from shazam_tpu_torch.client import SIAClient

    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "shazam_tpu_torch.cli", "--device", "cpu",
         "--db", workspace["db"], "serve", "--port", "0", "--warmup", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    try:
        line = proc.stdout.readline()
        url = json.loads(line)["serving"]
        track = sorted(os.listdir(workspace["songs"]))[0]
        out = SIAClient(url).recognize(
            path=os.path.join(workspace["songs"], track))
        assert out["results"][0]["song_name"] == os.path.splitext(track)[0]
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr
    last = json.loads(stdout.strip().splitlines()[-1])
    assert last["stopped"] is True and last["requests"] == 1
    assert last["errors"] == 0
