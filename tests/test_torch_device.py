"""The port's boundaries: no JAX, explicit devices, the kernel build, and
``chip_smoke.py``'s refusal to report anything without a CUDA card."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "shazam_tpu_torch"


def test_port_never_imports_jax_or_the_jax_package():
    code = (
        "import sys\n"
        "import shazam_tpu_torch.api, shazam_tpu_torch.ops.cuda.compact\n"
        "import shazam_tpu_torch.ops.cuda.peaks, shazam_tpu_torch.ops.cuda.spectrogram\n"
        "import shazam_tpu_torch.audio.io, shazam_tpu_torch.audio.mp3\n"
        "import shazam_tpu_torch.audio.resample, shazam_tpu_torch.match.batched\n"
        "import shazam_tpu_torch.index.store, shazam_tpu_torch.profiling\n"
        "import shazam_tpu_torch.index.devmerge, shazam_tpu_torch.index.devingest\n"
        "import shazam_tpu_torch.stream, shazam_tpu_torch.stream_device\n"
        "import shazam_tpu_torch.serve, shazam_tpu_torch.client\n"
        "import shazam_tpu_torch.cli, shazam_tpu_torch.tools.fsck\n"
        "import shazam_tpu_torch.tools.stats, shazam_tpu_torch.tools.sanity\n"
        "import shazam_tpu_torch.match.apriori, shazam_tpu_torch.index.registry\n"
        "import shazam_tpu_torch.parallel.mesh, shazam_tpu_torch.parallel.sharded\n"
        "import shazam_tpu_torch.parallel.bigcatalog, shazam_tpu_torch.parallel.serving\n"
        "import shazam_tpu_torch.parallel.sequence, shazam_tpu_torch.parallel.multihost\n"
        "import shazam_tpu_torch.audio.noise, shazam_tpu_torch.audio.channel\n"
        "import shazam_tpu_torch.audio.synth_device, shazam_tpu_torch.bench\n"
        "import shazam_tpu_torch.utils, shazam_tpu_torch.utils.persist\n"
        "import shazam_tpu_torch.tools.plot\n"
        "from shazam_tpu_torch import parallel as P\n"
        "for mod, names in (\n"
        "        (P.mesh, ('make_mesh', 'shard_index_arrays', 'SHARD_AXIS')),\n"
        "        (P.sharded, ('sharded_match_query', 'sharded_ingest_step',\n"
        "                     'effective_match_capacity', 'sharded_match_apriori')),\n"
        "        (P.bigcatalog, ('pack_shard_rows', 'shard_index_by_song',\n"
        "                        'sharded_match_by_song', 'effective_match_capacity')),\n"
        "        (P.serving, ('ShardedCatalog', 'ShardedRecognizer')),\n"
        "        (P.sequence, ('sequence_parallel_fingerprint',)),\n"
        "        (P.multihost, ('init_multihost', 'global_mesh', 'SpannedCatalog',\n"
        "                       'distributed_ingest_arrays'))):\n"
        "    for name in names:\n"
        "        assert hasattr(mod, name), (mod.__name__, name)\n"
        "from shazam_tpu_torch.api import SIA\n"
        "for name in ('ingest_files', 'ingest_directory', 'ingest_channels',\n"
        "             'recognize_file', 'recognize_batch', 'prepare_batch',\n"
        "             'match_prepared_batch', '_live_n_hashes',\n"
        "             'ingest_device_batch', '_live_n_songs',\n"
        "             'consolidate_index'):\n"
        "    assert callable(getattr(SIA, name)), name\n"
        "shazam_tpu_torch.audio.resample.resample_channel(\n"
        "    __import__('numpy').zeros(480, 'int16'), 48000, 44100)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'shazam_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            assert not any(n.split(".")[0] in ("jax", "shazam_tpu")
                           for n in names), (path, names)


def test_resolve_device_is_explicit(monkeypatch):
    from shazam_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def _sia(**kw):
    from shazam_tpu_torch.api import SIA

    return SIA(**kw)


def _resident_sia(**kw):
    return _sia(device_resident=True, **kw)


def _spanned_sia(**kw):
    return _sia(device_span_rows=4096, **kw)


def _memory_backend(**kw):
    from shazam_tpu_torch.index.registry import get_backend

    return get_backend("memory")("", **kw)


def _fingerprint(**kw):
    from shazam_tpu_torch.ops.fingerprint import fingerprint

    return fingerprint(np.zeros(8192, np.float32), **kw)


def _stream_engine(cls_name):
    def make():
        from shazam_tpu_torch import stream, stream_device
        from shazam_tpu_torch.config import FingerprintConfig

        mod = stream if cls_name == "IncrementalFingerprinter" else stream_device
        return getattr(mod, cls_name)(FingerprintConfig(), 5.0)

    return make


def _mesh():
    from shazam_tpu_torch.parallel.mesh import make_mesh

    return make_mesh()


def _global_mesh():
    from shazam_tpu_torch.parallel.multihost import global_mesh

    return global_mesh()


def _sharded_recognizer():
    from shazam_tpu_torch.index.store import build_index
    from shazam_tpu_torch.parallel.serving import (ShardedCatalog,
                                                   ShardedRecognizer)

    return ShardedRecognizer(ShardedCatalog(build_index([], n_songs=0)))


def _music_gen():
    from shazam_tpu_torch.audio.synth_device import make_music_gen

    return make_music_gen(1.0)


def _plot():
    import tempfile

    from shazam_tpu_torch.tools.plot import plot_constellation

    with tempfile.TemporaryDirectory() as tmp:
        plot_constellation(np.zeros(8192, np.int16),
                           os.path.join(tmp, "c.png"))


def _cli_stats():
    import tempfile

    from shazam_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        cli.main(["--db", os.path.join(tmp, "db"), "stats", "--out",
                  os.path.join(tmp, "s.csv")])


@pytest.mark.parametrize("entry", [
    _sia, _resident_sia, _spanned_sia, _memory_backend, _fingerprint,
    _stream_engine("IncrementalFingerprinter"),
    _stream_engine("DeviceIncrementalFingerprinter"), _cli_stats, _mesh,
    _global_mesh, _sharded_recognizer, _music_gen, _plot])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """No card: the default device raises instead of running on the CPU
    (the sharded entry points before any process group starts)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        entry()
    assert not torch.distributed.is_initialized()


def test_entry_points_run_on_the_cpu_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _sia(device="cpu").device == torch.device("cpu")
    fp = _fingerprint(device="cpu")
    assert fp.hi.device == torch.device("cpu") and int(fp.n_peaks) == 0


def test_library_is_keyed_by_the_sources(tmp_path, monkeypatch):
    from shazam_tpu_torch import _build

    path = _build.library_path()
    assert path.parent == PORT / "_build" and path == _build.library_path()
    src = tmp_path / "csrc"
    shutil.copytree(PORT / "csrc", src)
    monkeypatch.setattr(_build, "CSRC", src)
    assert _build.library_path() == path
    (src / "compact.cu").write_text((src / "compact.cu").read_text() + "\n")
    assert _build.library_path() != path


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, alone):
    """No CUDA device (hidden here) or no package next to the script:
    non-zero exit and no result line."""
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_shape_audit_holds_first_launches_to_their_twins(monkeypatch):
    """chip_smoke's ShapeAudit reads each launch's arrays from the C
    arguments the wrappers pass, copies the first launch at each shape and
    holds it against the plain twin; a copy that differs fails the check.
    CPU tensors keyed by their pointers stand in for the card's memory."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    from shazam_tpu_torch.config import FingerprintConfig
    from shazam_tpu_torch.ops.cuda import compact, peaks, sha1, spectrogram
    from shazam_tpu_torch.ops.hashes import generate_hashes_plain
    from shazam_tpu_torch.ops.peaks import (compact_plain, peak_mask_plain,
                                            power_threshold)
    from shazam_tpu_torch.ops.spectrogram import (psd_scales,
                                                  spectrogram_power_plain)

    memory = {}

    def ptr(t):
        memory[t.data_ptr()] = t
        return t.data_ptr()

    monkeypatch.setattr(chip_smoke, "_card_view",
                        lambda p, shape, typestr: memory[p].view(shape))
    cfg = FingerprintConfig()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        rng.normal(0, 3000, (2, 4096 + 9 * 2048)).astype(np.float32))
    nvf = torch.tensor([10, 4], dtype=torch.int32)
    power = spectrogram_power_plain(x, nvf)
    bits = peak_mask_plain(power, cfg.amp_min)
    times, freqs, n_peaks = compact_plain(bits, 64)
    hashes = generate_hashes_plain(times, freqs, n_peaks, 5, 0, 200)
    edge, mid = psd_scales(4096, cfg.sample_rate)
    launches = (
        (spectrogram.KERNEL, "spectrogram_power",
         (ptr(x), x.shape[1], ptr(nvf), 2, 10, 2048, 0, 0, edge, mid,
          ptr(power))),
        (peaks.KERNEL, "peak_mask",
         (ptr(power), 2, 10, power_threshold(cfg.amp_min), ptr(bits))),
        (compact.KERNEL, "compact",
         (ptr(bits), 2, 10, 64, ptr(times), ptr(freqs), ptr(n_peaks), 0, 0,
          0)),
        (sha1.KERNEL, "pair_sha1",
         (ptr(times), ptr(freqs), ptr(n_peaks), 2, 64, 5, 0, 200,
          *map(ptr, hashes))),
    )
    audit = chip_smoke.ShapeAudit(cfg)
    for kernel, name, args in launches * 2:   # a shape is copied once
        stub = type("Stub", (), {"argtypes": kernel.argtypes,
                                 "__call__": lambda self, *a, stream: None})
        audit._launch(name, stub(), *args)
    assert audit.check() == {"spectrogram_power": [[[2, x.shape[1]], 0.0]],
                             "peak_mask": [[[2, 10], 0]],
                             "compact": [[[2, 10, 64], 0]],
                             "pair_sha1": [[[2, 64, 5, 0, 200], 0]]}
    audit.first["pair_sha1", (2, 64, 5, 0, 200)][1][3][1, 7] += 1
    with pytest.raises(AssertionError, match="pair_sha1 at"):
        audit.check()
    audit.first["pair_sha1", (2, 64, 5, 0, 200)][1][3][1, 7] -= 1
    audit.first["compact", (2, 10, 64)][1][0][0, 0] += 1
    with pytest.raises(AssertionError, match="compact at"):
        audit.check()
    with pytest.raises(AssertionError, match="arguments"):
        audit._launch("compact", stub(), *launches[2][2][:-1])
