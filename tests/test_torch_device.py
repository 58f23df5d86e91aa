"""The port's boundaries: no JAX, explicit devices, the kernel build, and
``chip_smoke.py``'s refusal to report anything without a CUDA card."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "shazam_tpu_torch"


def test_port_never_imports_jax_or_the_jax_package():
    code = (
        "import sys\n"
        "import shazam_tpu_torch.api, shazam_tpu_torch.ops.cuda.compact\n"
        "import shazam_tpu_torch.ops.cuda.peaks, shazam_tpu_torch.ops.cuda.spectrogram\n"
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
