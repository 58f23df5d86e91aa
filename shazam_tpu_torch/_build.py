"""Build and load the hand-written CUDA kernels in ``csrc/``.

All ``csrc/*.cu`` files compile with one ``nvcc`` call into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), placed in ``_build/`` under a name keyed by a hash of the
sources and flags, and loaded with ``ctypes``. The build happens on first
use, never at import: machines without ``nvcc`` import every module and
only the CUDA launch paths need the library.

Each kernel is reached through a :class:`Kernel`, which checks the C
entry point's returned ``cudaError_t`` and counts its launches, so a run
can show that its main path really went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# -O3 only: fast-math would flush denormals and relax the FFT/compare
# arithmetic the kernels must share with their plain PyTorch twins
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "shazam_tpu_torch are built from csrc/ at first use")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libshazam_kernels_{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile ``csrc/*.cu`` if the keyed library is missing; returns the
    seconds spent compiling (0.0 when it was already built)."""
    out = library_path()
    if out.exists():
        return 0.0
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               *map(str, cu)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(library_path()))
    lib.shz_error_string.argtypes = [ctypes.c_int]
    lib.shz_error_string.restype = ctypes.c_char_p
    return lib


class Kernel:
    """One C entry point of the kernel library, with a launch counter.

    ``launches`` grows by one for each successful launch and nowhere
    else; callers may reset it to 0 before a run they want to attribute.
    """

    def __init__(self, name: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0

    def __call__(self, *args) -> None:
        lib = library()
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes + [ctypes.c_void_p]  # + the stream
        fn.restype = ctypes.c_int
        import torch

        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch failed with error {rc} "
                f"({lib.shz_error_string(rc).decode()})")
        self.launches += 1
