"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` file compiles in its own ``nvcc`` process, all
started together, and one more ``nvcc`` links the objects into a shared
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
import threading
import time
from pathlib import Path
from typing import Callable, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# -O3 only: fast-math would flush denormals and relax the FFT/compare
# arithmetic the kernels must share with their plain PyTorch twins
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")


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


def _check(cmd, returncode: int, stdout: str, stderr: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n"
                           f"{stdout}\n{stderr}")


def compile_library(cu: Sequence[Path], out: Path) -> float:
    """Compile the sources ``cu`` (one ``nvcc`` each, in parallel) and link
    them into the shared library ``out``; returns the seconds it took."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{i}_{p.stem}.o" for i, p in enumerate(cu)]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o),
                 str(p)] for p, o in zip(cu, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        results = [p.communicate() for p in procs]  # waits for every one
        for cmd, proc, (stdout, stderr) in zip(cmds, procs, results):
            _check(cmd, proc.returncode, stdout, stderr)
        so = Path(tmp) / out.name
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(so), *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        _check(link, res.returncode, res.stdout, res.stderr)
        os.replace(so, out)  # atomic: a concurrent build never loads half a file
    return time.perf_counter() - t0


def build() -> float:
    """Compile ``csrc/*.cu`` if the keyed library is missing; returns the
    seconds spent compiling (0.0 when it was already built)."""
    out = library_path()
    if out.exists():
        return 0.0
    return compile_library(_sources()[0], out)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The package's own kernel library, which also exports
    ``shz_error_string`` (an earlier kernel built alone may not)."""
    build()
    lib = ctypes.CDLL(str(library_path()))
    lib.shz_error_string.argtypes = [ctypes.c_int]
    lib.shz_error_string.restype = ctypes.c_char_p
    return lib


def raw_stream(device_index: int) -> int:
    """The ``cudaStream_t`` of the device's current stream, read without
    building a ``torch.cuda.Stream`` (which costs a few microseconds of
    host time per lookup)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device_index)


class Kernel:
    """One C entry point of the kernel library, with a launch counter.

    ``launches`` grows by one for each successful launch and nowhere
    else (under a lock: threads launch concurrently); callers may reset it
    to 0 before a run they want to attribute.
    ``loader`` returns the library that holds the symbol: the package's
    own by default, another build (an earlier kernel source) for a
    side-by-side timing.
    """

    def __init__(self, name: str, symbol: str, argtypes: Sequence,
                 loader: Callable[[], ctypes.CDLL] = library):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.loader = loader
        self.launches = 0
        self._count_lock = threading.Lock()

    @functools.cached_property
    def _fn(self):
        fn = getattr(self.loader(), self.symbol)
        fn.argtypes = self.argtypes + [ctypes.c_void_p]  # + the stream
        fn.restype = ctypes.c_int
        return fn

    def __call__(self, *args, stream: int | None = None) -> None:
        """Launch on ``stream`` (a raw ``cudaStream_t``), by default the
        current device's current stream; a caller that already looked it
        up passes it."""
        import torch

        if stream is None:
            stream = raw_stream(torch.cuda.current_device())
        rc = self._fn(*args, stream)
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch failed with error {rc} "
                f"({library().shz_error_string(rc).decode()})")
        with self._count_lock:
            self.launches += 1
