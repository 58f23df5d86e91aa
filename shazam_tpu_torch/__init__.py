"""shazam-tpu on PyTorch and CUDA: the port of the ``shazam_tpu`` package.

Shazam-style audio identification (STFT constellation fingerprints, a
sorted 80-bit hash index, offset-histogram voting) with plain PyTorch
tensor code and hand-written CUDA kernels for the three hot fingerprint
stages (``csrc/``). Every function takes tensors on an explicit device;
CPU tensors run the plain PyTorch twins of the kernels, CUDA tensors run
the kernels. The package never imports JAX.
"""

from .config import DEFAULT_CONFIG, FingerprintConfig

__all__ = ["SIA", "FingerprintConfig", "DEFAULT_CONFIG"]


def __getattr__(name):  # PEP 562: ``SIA`` loads lazily
    if name == "SIA":
        from .api import SIA

        return SIA
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
