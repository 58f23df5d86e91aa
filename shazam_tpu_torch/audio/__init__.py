"""Host-side audio: synthesis, file decode and resampling (numpy).

Copies of the ``shazam_tpu.audio`` modules the port reads, each held
equal to its original by a test: the port and ``chip_smoke.py`` import
nothing of the JAX package.
"""

from .io import find_files, read, write_wav
from .synth import synth_corpus, synth_song

__all__ = ["synth_song", "synth_corpus", "read", "write_wav", "find_files"]
