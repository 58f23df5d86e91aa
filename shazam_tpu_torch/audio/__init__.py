"""Host-side audio: synthesis, file decode, resampling, noise and the
acoustic channel (numpy).

Copies of the ``shazam_tpu.audio`` modules the port reads, each held
equal to its original by a test: the port and ``chip_smoke.py`` import
nothing of the JAX package. ``synth_device`` (not imported here) renders
the music-like songs on the card.
"""

from .io import find_files, read, unique_file_hash, write_wav
from .noise import mix_at_snr, renormalize, scale_noise_to_snr, white_noise_for_snr
from .resample import resample_channel, resample_channels
from .synth import synth_corpus, synth_song

__all__ = [
    "read",
    "resample_channel",
    "resample_channels",
    "write_wav",
    "find_files",
    "unique_file_hash",
    "white_noise_for_snr",
    "scale_noise_to_snr",
    "mix_at_snr",
    "renormalize",
    "synth_song",
    "synth_corpus",
]
