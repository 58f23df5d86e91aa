"""Fingerprinting configuration: the knobs the port reads.

Each field has the name and default of the same field of
``shazam_tpu.config.FingerprintConfig`` (a test holds them equal). The
port does not import that class: ``chip_smoke.py`` drives the port on
the card and imports nothing of the JAX package, so neither may the port.
Only the fields the port honours are here; the JAX package's big-catalog
matcher, serving and layout knobs have no counterpart yet, and a field
that the port would silently ignore is left out.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FingerprintConfig:
    """Knobs of the fingerprint and match pipeline (reference ``__init__.py:41-51``)."""

    # --- audio / spectrogram ---
    sample_rate: int = 44100          # RATE
    window_size: int = 4096           # DEFAULT_WINDOW_SIZE (NFFT)
    overlap_ratio: float = 0.5        # DEFAULT_OVERLAP_RATIO
    # --- constellation peaks ---
    amp_min: float = 10.0             # DEFAULT_AMP_MIN (dB, strict >)
    peak_neighborhood_size: int = 10  # PEAK_NEIGHBORHOOD_SIZE
    # --- hash pairing ---
    fan_value: int = 5                # anchor pairs with the next fan-1 peaks
    min_hash_time_delta: int = 0      # frames
    max_hash_time_delta: int = 200    # frames
    # --- static capacities (overflow is detected, never silent) ---
    peak_capacity: int = 8192         # max constellation peaks per channel
    # expanded (row x query-offset) vote entries: queries run at
    # match_capacity_fast first and escalate through the tiers up to
    # match_capacity_max when the exact match count overflows
    match_capacity: int = 65536
    match_capacity_fast: int = 16384
    match_capacity_max: int = 1 << 22
    # provably-exact early accept of a clamped expansion (see
    # match.lookup.RawMatch): top1 - strongest challenger > n_dropped
    decision_escalation: bool = True
    # capacity tiers grow x4 up to this, x2 after
    match_tier_fine_from: int = 262144
    # past n_songs * delta_range vote bins the dense histogram gives way to
    # the sparse matchers (not ported yet: the port raises there)
    sparse_vote_threshold: int = 16_000_000
    # --- matching / results ---
    topn: int = 2                     # TOPN (recognizer.py:68)

    def __post_init__(self) -> None:
        if self.window_size & (self.window_size - 1):
            raise ValueError("window_size must be a power of two")
        if not (0.0 <= self.overlap_ratio < 1.0):
            raise ValueError("overlap_ratio must be in [0, 1)")
        if self.fan_value < 1:
            raise ValueError("fan_value must be >= 1")

    @property
    def hop(self) -> int:
        """Samples between adjacent STFT frames (wsize - noverlap)."""
        return self.window_size - int(self.window_size * self.overlap_ratio)

    def frames_to_seconds(self, offset_frames: float) -> float:
        """Reference ``recognizer.py:318`` offset -> seconds conversion."""
        return round(
            float(offset_frames)
            / self.sample_rate
            * self.window_size
            * self.overlap_ratio,
            5,
        )


DEFAULT_CONFIG = FingerprintConfig()
