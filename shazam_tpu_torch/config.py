"""Fingerprinting configuration: the knobs the port reads.

Each field has the name and default of the same field of
``shazam_tpu.config.FingerprintConfig``, in its order (a test holds them
equal), so that a config file either package writes loads in the other.
The port does not import that class: ``chip_smoke.py`` drives the port on
the card and imports nothing of the JAX package, so neither may the port.
Six fields describe choices the port cannot vary (``FIXED``): they are
accepted at the JAX package's default and refused at any other value,
rather than silently ignored. So are the values of ``vote_rank`` and
``escalation_policy`` that name a JAX path the port does not have (the
pruned rank, bounds-first escalation); each refusal says what the port
runs instead.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

# fields the port takes only at the JAX package's default: the full-square
# peak footprint, the peak sort, the 80-bit key, a per-channel hash
# capacity and the f32 spectrogram output (no code of the JAX package
# outside its config reads them either), and the candidate count of the
# JAX package's pruned rank, which the port does not have
FIXED = {"connectivity_mask": 2, "peak_sort": True,
         "fingerprint_reduction": 20, "hash_capacity": 32768,
         "rank_candidates": 256, "spectrogram_dtype": "float32"}
# what the port runs in place of a refused value
INSTEAD = {
    "rank_candidates": "the port ranks with the sort or scan rank "
                       "(vote_rank), which give the pruned rank's answer",
    "vote_rank": "the port has no pruned rank: 'sort', 'scan', or 'auto' "
                 "(sort at the fast tier, scan above it) give its answer",
    "escalation_policy": "the port has one big-index policy, decide-first "
                         "('auto' or 'decide'): one dispatch at the decide "
                         "tier, and one more at the tier the exact total "
                         "fits unless its clamp is provably decided (never "
                         "decided with decision_escalation off)",
}


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
    connectivity_mask: int = 2        # CONNECTIVITY_MASK (FIXED)
    peak_sort: bool = True            # PEAK_SORT (FIXED)
    # --- hash pairing ---
    fan_value: int = 5                # anchor pairs with the next fan-1 peaks
    min_hash_time_delta: int = 0      # frames
    max_hash_time_delta: int = 200    # frames
    fingerprint_reduction: int = 20   # hex chars kept = 80 bits (FIXED)
    # --- static capacities (overflow is detected, never silent) ---
    peak_capacity: int = 8192         # max constellation peaks per channel
    hash_capacity: int = 32768        # (FIXED)
    # expanded (row x query-offset) vote entries: queries run at
    # match_capacity_fast first and escalate through the tiers up to
    # match_capacity_max when the exact match count overflows
    match_capacity: int = 65536
    match_capacity_fast: int = 16384
    match_capacity_max: int = 1 << 22
    # provably-exact early accept of a clamped expansion (see
    # match.lookup.RawMatch): top1 - strongest challenger > n_dropped
    decision_escalation: bool = True
    # --- big catalogs (past sparse_vote_threshold); every rank and
    # expansion variant gives element-identical results ---
    # candidate songs of the JAX package's pruned rank (FIXED)
    rank_candidates: int = 256
    # sparse rank: "sort", "scan", or "auto" = sort at the fast tier and
    # scan above it ("pruned", the JAX package's rank, is refused; its
    # "auto" is pruned at the fast tier)
    vote_rank: str = "auto"
    # blocked expansion width (0: row by row), used from
    # expand_block_min_capacity on, with a budget of expand_block_runs
    # nonempty runs (more are dropped into n_dropped; 0: every lane)
    expand_block: int = 128
    expand_block_min_capacity: int = 65536
    expand_block_runs: int = 1024
    # indexes of at least this many rows take decide-first escalation (0:
    # never): one dispatch at the decide tier, accepted when provably
    # decided, else one fitted re-dispatch reusing its search bounds
    bounds_probe_min_rows: int = 1 << 25
    # "auto" or "decide": decide-first, the port's one big-index policy
    # ("bounds", the JAX package's exact-total probe first, is refused)
    escalation_policy: str = "auto"
    # the decide tier (0: match_capacity); it rises one step after a
    # window of decide_adapt_window dispatches that were mostly undecided
    # (0: never), up to decide_adapt_max
    decide_capacity: int = 0
    decide_adapt_window: int = 64
    decide_adapt_max: int = 524288
    # capacity tiers grow x4 up to this, x2 after
    match_tier_fine_from: int = 262144
    # past n_songs * delta_range vote bins the dense histogram gives way to
    # the sparse ranks
    sparse_vote_threshold: int = 16_000_000
    # --- matching / results ---
    topn: int = 2                     # TOPN (recognizer.py:68)
    # --- numerics ---
    spectrogram_dtype: str = "float32"  # (FIXED)

    def __post_init__(self) -> None:
        for name, default in FIXED.items():
            if getattr(self, name) != default:
                raise ValueError(
                    f"{name}={getattr(self, name)!r}: the port takes only "
                    f"the JAX package's default {default!r}"
                    + (f"; {INSTEAD[name]}" if name in INSTEAD else ""))
        if self.window_size & (self.window_size - 1):
            raise ValueError("window_size must be a power of two")
        if not (0.0 <= self.overlap_ratio < 1.0):
            raise ValueError("overlap_ratio must be in [0, 1)")
        if self.fan_value < 1:
            raise ValueError("fan_value must be >= 1")
        for name, taken, gone in (
                ("vote_rank", ("auto", "sort", "scan"), "pruned"),
                ("escalation_policy", ("auto", "decide"), "bounds")):
            value = getattr(self, name)
            if value == gone:
                raise ValueError(f"{name}={value!r}: {INSTEAD[name]}")
            if value not in taken:
                raise ValueError(f"{name} {value!r} not in {taken}")

    @property
    def hop(self) -> int:
        """Samples between adjacent STFT frames (wsize - noverlap)."""
        return self.window_size - int(self.window_size * self.overlap_ratio)

    @property
    def n_freqs(self) -> int:
        """One-sided FFT bin count."""
        return self.window_size // 2 + 1

    @property
    def neighborhood_width(self) -> int:
        """Side of the square local-max footprint (21 for the defaults)."""
        return 2 * self.peak_neighborhood_size + 1

    def num_frames(self, n_samples: int) -> int:
        """STFT frame count for an n_samples signal (mlab.specgram layout)."""
        if n_samples < self.window_size:
            return 0
        return (n_samples - self.window_size) // self.hop + 1

    def frames_to_seconds(self, offset_frames: float) -> float:
        """Reference ``recognizer.py:318`` offset -> seconds conversion."""
        return round(
            float(offset_frames)
            / self.sample_rate
            * self.window_size
            * self.overlap_ratio,
            5,
        )

    # ---- (de)serialization: the JAX package's JSON config files ----
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FingerprintConfig":
        return cls(**json.loads(text))

    def replace(self, **kwargs: Any) -> "FingerprintConfig":
        return dataclasses.replace(self, **kwargs)


DEFAULT_CONFIG = FingerprintConfig()
