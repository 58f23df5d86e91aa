"""Order statistics over every request of a window."""

from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, numpy's linear
    interpolation between the two nearest ranks."""
    if len(values) == 0:
        raise ValueError("no values")
    return float(np.percentile(np.asarray(values, np.float64), q))

