"""The arithmetic of the end-to-end metrics: over the whole window, over
all requests."""

from __future__ import annotations

import numpy as np


def rate(work: float, window_s: float) -> float:
    """Work a second over the window: all the work of the window over all
    its time, never a mean of per-request rates."""
    if window_s <= 0.0:
        raise ValueError("an empty window")
    return work / window_s


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0-100) of all values (numpy's linear
    interpolation between the nearest ranks)."""
    if not values:
        raise ValueError("no values")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
