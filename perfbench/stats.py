"""The latency percentile, fixed here so the program cannot move it."""

from __future__ import annotations

import math


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile: the smallest sample with at least q % of
    the samples at or below it (the rank serve's own statistics use,
    without their rounding)."""
    s = sorted(xs)
    if not s:
        raise ValueError("percentile of no samples")
    rank = max(1, math.ceil(q / 100.0 * len(s)))
    return float(s[min(len(s), rank) - 1])

