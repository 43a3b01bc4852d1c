"""Percentiles and spreads, one definition for every metric and tool."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0..100) of ``values`` by linear interpolation
    between closest ranks (NumPy's default); ``inf`` entries (requests or
    frames that never came) sort last and count."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    if math.isinf(v[hi]):
        return v[hi] if pos > lo or math.isinf(v[lo]) else v[lo]
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def spread(values) -> float:
    """The distance between the first and third quartile as a share of the
    median, with Python's ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
