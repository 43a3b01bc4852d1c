"""Fixed sets of sizes and arrivals, in an order drawn from the seed.

Every seed gets the same multiset of lengths, durations and gaps (the
quantiles of each distribution), so that two seeds do the same work in
another order and runs of different seeds spread no more than runs of one.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """The seed's host generator (``stream`` separates independent uses)."""
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def log_uniform(n: int, lo: float, hi: float) -> np.ndarray:
    """``n`` values from ``lo`` to ``hi`` (both included), evenly spaced in
    log."""
    if n == 1:
        return np.array([math.sqrt(lo * hi)])
    return lo * (hi / lo) ** (np.arange(n) / (n - 1))


def uniform(n: int, lo: float, hi: float) -> np.ndarray:
    """The ``n`` mid-quantiles of U(lo, hi)."""
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


def log_normal(n: int, median: float, sigma: float, lo: float,
               hi: float) -> np.ndarray:
    """The ``n`` mid-quantiles of a log-normal, clipped to [lo, hi]."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(median * np.exp(sigma * z), lo, hi)


def exponential_gaps(n: int, rate: float) -> np.ndarray:
    """The ``n`` mid-quantiles of the gaps of a Poisson process at
    ``rate`` per second (mean ``1/rate``)."""
    return -np.log(1 - (np.arange(n) + 0.5) / n) / rate
