"""The ratio of two of the program's counters across the window, times
``scale``: ``num`` and ``den`` name the deltas the driver read (for
example the service's ``latency_sum_s`` and ``requests``). None where a
counter is missing or the denominator did not move."""

from __future__ import annotations


def read(ctx: dict, num: str, den: str, scale: float = 1.0):
    c = ctx["counters"]
    if num not in c or not c.get(den):
        return None
    return scale * c[num] / c[den]
