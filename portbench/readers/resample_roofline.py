"""The resample kernel's share of its roofline: the least time of the
resampling the traced calls asked for over the device time of the kernels
named in the metric's file, summed over the traced window, in percent.

The work is the function's, whatever computes it, from what each call
recorded (``source_samples``, ``outputs``, ``up``, ``down``): bytes, each
row's true int16 source samples read once and its own int16 outputs
written once; operations, two (a multiply and an add) for each nonzero tap
of an output's phase, which over the ``up`` phases is the filter's nonzero
taps (``reference.resample.taps``) over ``up`` an output. The bound is the
larger of those against ``yardstick.work``'s peaks.

Argument: ``kernels``, substrings of the kernel names as the trace prints
them. None without a trace, a call that recorded its resample, or any of
the kernels.
"""

from __future__ import annotations

import functools

import numpy as np

from ..reference.resample import taps
from ..yardstick.work import bound_s


@functools.lru_cache(maxsize=None)
def _nonzero_taps(up: int, down: int) -> int:
    return int(np.count_nonzero(taps(up, down)))


def work(call: dict) -> tuple[float, float]:
    """``(ops, bytes)`` of one call's resample."""
    up, down = int(call["up"]), int(call["down"])
    ops = 2.0 * call["outputs"] * _nonzero_taps(up, down) / up
    return ops, 2.0 * (call["source_samples"] + call["outputs"])


def read(ctx: dict, kernels: list):
    trace = ctx["trace"]
    calls = [c for c in ctx["calls"] if "source_samples" in c]
    if not trace or not calls:
        return None
    device_s = sum(s for name, s in trace["kernel_s"].items()
                   if any(k in name for k in kernels))
    if device_s <= 0:
        return None
    ops = nbytes = 0.0
    for call in calls:
        o, b = work(call)
        ops, nbytes = ops + o, nbytes + b
    return 100.0 * bound_s(ops, nbytes)[0] / device_s
