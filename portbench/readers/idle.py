"""The device's idle share of the traced window, in percent: one minus the
union of its kernels, copies and sets over the host's traced window (the
profiler's active step), which counts the idle time at both ends. None
without a trace."""

from __future__ import annotations


def read(ctx: dict):
    trace = ctx["trace"]
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
