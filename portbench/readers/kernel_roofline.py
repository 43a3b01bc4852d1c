"""A kernel's share of its roofline: the least time of the function it
computes (``yardstick.work``, from the shapes of the calls that ran whole
in the traced window) over the device time of the kernels named in the
metric's file, summed over the traced window, in percent.

Arguments: ``kernels``, substrings of the kernel names as the trace prints
them (a kernel counts once, whichever of them it matches); ``work``, the
function's name in ``yardstick.work.FUNCTIONS``. Nothing to read (no
trace, no call, or none of the kernels) returns None.
"""

from __future__ import annotations

from ..yardstick.work import FUNCTIONS, bound_s


def read(ctx: dict, kernels: list, work: str):
    trace, calls = ctx["trace"], ctx["calls"]
    if not trace or not calls:
        return None
    device_s = sum(s for name, s in trace["kernel_s"].items()
                   if any(k in name for k in kernels))
    if device_s <= 0:
        return None
    ops = nbytes = 0.0
    for call in calls:
        o, b = FUNCTIONS[work](ctx["cfg"], call)
        ops, nbytes = ops + o, nbytes + b
    return 100.0 * bound_s(ops, nbytes)[0] / device_s
