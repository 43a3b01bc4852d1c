"""A ratio of the program's own spans (``sspv_tpu_torch.utils.profiling``),
read from its in-memory store after the profiler has stopped: the store
holds the spans of the profiler's active step, on every thread.

Arguments: ``num`` and ``den``, lists of span names; ``of``,
``"duration"`` (the summed seconds of the ``num`` spans) or ``"count"``
(their number); ``scale``. The value is ``scale`` times that over the
number of ``den`` spans. None where no ``den`` span was recorded, or where
the program keeps no spans.
"""

from __future__ import annotations


def totals() -> dict | None:
    """The program's per-name span totals, or None where it has none."""
    try:
        from sspv_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    return span_totals()


def read(ctx: dict, num: list, den: list, of: str = "duration",
         scale: float = 1.0):
    t = totals()
    if not t:
        return None
    n = sum(t[name]["count"] for name in den if name in t)
    if not n:
        return None
    key = {"duration": "seconds", "count": "count"}[of]
    return scale * sum(t[name][key] for name in num if name in t) / n
