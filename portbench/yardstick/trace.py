"""The device figures of a ``torch.profiler`` Chrome trace: busy time,
kernel time by name, the longest idle gaps and what the host was doing at
each.

Frozen copy of ``sspv_tpu_torch/tools/roofline.py`` (``_union``,
``_host_op_at``, ``_launch``, ``read_trace``). Changed from the original:

- the window is the host's traced window (the span of the profiler's
  active step, ``ProfilerStep#*`` on the host), not the first to the last
  device event, which left out the idle time at both ends;
- device events are clipped to that window before they are summed;
- kernel time by name is returned whole, for the roofline readers; the top
  operations and gaps are cut to ``TOP`` entries, in seconds;
- a trace with fewer kernels than launches is read all the same and says
  so (``kernels_recorded`` / ``kernels_launched``): a run cannot be
  repeated the way the tool repeated one call.
"""

from __future__ import annotations

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
TOP = 10
NAME_CHARS = 120


def union(intervals: list) -> list:
    """Sorted, merged ``[start, end]`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def host_op_at(t: float, host_ops: list) -> str:
    """The innermost host operation running at ``t`` (the latest-starting
    one that contains it), or ``"none"``."""
    inside = [e for e in host_ops if e["ts"] <= t <= e["ts"] + e["dur"]]
    return max(inside, key=lambda e: e["ts"])["name"] if inside else "none"


def _launch(e: dict) -> bool:
    return e.get("cat") in ("cuda_runtime", "cuda_driver") and \
        e["name"].startswith(("cudaLaunchKernel", "cuLaunchKernel"))


def host_window(events: list) -> tuple[float, float] | None:
    """``(start, end)`` in microseconds of the profiler's active step on
    the host: the ``ProfilerStep#*`` annotation that spans the traced
    window."""
    steps = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("ProfilerStep#")]
    if not steps:
        return None
    e = max(steps, key=lambda e: e["dur"])
    return float(e["ts"]), float(e["ts"] + e["dur"])


def read_trace(events: list) -> dict | None:
    """The device figures of a Chrome trace's events (microseconds in, seconds
    out), over the host's traced window; None without such a window or any
    device event in it."""
    win = host_window(events)
    if win is None:
        return None
    w0, w1 = win
    x = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = []
    for e in x:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b > a:
            dev.append((e, a, b))
    if not dev:
        return None
    launched = sum(_launch(e) and w0 <= e["ts"] <= w1 for e in x)
    recorded = sum(e["cat"] == "kernel" for e, _, _ in dev)
    spans = union([[a, b] for _, a, b in dev])
    busy = sum(b - a for a, b in spans)
    by_name: dict[str, float] = {}
    for e, a, b in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
    edges = [w0] + [v for ab in spans for v in ab] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    host_ops = [e for e in x if e.get("cat") in HOST_CATS
                and not str(e.get("name", "")).startswith("ProfilerStep#")]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy / 1e6,
        "kernel_s": {k: v / 1e6 for k, v in by_name.items()},
        "device_ops": [[name[:NAME_CHARS], s / 1e6] for name, s in top],
        "idle_gaps": [[host_op_at(t, host_ops)[:NAME_CHARS], g / 1e6]
                      for g, t in gaps],
        "kernels_recorded": recorded,
        "kernels_launched": launched,
    }
