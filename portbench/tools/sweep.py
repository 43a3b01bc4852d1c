"""The knee of an open-loop cell: its load stepped up in one process, one
window at each step, to find the highest load the port sustains.

    python3 portbench/tools/sweep.py --workload <cell> --param rate_per_s
        --values 10,20,30 [--seconds 10] [--seed n]

``--param`` is the traffic parameter stepped (``rate_per_s`` of
``http_clips``, ``streams`` of ``live_streams``). One JSON line per step:
the p50 and p95 of the cell's latency, the requests or frames that never
came, and ``growth``, the median latency of the window's last third over
its first third (by due time). A step is sustained where nothing failed
and ``growth`` stays under ``GROWTH``: above it the backlog grew through
the window. The knee is the highest sustained step; the cell's file then
fixes its load at about four fifths of it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

GROWTH = 1.5


def summary(due, lat) -> dict:
    due, lat = np.asarray(due), np.asarray(lat, dtype=float)
    order = np.argsort(due)
    lat = lat[order]
    third = max(1, len(lat) // 3)
    first, last = np.median(lat[:third]), np.median(lat[-third:])
    growth = float(last / first) if first > 0 else float("inf")
    failed = int(np.isinf(lat).sum())
    return {"n": int(len(lat)), "failed": failed,
            "p50_ms": 1e3 * float(np.percentile(lat, 50)),
            "p95_ms": 1e3 * float(np.percentile(lat, 95)),
            "growth": growth,
            "sustained": failed == 0 and growth < GROWTH}


def main(argv=None) -> int:
    from portbench.harness.core import Context, load
    from portbench.harness.tracer import Tracer

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--param", required=True)
    ap.add_argument("--values", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=2147483001)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default="{}",
                    help="JSON of traffic parameters to set (small CPU runs)")
    args = ap.parse_args(argv)
    cell = load("workloads", args.workload)
    values = [float(v) for v in args.values.split(",")]
    shared = None
    for v in values:
        ctx = Context(cell, args.seed, args.device,
                      {**json.loads(args.overrides), args.param: v})
        mod = importlib.import_module(
            f"portbench.drivers.{ctx.traffic['driver']}")
        if args.param == "rate_per_s" and shared is not None:
            drv = shared  # one server for every rate
            drv.rate = v
        else:
            if shared is not None:
                shared.release()
            drv = mod.Driver(ctx)
            drv.setup(Tracer(False, args.seconds, ctx.tmpdir))
            shared = drv
        res = drv.window(args.seconds, Tracer(False, args.seconds, ctx.tmpdir))
        print(json.dumps({"workload": args.workload, args.param: v,
                          **summary(*drv.last),
                          "counters": res.get("counters", {})}), flush=True)
    if shared is not None:
        shared.release()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
