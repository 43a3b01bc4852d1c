"""The control of the comparison that decides ``correct``: the reference put
in the program's place, one precision below the configuration's (TF32
products for its float32, float32 history sums for its float64 VAD sums),
compared with the float64 reference over exactly the items a run of the
cell checks, at the cell's own sizes.

    python3 portbench/tools/control.py --workload <cell> --seeds 1,2,3
        [--seconds 20] [--device cuda]

Prints one JSON line per seed: the numbers compared, the cell's limits and
whether the control fails them (it must, on every seed). The benchmark's
own runs never compute it; ``portbench/tests/test_pb_checks.py`` runs it at
a small size.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def readings(cell_name, seed: int, seconds: float, device: str,
             overrides: dict | None = None) -> dict:
    from portbench.harness.core import Context, load_cell
    from portbench.reference.compare import Comparison, control

    cell = load_cell(cell_name)
    ctx = Context(cell, seed, device, overrides)
    drv = importlib.import_module(
        f"portbench.drivers.{ctx.traffic['driver']}").Driver(ctx)
    drv.inputs()
    band = ctx.band if drv.PITCH else None
    cmp = Comparison(pitch=band is not None)
    for pcm, frames in drv.checked(seconds):
        pcm = pcm.to(device)
        cmp.add(control(pcm, ctx.cfg, band), pcm, ctx.cfg, band, frames)
    values = cmp.values()
    limits = cell["checks"]
    return {"workload": cell["name"], "seed": seed, "items": cmp.items,
            "frames": cmp.frames, "values": values, "limits": limits,
            "control_fails": any(values[k] > limits[k] for k in limits)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), args.seconds,
                                  args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
