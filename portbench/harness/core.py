"""One run of one cell: find its files by name, set up, measure, check, and
build the result line.

Everything that belongs to one cell, configuration, traffic mix or metric
is a file of its own under ``portbench/``, found by the name that
``BENCHMARK.json`` gives:

- ``workloads/<cell>.json``: the configuration, the traffic mix, ``chips``,
  ``why``, the limits of the numbers compared (``checks``), and optionally
  the end-to-end and per-layer metrics it reports besides those whose own
  files list it;
- ``configs/<config>.json``: the ``FeatureConfig`` fields, the pitch band,
  the source and what was assumed;
- ``traffic/<mix>.json``: the parameters of the mix and the ``driver``
  that drives it (``drivers/<driver>.py``);
- ``end_to_end/<metric>.json`` and ``metrics/<metric>.json``: a metric's
  unit, direction, source and cells; a per-layer metric also names its
  reader (``readers/<reader>.py``) and the reader's arguments.

Nothing here knows a cell, a configuration or a metric by name, save
``setup_s``, which every cell reports.
"""

from __future__ import annotations

import importlib
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]  # portbench/
CHECKOUT = ROOT.parent
BANNED = ("jax", "jaxlib", "flax", "sspv_tpu")


def load(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"portbench: {path} is missing")
    with open(path) as f:
        return json.load(f)


def load_cell(cell) -> dict:
    """A cell's definition: its file under ``workloads/`` by name, or a
    dict of the same keys (a cell not in the benchmark, such as a test's)."""
    return dict(cell) if isinstance(cell, dict) else load("workloads", cell)


def all_of(kind: str) -> list[dict]:
    out = []
    for path in sorted((ROOT / kind).glob("*.json")):
        with open(path) as f:
            out.append(json.load(f))
    return out


def cell_metrics(cell: dict) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metric definitions a cell reports:
    those whose files list the cell, and those the cell's file lists."""
    name = cell["name"]

    def pick(kind, own):
        defs = all_of(kind)
        return [m for m in defs
                if ("workloads" not in m and kind == "end_to_end")
                or name in m.get("workloads", ()) or m["name"] in own]

    return (pick("end_to_end", cell.get("end_to_end", ())),
            pick("metrics", cell.get("per_layer", ())))


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def check_program_source() -> None:
    """The program must be the checkout's own ``sspv_tpu_torch``."""
    try:
        import sspv_tpu_torch
    except ImportError as e:
        raise SystemExit(f"portbench: no sspv_tpu_torch in the checkout "
                         f"{CHECKOUT}: {e}") from e

    where = Path(sspv_tpu_torch.__file__).resolve()
    if CHECKOUT.resolve() not in where.parents:
        raise SystemExit(f"portbench: sspv_tpu_torch imported from {where}, "
                         f"not from the checkout {CHECKOUT}")


class Context:
    """What a driver gets: the cell, its configuration and mix (with the
    overrides a test passes), the seed and the device."""

    def __init__(self, cell: dict, seed: int, device: str,
                 overrides: dict | None = None):
        self.cell = cell
        self.config = load("configs", cell["config"])
        self.traffic = {**load("traffic", cell["traffic"]), **(overrides or {})}
        self.cfg = dict(self.config["feature_config"])
        self.band = self.config.get("pitch")
        self.seed = int(seed)
        self.device = device
        self.tmpdir = tempfile.gettempdir()  # the run's TMPDIR


def run_cell(cell_name, seed: int, seconds: float, trace: bool,
             t_top: float, device: str = "cuda",
             overrides: dict | None = None, log=print) -> dict:
    """One run of a cell (a name or a definition, ``load_cell``): the
    result line as a dict (the ``checks`` key last)."""
    import torch

    from ..reference.compare import Comparison
    from .tracer import Tracer

    cell = load_cell(cell_name)
    ctx = Context(cell, seed, device, overrides)
    driver = importlib.import_module(
        f"portbench.drivers.{ctx.traffic['driver']}").Driver(ctx)
    e2e_defs, layer_defs = cell_metrics(cell)
    tracer = Tracer(trace, seconds, ctx.tmpdir)

    driver.setup(tracer)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_start = time.monotonic()
    setup_s = t_start - t_top
    tracer.begin(t_start)
    res = driver.window(seconds, tracer)
    peak = 0
    if on_card:
        torch.cuda.synchronize()
        peak = max(torch.cuda.max_memory_allocated(i)
                   for i in range(torch.cuda.device_count()))
    traced = tracer.close() if trace else None
    items = driver.release()

    metrics = {}
    if not trace:
        for m in e2e_defs:
            value = setup_s if m["name"] == "setup_s" else res["metrics"][m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        rctx = {"trace": traced, "counters": res.get("counters", {}),
                "measured": res["metrics"],
                "calls": tracer.calls, "cfg": ctx.cfg, "band": ctx.band}
        for m in layer_defs:
            reader = importlib.import_module(f"portbench.readers.{m['reader']}")
            value = reader.read(rctx, **m.get("args", {}))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    ref_device = "cuda" if on_card else "cpu"
    cmp = Comparison(pitch=ctx.band is not None and driver.PITCH)
    for pcm, program, frames in items:
        cmp.add(program, pcm.to(ref_device), ctx.cfg, ctx.band, frames)
    values = cmp.values()
    values["failed"] = res["failed"]
    limits = {**cell["checks"], "failed": 0}
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    correct = cmp.items > 0 and all(v["value"] <= v["limit"]
                                    for v in checks.values())

    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if on_card
                               else "cpu"),
                      "count": int(cell["chips"]),
                      "memory_peak_bytes": int(peak)}}
    if trace:
        out["device"]["busy_s"] = traced["busy_s"] if traced else 0.0
        out["device"]["window_s"] = traced["window_s"] if traced else 0.0
        if traced:
            out["breakdown"] = {"device_ops": traced["device_ops"],
                                "idle_gaps": traced["idle_gaps"]}
            log(f"portbench: trace kernels recorded {traced['kernels_recorded']}"
                f" of {traced['kernels_launched']} launched")
    for k, v in {**res.get("notes", {}), **tracer.notes}.items():
        log(f"portbench: {k} {v}")
    out["checks"] = checks
    return out
