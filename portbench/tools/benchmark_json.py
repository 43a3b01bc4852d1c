"""Write or check ``BENCHMARK.json`` from the files under ``portbench/``.

    python3 portbench/tools/benchmark_json.py [--check]

The cells are ``workloads/*.json``, the configurations the ones they
name, the end-to-end metrics ``end_to_end/*.json`` and the per-layer
metrics ``metrics/*.json``; a metric's cells are those its own file lists
and those whose files list it. ``run_seconds`` is ``RUN_SECONDS``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench.harness.core import CHECKOUT, all_of, cell_metrics, load  # noqa: E402

RUN_SECONDS = 30


def build() -> dict:
    cells = all_of("workloads")
    configs = []
    for name in sorted({c["config"] for c in cells}):
        c = load("configs", name)
        configs.append({"name": name, "source": c["source"],
                        "file": f"portbench/configs/{name}.json",
                        "reduced": c["reduced"], "why": c["why"]})
    e2e, layers = {}, {}
    for cell in cells:
        ends, per = cell_metrics(cell)
        for m in ends:
            e2e.setdefault(m["name"], (m, []))[1].append(cell["name"])
        for m in per:
            layers.setdefault(m["name"], (m, []))[1].append(cell["name"])
    out_e2e = []
    for name, (m, names) in sorted(e2e.items()):
        entry = {k: m[k] for k in ("name", "unit", "better", "bound", "source")}
        if "workloads" in m or len(names) < len(cells):
            entry["workloads"] = names
        out_e2e.append(entry)
    out_layers = []
    for name, (m, names) in sorted(layers.items()):
        entry = {k: m[k] for k in ("name", "unit", "better", "source", "layer",
                                   "moves")}
        entry["workloads"] = names
        out_layers.append(entry)
    return {
        "command": ["python3", "portbench/run.py"],
        "paths": ["portbench"],
        "run_seconds": RUN_SECONDS,
        "configs": configs,
        "workloads": [{k: c[k] for k in ("name", "config", "traffic", "chips",
                                         "why")} for c in cells],
        "end_to_end": out_e2e,
        "per_layer": out_layers,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if BENCHMARK.json differs from the files")
    args = ap.parse_args(argv)
    want = json.dumps(build(), indent=1) + "\n"
    path = CHECKOUT / "BENCHMARK.json"
    if args.check:
        have = path.read_text() if path.exists() else ""
        if have != want:
            print("BENCHMARK.json differs from portbench/'s files",
                  file=sys.stderr)
            return 1
        return 0
    path.write_text(want)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
