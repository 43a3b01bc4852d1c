"""The spread of each end-to-end metric over sets of runs, and the bound it
suggests.

    python3 portbench/tools/spread.py SET_A_DIR [SET_B_DIR ...]

Each directory holds the standard output of runs, one file each named
``<cell>.<trace>.<seed>.out`` (the last line is the result line). Per cell and metric: each set's median and its
spread, the distance between the first and third quartile
(``statistics.quantiles(values, n=4)``) over the median; the widest of the
sets; and five times the widest spread over the cells, kept within 1 % and
25 %. ``setup_s`` leaves out each set's first run of a cell, which builds.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench.yardstick.stats import spread  # noqa: E402


def load_set(folder: str) -> dict:
    """``{(cell, metric): [values in run order]}`` of one set."""
    out = defaultdict(list)
    for path in sorted(Path(folder).glob("*.out"), key=os.path.getmtime):
        named = re.match(r"^(.+)\.[01]\.\d+\.out$", path.name)
        if not named:
            continue
        cell = named.group(1)
        lines = path.read_text().strip().splitlines()
        if not lines:
            continue
        try:
            line = json.loads(lines[-1])
        except json.JSONDecodeError:
            continue
        for name, m in line["metrics"].items():
            out[(cell, name)].append(m["value"])
    return out


def main(argv=None) -> int:
    sets = [load_set(d) for d in (argv or sys.argv[1:])]
    widest = defaultdict(float)
    for key in sorted(set().union(*sets)):
        cell, metric = key
        row = []
        for s in sets:
            v = s.get(key, [])
            if metric == "setup_s":
                v = v[1:]
            if len(v) >= 2:
                sp = spread(v)
                row.append((statistics.median(v), sp, len(v)))
                widest[metric] = max(widest[metric], sp)
        print(json.dumps({"cell": cell, "metric": metric,
                          "sets": [{"median": m, "spread": sp, "runs": n}
                                   for m, sp, n in row]}))
    for metric, sp in sorted(widest.items()):
        print(json.dumps({"metric": metric, "widest_spread": sp,
                          "bound_5x": min(0.25, max(0.01, 5 * sp))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
