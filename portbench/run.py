"""The benchmark of ``sspv_tpu_torch`` on NVIDIA GPUs: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The run makes its audio on the card from the
seed, sets up and warms the cell's shapes, measures for ``--seconds``
seconds, checks what the measured path produced against the plain
reference (``portbench/reference/``), and prints one JSON line as the last
line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics from a ``torch.profiler`` trace with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines of standard error).

It exits with a code other than 0 and prints no result where there is no
CUDA device or fewer than the cell asks for, where the port is not the
checkout's own, or where ``jax``, ``jaxlib``, ``flax`` or ``sspv_tpu`` is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T_TOP = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True,
                    help="a cell: portbench/workloads/<name>.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness import core

    cell = core.load("workloads", args.workload)
    core.check_program_source()
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    line = core.run_cell(args.workload, args.seed, args.seconds,
                         bool(args.trace), T_TOP,
                         log=lambda s: print(s, file=sys.stderr))
    found = core.banned_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
