"""``BENCHMARK.json`` is what the files under ``portbench/`` say, and keeps
to the contract's shapes."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness.core import all_of, load

CHECKOUT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def test_matches_the_files():
    out = subprocess.run([sys.executable, "portbench/tools/benchmark_json.py",
                          "--check"], cwd=CHECKOUT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    pairs = {(c["config"], c["traffic"]) for c in BENCH["workloads"]}
    assert len(pairs) == len(names)
    for c in BENCH["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(c["name"]) and NAME.match(c["traffic"])
        assert c["chips"] == 1 and 1 <= len(c["why"]) <= 200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["reduced"] == [] and len(c["source"]) <= 200
        assert (CHECKOUT / c["file"]).is_file()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            # every cell a metric lists reports the metric it moves
            want = e2e[m["moves"]].get("workloads", names)
            assert cell in want, (m["name"], cell)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    # every cell reports setup_s, another end-to-end metric and a per-layer
    for cell in names:
        assert any(cell in m.get("workloads", names) for m in BENCH["end_to_end"]
                   if m["name"] != "setup_s")
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


def test_every_file_is_used():
    cells = all_of("workloads")
    for c in cells:
        load("configs", c["config"])
        t = load("traffic", c["traffic"])
        assert (CHECKOUT / "portbench" / "drivers" / f"{t['driver']}.py").is_file()
    for m in all_of("metrics"):
        assert (CHECKOUT / "portbench" / "readers" / f"{m['reader']}.py").is_file()


def test_files_are_named_from_names():
    for path in (CHECKOUT / "portbench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_.-]+$", path.name), path


@pytest.mark.cuda
def test_every_cell_runs_on_the_card(card):
    for c in BENCH["workloads"]:
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", c["name"],
             "--seed", "2147483901", "--seconds", "3", "--trace", "0"],
            cwd=CHECKOUT, capture_output=True, text=True, timeout=1200)
        assert out.returncode == 0, out.stderr[-2000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"], line["checks"]
        assert line["device"]["platform"] == "gpu"
