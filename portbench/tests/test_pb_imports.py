"""What the harness loads, and where it refuses to run."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "sspv_tpu"}

PROBE = """
import json, runpy, sys
sys.argv = {argv!r}
sys.path.insert(0, {root!r})
try:
    {body}
except SystemExit:
    pass
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_modules(body: str, argv=("x",)) -> set:
    code = PROBE.format(argv=list(argv), root=str(CHECKOUT), body=body)
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_help_loads_no_jax():
    mods = _top_modules("runpy.run_path('portbench/run.py', run_name='__main__')",
                        ("portbench/run.py", "--help"))
    assert not mods & BANNED


def test_reference_and_harness_load_no_jax():
    mods = _top_modules(
        "import portbench.reference.compare, portbench.harness.core, "
        "portbench.drivers.resident_long, portbench.drivers.resident_batch, "
        "portbench.drivers.http_clips, portbench.drivers.live_streams, "
        "portbench.tools.control, portbench.readers.kernel_roofline")
    assert not mods & BANNED
    # the reference reads nothing of the port either
    ref = _top_modules("import portbench.reference.compare")
    assert "sspv_tpu_torch" not in ref


def test_the_client_needs_no_torch_or_numpy():
    mods = _top_modules("import portbench.drivers.http_client")
    assert not mods & {"torch", "numpy"}


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "sspv.longform.resident", "--seed", "2147483999", "--seconds", "1"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(CHECKOUT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "sspv.longform.resident", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
