#!/usr/bin/env python3
"""Importing the port needs no JAX, no sspv_tpu, no Triton and no GPU.

``sspv_tpu_torch`` must import cleanly where only PyTorch and NumPy are
installed (the machine with the card has no JAX), and importing it must not
initialize CUDA or build a kernel: the kernels build at first launch.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "sspv_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "sspv_tpu", "triton")


def test_import_leaves_jax_sspv_tpu_triton_and_cuda_alone():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import sspv_tpu_torch, sspv_tpu_torch.ops, sspv_tpu_torch.parallel\n"
        "import sspv_tpu_torch.batch, sspv_tpu_torch.analyze\n"
        "import sspv_tpu_torch.utils.export\n"
        "import sspv_tpu_torch.signal_processing, sspv_tpu_torch.models\n"
        "import sspv_tpu_torch.ops.resample, sspv_tpu_torch.utils.npz_io\n"
        "import sspv_tpu_torch.utils.profiling\n"
        "import sspv_tpu_torch.demo, sspv_tpu_torch.test_system\n"
        "from sspv_tpu_torch import SignalProcessing\n"
        "import torch\n"
        "from sspv_tpu_torch.ops import _build\n"
        f"bad = [m for m in {FORBIDDEN!r} if m in sys.modules]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert _build._lib is None\n"
        "assert 'matplotlib' not in sys.modules\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_sources_import_no_jax(path):
    """No module of the port, and not chip_smoke.py, imports jax, sspv_tpu
    or triton at any level (Triton would be allowed inside a launching
    function, but the port's kernels are CUDA C++)."""
    tree = ast.parse((REPO / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_npz_io_is_a_copy_of_the_original():
    """``utils/npz_io.py`` is NumPy only: source-equal to the JAX package's
    file but for the package name."""
    ours = (REPO / "sspv_tpu_torch" / "utils" / "npz_io.py").read_text()
    theirs = (REPO / "sspv_tpu" / "utils" / "npz_io.py").read_text()
    assert ours.replace("sspv_tpu_torch", "sspv_tpu") == theirs
