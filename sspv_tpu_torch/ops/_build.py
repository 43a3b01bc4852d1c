"""Build, load and check the port's CUDA kernels.

The sources under ``sspv_tpu_torch/csrc/`` compile with ``nvcc`` for Hopper
(``sm_90a``) into ONE shared library with a plain C interface, which
``ctypes`` loads. The library lands in ``build/kernels/`` at the repo root,
named by a hash of the sources and flags, so the first use after a source
change rebuilds it and every later use loads it. Nothing here runs at import
time: the CPU-only test environment imports this module without ``nvcc``.

Every C entry point returns the ``cudaGetLastError()`` value from right after
its launch; :func:`check` turns a non-zero value into an exception (a refused
launch never runs, and a later synchronize does not report it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "check", "library"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# No --use_fast_math: logf, the divisions and the entropy's x*log(x) must stay
# IEEE, or ZCR, entropy and the F0 picks drift from the PyTorch versions.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME): no nvcc to "
                           "build the sspv_tpu_torch kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> tuple[Path, str]:
    """Compile the kernels unless a library of the current sources exists.
    Returns ``(library path, compiler output)``; the output (``ptxas``
    register and shared-memory lines) is empty when nothing was compiled."""
    sources = sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    out = BUILD_DIR / f"libsspv_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in sources if p.suffix == ".cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {res.returncode}:\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent process loads a whole file
    return out, res.stdout + res.stderr


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sspv_view_features.argtypes = [
        p, i, i, p, p, p, i, p, i, p, p, i, f, p, p, p, p, p,
    ]
    lib.sspv_view_features.restype = i
    lib.sspv_view_pitch.argtypes = [
        p, i, i, p, p, i, p, p, i, i, i, f, p, p, p,
    ]
    lib.sspv_view_pitch.restype = i
    lib.sspv_error_string.argtypes = [i]
    lib.sspv_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            _lib = _declare(ctypes.CDLL(str(path)))
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel launch reported a CUDA error."""
    if err:
        msg = library().sspv_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")
