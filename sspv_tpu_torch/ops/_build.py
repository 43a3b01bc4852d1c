"""Build, load and check the port's CUDA kernels.

The sources under ``sspv_tpu_torch/csrc/`` compile with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per ``.cu`` file and all at once, and link into
ONE shared library with a plain C interface, which ``ctypes`` loads. The
library lands in ``build/kernels/`` at the repo root, named by a hash of the
sources and flags, so the first use after a source change rebuilds it and
every later use loads it. Nothing here runs at import time: the CPU-only
test environment imports this module without ``nvcc``.

Every C entry point returns the ``cudaGetLastError()`` value from right after
its launch; :func:`check` turns a non-zero value into an exception (a refused
launch never runs, and a later synchronize does not report it).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["BUILD_DIR", "LAUNCHES", "NVCC_FLAGS", "ROUTES", "build", "check",
           "count", "library", "recording"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# No --use_fast_math: logf, the divisions and the entropy's x*log(x) must stay
# IEEE, or ZCR, entropy and the F0 picks drift from the PyTorch versions.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Kernel launches per wrapper since the last reset: each wrapper adds one
# where it launches its kernel and nowhere else, so a caller can show that
# a run went through the kernels.
LAUNCHES = {"view_features": 0, "view_pitch": 0, "frame_features": 0,
            "vad": 0, "resample": 0}
# Launches of K3 by route ("fft": the shared-memory FFT kernel, "dense": the
# DFT pair on the tensor cores); they add up to LAUNCHES["frame_features"].
# K4's window sums ("direct" or "blocked") add up to LAUNCHES["vad"].
ROUTES = {"frame_features_fft": 0, "frame_features_dense": 0,
          "vad_direct": 0, "vad_blocked": 0}
# Guards both dicts: threads of one server launch the kernels concurrently,
# and a bare ``+= 1`` is a read-modify-write that can lose a count.
_count_lock = threading.Lock()
# Per thread: the list that ``recording`` collects this thread's counts in,
# or None.
_recorder = threading.local()

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
    nvcc = _nvcc()

    def run(cmd: list) -> str:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {res.returncode}:\n"
                               f"{res.stdout}{res.stderr}")
        return res.stdout + res.stderr

    units = [p for p in sources if p.suffix == ".cu"]
    objects = [f"{tmp}.{p.stem}.o" for p in units]
    try:
        with ThreadPoolExecutor(len(units)) as pool:
            logs = list(pool.map(
                lambda po: run([nvcc, *NVCC_FLAGS, "-c", str(po[0]), "-o",
                                po[1]]), zip(units, objects)))
        logs.append(run([nvcc, "-shared", "-o", str(tmp), *objects]))
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, out)  # atomic: a concurrent process loads a whole file
    return out, "".join(logs)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sspv_view_features.argtypes = [
        p, i, i, p, p, i, p, p, i, p, p, i, f, p, p, p, p, p,
    ]
    lib.sspv_view_features.restype = i
    lib.sspv_view_pitch.argtypes = [p, i, i, p, i, i, i, f, p, p, p]
    lib.sspv_view_pitch.restype = i
    lib.sspv_frame_features_dense.argtypes = [
        p, i, i, p, p, i, i, i, p, p, i, p, p, i, f, i, p, p, p, p, p,
    ]
    lib.sspv_frame_features_dense.restype = i
    lib.sspv_frame_features_fft.argtypes = [
        p, i, i, p, p, i, p, p, i, p, p, i, f, i, p, p, p, p, p,
    ]
    lib.sspv_frame_features_fft.restype = i
    d = ctypes.c_double
    lib.sspv_streaming_vad.argtypes = [
        p, p, p, p, p, i, p, p, p, p, i, i, i, d, d, d, d, d, d, d, d, i, i,
        p, p, p, p, p, p, p, p,
    ]
    lib.sspv_streaming_vad.restype = i
    lib.sspv_resample_rows.argtypes = [p, p, i, i, i, p, i, i, i, i, i, p, p]
    lib.sspv_resample_rows.restype = i
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


@contextlib.contextmanager
def recording():
    """Collect the launches this thread counts in a list of ``(kernel,
    route)``, in place of adding them to ``LAUNCHES`` and ``ROUTES``: a CUDA
    graph's capture launches nothing, and each replay of the graph counts
    what its capture collected."""
    launches: list[tuple[str, str | None]] = []
    _recorder.launches = launches
    try:
        yield launches
    finally:
        _recorder.launches = None


def count(kernel: str, route: str | None = None) -> None:
    """Add one launch of ``kernel`` (and of its ``route``, a key of
    ``ROUTES``) to the counts, under a lock, or to this thread's
    :func:`recording`."""
    launches = getattr(_recorder, "launches", None)
    if launches is not None:
        launches.append((kernel, route))
        return
    with _count_lock:
        LAUNCHES[kernel] += 1
        if route is not None:
            ROUTES[route] += 1


def check(err: int, what: str) -> None:
    """Raise if a kernel launch reported a CUDA error."""
    if err:
        msg = library().sspv_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")
