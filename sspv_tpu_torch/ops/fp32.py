"""Float32 matmuls whatever the process-wide precision setting says.

The JAX package asks for ``Precision.HIGHEST`` at each matmul. PyTorch has
one process-wide setting instead, ``torch.get_float32_matmul_precision()``:
``"highest"`` by default, and under ``"high"`` or ``"medium"`` (or with
``torch.backends.cuda.matmul.allow_tf32`` set, which is the same switch) a
float32 product on an H100 rounds its operands to 10 mantissa bits or
fewer, which misses every parity gate of the L1 ops, the frontend modules
and the resampler. ``full_fp32`` sets ``"highest"`` for the products inside
it and puts the caller's setting back on the way out.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["full_fp32"]


@contextlib.contextmanager
def full_fp32(like: torch.Tensor):
    """Run the enclosed matmuls on ``like``'s device in full float32.
    Nothing to switch for a CPU tensor, nor where the setting is
    ``"highest"`` already (the default: then nothing is written at all).

    The setting is the process's, not the thread's: a matmul that another
    thread issues meanwhile runs at ``"highest"`` too, and two threads that
    overlap here can leave either's setting behind. Callers that share a
    process across threads set the precision once and leave it. Where a
    caller has set the precision through both of PyTorch's interfaces in
    ways that contradict each other, PyTorch's own check raises here.
    """
    matmul = torch.backends.cuda.matmul
    if not like.is_cuda or not matmul.allow_tf32:
        yield
        return
    before = torch.get_float32_matmul_precision()  # "high" or "medium"
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        # "high" goes back through the switch it may have come from: since
        # PyTorch 2.9 the string setter also writes the oneDNN matmul
        # setting, and after that a caller's ``allow_tf32 = False`` makes
        # ``get_float32_matmul_precision`` raise.
        if before == "high":
            matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision(before)
