"""Host-built tables of the kernels' shared-memory FFT (``csrc/fft.cuh``).

Everything here is NumPy, built in float64 and rounded once to float32; the
wrappers upload a table once per size and device and pass it to the kernel,
which computes no sine or cosine itself.

The device FFT is a real-input FFT of ``n_fft`` points (a power of two in
``FFT_SIZES``) of ONE frame per warp:

1. the frame is packed as ``z[n] = x[2n] + i x[2n+1]``, ``n < n_fft/2``;
2. ``Z = FFT(z)`` by a self-sorting (Stockham, decimation in frequency)
   schedule of radix-8 and radix-4 stages, ``stage_plan``: every stage reads
   the whole sequence from one buffer and writes it, in the order the next
   stage wants, to the other, so the bins come out in natural order and no
   digit-reversal permutation is needed;
3. the bins ``0..n_fft/2`` of the real sequence are untangled from ``Z``
   pairwise: with ``E = (Z[k] + conj Z[M-k]) / 2``,
   ``O = (Z[k] - conj Z[M-k]) / 2i`` and ``W = exp(-2 pi i k / n_fft)``,
   ``X[k] = E + W O`` and ``X[M-k] = conj(E - W O)`` for ``k <= M/2``
   (``M = n_fft / 2``, ``Z[M]`` read as ``Z[0]``).

``twiddle_table`` lays out what steps 2 and 3 read; ``tests/
test_torch_fft_tables.py`` runs the same schedule from the same tables step
by step in PyTorch and holds it to ``torch.fft.rfft``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "FFT_SIZES",
    "acf_fft_size",
    "device_twiddles",
    "fft_route_size",
    "mel_ranges",
    "radix",
    "stage_plan",
    "stage_twiddle_floats",
    "twiddle_table",
    "untangle_floats",
]

# The sizes ``csrc/fft.cuh`` is instantiated for.
FFT_SIZES = (256, 512, 1024, 2048)


def radix(n_left: int) -> int:
    """Radix of the stage that splits a sub-sequence of ``n_left`` points:
    8, except that 16 and 4 split by 4 (so no stage of radix 2 is needed
    for any power of two >= 4)."""
    return 4 if n_left in (4, 16) else 8


def stage_plan(n_fft: int) -> tuple:
    """``(n_left, stride, radix)`` of every stage of the ``n_fft/2``-point
    complex FFT, in order: ``n_left`` is the length of the sub-sequences
    the stage splits, ``stride`` the number of them interleaved."""
    n, s, out = n_fft // 2, 1, []
    while n > 1:
        r = radix(n)
        out.append((n, s, r))
        n //= r
        s *= r
    return tuple(out)


def untangle_floats(n_fft: int) -> int:
    """Floats of the table's untangling section: cos then sin of
    ``2 pi k / n_fft`` for ``k = 0..n_fft/4``."""
    return 2 * (n_fft // 4 + 1)


def stage_twiddle_floats(n_left: int, r: int) -> int:
    """Floats of one stage's section: cos then sin of ``2 pi p j / n_left``
    at ``[(j - 1) * m + p]`` for ``j = 1..r-1``, ``p < m = n_left / r``;
    nothing for the last stage (``m == 1``: every twiddle is 1)."""
    m = n_left // r
    return 0 if m == 1 else 2 * (r - 1) * m


@functools.lru_cache(maxsize=8)
def _twiddle_table(n_fft: int) -> np.ndarray:
    if n_fft not in FFT_SIZES:
        raise ValueError(f"no FFT of {n_fft} points (sizes: {FFT_SIZES})")
    k = np.arange(n_fft // 4 + 1, dtype=np.float64)
    ang = 2.0 * np.pi * k / n_fft
    parts = [np.cos(ang), np.sin(ang)]
    for n_left, _, r in stage_plan(n_fft):
        m = n_left // r
        if m == 1:
            continue
        j = np.arange(1, r, dtype=np.float64)[:, None]
        p = np.arange(m, dtype=np.float64)[None, :]
        ang = 2.0 * np.pi * p * j / n_left
        parts += [np.cos(ang).ravel(), np.sin(ang).ravel()]
    return np.concatenate(parts).astype(np.float32)


def twiddle_table(n_fft: int) -> np.ndarray:
    """The float32 table of the ``n_fft``-point real FFT: the untangling
    section (``untangle_floats``), then one section per stage of
    ``stage_plan`` (``stage_twiddle_floats``). Sines are stored positive:
    the forward twiddle is ``cos - i sin``."""
    return _twiddle_table(int(n_fft)).copy()


@functools.lru_cache(maxsize=32)
def device_twiddles(n_fft: int, device: torch.device) -> torch.Tensor:
    """``twiddle_table(n_fft)`` on ``device``, uploaded once."""
    return torch.from_numpy(_twiddle_table(int(n_fft))).to(device)


def fft_route_size(frame_size: int, n_fft: int) -> int | None:
    """``n_fft`` if the device FFT serves a spectrum of ``n_fft`` points of
    ``frame_size`` samples (a power of two in ``FFT_SIZES``, no shorter
    than the frame), else None."""
    return n_fft if n_fft in FFT_SIZES and frame_size <= n_fft else None


def acf_fft_size(frame_size: int, n_lags: int) -> int | None:
    """The FFT size of the linear ACF of ``frame_size`` samples at lags
    ``0..n_lags-1``: the least power of two in ``FFT_SIZES`` that is
    >= ``frame_size + n_lags - 1`` (no lag wraps around), or None if the
    largest is too short."""
    need = frame_size + n_lags - 1
    return next((n for n in FFT_SIZES if n >= need), None)


def mel_ranges(fb_t: np.ndarray) -> np.ndarray:
    """``[start, end)`` of the bins where each filter of the
    ``(n_bins, num_filters)`` filterbank is nonzero, as an int32
    ``(num_filters, 2)`` array (``[0, 0)`` for an all-zero filter). The sum
    of ``power[k] * fb_t[k, m]`` over the range, in bin order, equals the
    dense product's column ``m`` up to the zeros it skips."""
    fb_t = np.asarray(fb_t)
    out = np.zeros((fb_t.shape[1], 2), dtype=np.int32)
    for m in range(fb_t.shape[1]):
        nz = np.flatnonzero(fb_t[:, m])
        if nz.size:
            out[m] = nz[0], nz[-1] + 1
    return out
