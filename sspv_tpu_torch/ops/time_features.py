"""Time-domain features over ``(num_frames, frame_size)`` batches, and the
Wiener-Khinchin short-time ACF of the pitch path.

Counterpart of ``sspv_tpu/ops/time_features.py``. Every function runs on the
device of its ``frames`` tensor, in float32:

- short-time energy ``sum(frames**2)`` (:35);
- zero-crossing rate: sign changes (``sign`` semantics: a zero is its own
  level; no DC removal, no /2) divided by the frame length (:43). This is
  a true float32 division, as the eager JAX function computes it; the
  pipeline's kernels multiply by the float32 reciprocal instead (what XLA
  compiles), one ulp apart for some counts;
- the direct sliding-sum ACF at lags ``0..max_lag`` (:54) and the AMDF at
  lags ``lag_start..max_lag`` (:167): one slice product per lag, written
  into a preallocated ``(F, lags)`` result so that only one ``(F, frame)``
  temporary lives at a time;
- ``autocorrelation_via_dft`` (:133): the ACF of raw frames as three
  matmuls over host-built (NumPy) bases, the port's copy of
  ``_acf_dft_bases`` / ``_acf_dft_bases_merged`` (:70-129), held
  bit-identical to them by ``tests/test_torch_bases.py``; ``acf_bases``
  uploads them once per band and device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .fp32 import full_fp32

__all__ = [
    "_acf_dft_bases",
    "_acf_dft_bases_merged",
    "acf_bases",
    "autocorrelation_via_dft",
    "calculate_average_magnitude_difference",
    "calculate_short_time_autocorrelation",
    "calculate_short_time_energy",
    "calculate_zero_crossing_rate",
]


def _f32(frames: torch.Tensor) -> torch.Tensor:
    return frames if frames.dtype == torch.float32 else frames.to(torch.float32)


def calculate_short_time_energy(frames: torch.Tensor) -> torch.Tensor:
    """Per-frame short-time energy, float32, shape ``(num_frames,)``."""
    x = _f32(frames)
    if x.numel() == 0:
        return x.new_zeros((0,))
    return (x * x).sum(dim=-1)


def zero_crossing_rate(x: torch.Tensor) -> torch.Tensor:
    """Sign changes along the last axis over its length, as a true float32
    division: the divisor is a tensor on the device, because a Python
    scalar divisor becomes a multiply by the reciprocal on CUDA."""
    signs = torch.sign(x)
    crossings = (signs[..., 1:] != signs[..., :-1]).sum(dim=-1)
    size = torch.full((), float(x.shape[-1]), dtype=torch.float32,
                      device=x.device)
    return crossings.to(torch.float32) / size


def calculate_zero_crossing_rate(frames: torch.Tensor) -> torch.Tensor:
    """Per-frame zero-crossing rate, float32, shape ``(num_frames,)``."""
    x = _f32(frames)
    if x.numel() == 0:
        return x.new_zeros((0,))
    return zero_crossing_rate(x)


def calculate_short_time_autocorrelation(frames: torch.Tensor,
                                         max_lag: int) -> torch.Tensor:
    """Short-time autocorrelation ``R[:, lag] = sum(frames[:, :-lag] *
    frames[:, lag:])`` for lags ``0..max_lag``: ``(num_frames, max_lag + 1)``
    float32."""
    x = _f32(frames)
    num_frames = x.shape[0] if x.dim() == 2 else 0
    if num_frames == 0 or x.numel() == 0 or max_lag < 0:
        return x.new_zeros((num_frames, max(0, max_lag + 1)))
    out = x.new_empty((num_frames, max_lag + 1))
    for lag in range(max_lag + 1):
        a = x if lag == 0 else x[:, :-lag]
        torch.sum(a * x[:, lag:], dim=1, out=out[:, lag])
    return out


def calculate_average_magnitude_difference(frames: torch.Tensor, max_lag: int,
                                           lag_start: int = 1) -> torch.Tensor:
    """Average magnitude difference ``mean(|frames[:, :-lag] - frames[:,
    lag:]|)`` for lags ``lag_start..max_lag``: ``(num_frames, max_lag -
    lag_start + 1)`` float32. ``lag_start=1`` is the historical surface; the
    AMDF pitch tracker starts at its band's first lag."""
    x = _f32(frames)
    num_frames = x.shape[0] if x.dim() == 2 else 0
    lag_start = max(1, int(lag_start))
    if num_frames == 0 or x.numel() == 0 or max_lag < lag_start:
        return x.new_zeros((num_frames, max(0, max_lag - lag_start + 1)))
    out = x.new_empty((num_frames, max_lag - lag_start + 1))
    for lag in range(lag_start, max_lag + 1):
        torch.mean((x[:, :-lag] - x[:, lag:]).abs_(), dim=1,
                   out=out[:, lag - lag_start])
    return out


@functools.lru_cache(maxsize=8)
def _acf_dft_bases(frame_size: int, max_lag: int):
    """Real-DFT and inverse-cosine bases for the Wiener-Khinchin ACF
    (float64 build, rounded once to float32).

    ``nfft >= frame_size + max_lag`` makes the circular correlation equal the
    linear one for lags 0..max_lag (no wrap-around), rounded up to a multiple
    of 128 (the JAX package's MXU tiling; the port keeps the same constants).
    """
    nfft = frame_size + max_lag
    nfft = -(-nfft // 128) * 128
    k = nfft // 2 + 1
    n = np.arange(frame_size, dtype=np.float64)[:, None]
    ks = np.arange(k, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * ks / nfft
    cos_b = np.cos(ang).astype(np.float32)  # (frame_size, k)
    sin_b = np.sin(ang).astype(np.float32)
    # inverse: R[lag] = (1/nfft) * sum_k w_k |X_k|^2 cos(2*pi*k*lag/nfft),
    # w_k = 2 except the DC and (even-nfft) Nyquist bins
    lags = np.arange(max_lag + 1, dtype=np.float64)[None, :]
    w = np.full((k, 1), 2.0)
    w[0, 0] = 1.0
    if nfft % 2 == 0:
        w[-1, 0] = 1.0
    inv = (
        w * np.cos(2.0 * np.pi * np.arange(k, dtype=np.float64)[:, None] * lags / nfft)
        / nfft
    ).astype(np.float32)  # (k, max_lag+1)
    return cos_b, sin_b, inv


@functools.lru_cache(maxsize=8)
def _acf_dft_bases_merged(frame_size: int, max_lag: int):
    """Merged repacking of :func:`_acf_dft_bases`: the live cos/sin bins
    side by side in one ``(frame_size, nfft)`` basis, and the Nyquist bin
    (sin column identically zero; nfft is a multiple of 128, hence even)
    peeled off as a matvec plus a rank-1 inverse term.

    Returns ``(merged (frame, nfft), nyq (frame,), inv_live (nfft//2, L+1),
    inv_nyq (L+1,))`` with
    ``acf = p_live @ inv_live + p_nyq[:, None] * inv_nyq[None, :]``.
    """
    cos_b, sin_b, inv = _acf_dft_bases(frame_size, max_lag)
    half = cos_b.shape[1] - 1  # nfft // 2
    merged = np.ascontiguousarray(
        np.concatenate([cos_b[:, :half], sin_b[:, :half]], axis=1)
    )
    return (
        merged,
        np.ascontiguousarray(cos_b[:, half]),
        np.ascontiguousarray(inv[:half]),
        np.ascontiguousarray(inv[half]),
    )


@functools.lru_cache(maxsize=32)
def acf_bases(frame_size: int, lag_max: int, device: torch.device) -> tuple:
    """``(merged, nyq_b, inv_live, inv_nyq)`` of
    ``_acf_dft_bases_merged(frame_size, lag_max)`` as float32 tensors on
    ``device``, uploaded once per band and device."""
    return tuple(
        torch.from_numpy(np.ascontiguousarray(b)).to(device)
        for b in _acf_dft_bases_merged(int(frame_size), int(lag_max))
    )


def autocorrelation_via_dft(frames: torch.Tensor, max_lag: int,
                            bases: tuple | None = None) -> torch.Tensor:
    """Short-time ACF at lags ``0..max_lag`` of raw ``(F, frame_size)``
    frames: the power spectrum from the merged real-DFT matmul, then the
    inverse-cosine matmul back to the lag domain. Returns
    ``(F, max_lag + 1)`` float32. ``bases`` overrides
    ``acf_bases(frame_size, max_lag)``."""
    x = frames.to(torch.float32)
    if x.dim() != 2 or x.shape[0] == 0 or max_lag < 0:
        f = x.shape[0] if x.dim() == 2 else 0
        return x.new_zeros((f, max(0, max_lag + 1)))
    merged, nyq_b, inv_live, inv_nyq = (
        bases if bases is not None
        else acf_bases(x.shape[1], int(max_lag), x.device)
    )
    half = merged.shape[1] // 2
    with full_fp32(x):  # float32 whatever the process's TF32 switches say
        m = x @ merged
        nyq = x @ nyq_b
        power = m[:, :half] * m[:, :half] + m[:, half:] * m[:, half:]
        return power @ inv_live + (nyq * nyq)[:, None] * inv_nyq[None, :]
