"""The Wiener-Khinchin short-time ACF of the pitch path.

Host-built (NumPy) bases: the port's copy of ``_acf_dft_bases`` /
``_acf_dft_bases_merged`` from ``sspv_tpu/ops/time_features.py:70-129``,
held bit-identical to them by ``tests/test_torch_bases.py``; ``acf_bases``
uploads them once per band and device. ``autocorrelation_via_dft``
(``time_features.py:133``) is the ACF of raw frames as three matmuls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "_acf_dft_bases",
    "_acf_dft_bases_merged",
    "acf_bases",
    "autocorrelation_via_dft",
]


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
    m = x @ merged
    nyq = x @ nyq_b
    power = m[:, :half] * m[:, :half] + m[:, half:] * m[:, half:]
    return power @ inv_live + (nyq * nyq)[:, None] * inv_nyq[None, :]
