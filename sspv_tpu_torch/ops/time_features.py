"""Host-built (NumPy) bases of the Wiener-Khinchin ACF that the pitch path
uses: the port's copy of ``_acf_dft_bases`` / ``_acf_dft_bases_merged``
from ``sspv_tpu/ops/time_features.py:70-129``, held bit-identical to them by
``tests/test_torch_bases.py``."""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["_acf_dft_bases", "_acf_dft_bases_merged"]


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
