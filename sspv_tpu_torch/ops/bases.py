#!/usr/bin/env python3
"""Precomputed constant bases (NumPy), the port's copy of
``sspv_tpu/ops/bases.py``.

Everything here runs once on the host in NumPy (float64 where it matters);
the pipeline uploads the results to its device once. The port cannot import
the JAX package's copy (importing anything under ``sspv_tpu`` imports jax),
so it keeps this one; ``tests/test_torch_bases.py`` holds the two
bit-identical. What it builds:

- real-input DFT as a pair of (frame_size, n_bins) matmul bases, so the
  kernels compute the power spectrum as a GEMM without an FFT
  (reference computes ``np.fft.rfft(frames, n_fft)`` per call,
  frequency_features.py:147,183);
- the Mel filterbank matrix with the reference's exact integer-bin triangle
  construction including the degenerate-bin collision fix
  (frequency_features.py:47-105);
- the orthonormal DCT-II matrix standing in for ``scipy.fftpack.dct(type=2,
  norm='ortho')`` (frequency_features.py:157);
- the cepstral lifter vector (signal_processing/__init__.py:171-174).
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "mel_filterbank_np",
    "dft_bases",
    "windowed_dft_bases",
    "merged_windowed_dft_bases",
    "dct_ortho_matrix",
    "lifter_vector",
]


def _hz_to_mel(freq_hz: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + freq_hz / 700.0)


def _mel_to_hz(freq_mel: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (freq_mel / 2595.0) - 1.0)


@functools.lru_cache(maxsize=32)
def _mel_filterbank_cached(
    num_filters: int, n_fft: int, sample_rate: int, fmin: float, fmax: float
) -> np.ndarray:
    mel_min = float(_hz_to_mel(np.array([fmin]))[0])
    mel_max = float(_hz_to_mel(np.array([fmax]))[0])
    mel_points = np.linspace(mel_min, mel_max, num_filters + 2)
    hz_points = _mel_to_hz(mel_points)
    # spectral-line index per band edge (floor; reference frequency_features.py:85)
    bin_points = np.floor((n_fft + 1) * hz_points / sample_rate).astype(int)

    n_bins = n_fft // 2 + 1
    fb = np.zeros((num_filters, n_bins), dtype=np.float32)
    for i in range(1, num_filters + 1):
        left, center, right = bin_points[i - 1], bin_points[i], bin_points[i + 1]
        # degenerate-bin collision fix (frequency_features.py:89-94)
        if center == left:
            center += 1
        if right == center:
            right += 1
        up = np.arange(left, center)
        fb[i - 1, left:center] = (up - left) / (center - left)
        down = np.arange(center, right)
        fb[i - 1, center:right] = (right - down) / (right - center)
    return fb[:, :n_bins].astype(np.float32)


def mel_filterbank_np(
    num_filters: int,
    n_fft: int,
    sample_rate: int,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Mel filterbank, shape ``(num_filters, n_fft//2 + 1)``, float32."""
    if fmax is None:
        fmax = sample_rate / 2
    return _mel_filterbank_cached(
        int(num_filters), int(n_fft), int(sample_rate), float(fmin), float(fmax)
    ).copy()


@functools.lru_cache(maxsize=16)
def _dft_bases_cached(frame_size: int, n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT bases of shape (frame_size, n_fft//2+1), float32.

    ``rfft(x, n_fft)[k] == sum_n x[n] * exp(-2j*pi*k*n/n_fft)`` for
    ``n < min(frame_size, n_fft)``; zero-padding beyond frame_size is implied
    by truncating the basis to frame_size rows. When frame_size > n_fft the
    input would be truncated instead — we keep only the first n_fft rows then.
    """
    n_used = min(frame_size, n_fft)
    n_bins = n_fft // 2 + 1
    n = np.arange(n_used, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * n * k / float(n_fft)
    cos_b = np.zeros((frame_size, n_bins), dtype=np.float64)
    sin_b = np.zeros((frame_size, n_bins), dtype=np.float64)
    cos_b[:n_used] = np.cos(ang)
    sin_b[:n_used] = np.sin(ang)
    return cos_b.astype(np.float32), sin_b.astype(np.float32)


def dft_bases(frame_size: int, n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) rDFT bases: ``spectrum = x @ cos + 1j * (x @ sin)``."""
    c, s = _dft_bases_cached(int(frame_size), int(n_fft))
    # copies, like every sibling helper: a caller that mutates a returned
    # basis must not poison the cache
    return c.copy(), s.copy()


@functools.lru_cache(maxsize=16)
def _windowed_dft_cached(
    frame_size: int, n_fft: int, window_type: str
) -> tuple[np.ndarray, np.ndarray]:
    from .windows import get_window

    c, s = _dft_bases_cached(frame_size, n_fft)
    w = get_window(window_type, frame_size).astype(np.float64)[:, None]
    return (c.astype(np.float64) * w).astype(np.float32), (
        s.astype(np.float64) * w
    ).astype(np.float32)


def windowed_dft_bases(
    frame_size: int, n_fft: int, window_type: str
) -> tuple[np.ndarray, np.ndarray]:
    """DFT bases with the analysis window folded in, so the fused kernel can go
    straight from raw frames to the windowed spectrum in one matmul pair."""
    wc, ws = _windowed_dft_cached(int(frame_size), int(n_fft), str(window_type))
    return wc.copy(), ws.copy()


@functools.lru_cache(maxsize=16)
def _merged_windowed_dft_cached(
    frame_size: int, n_fft: int, window_type: str
) -> tuple[np.ndarray, np.ndarray]:
    wc, ws = _windowed_dft_cached(frame_size, n_fft, window_type)
    half = n_fft // 2
    merged = np.ascontiguousarray(
        np.concatenate([wc[:, :half], ws[:, :half]], axis=1)
    )
    nyq = np.ascontiguousarray(wc[:, half])
    return merged, nyq


def merged_windowed_dft_bases(
    frame_size: int, n_fft: int, window_type: str
) -> tuple[np.ndarray, np.ndarray]:
    """Merged repacking of :func:`windowed_dft_bases` for even ``n_fft``:
    the live bins ``0..half-1`` of cos and sin side by side in one
    ``(frame, n_fft)`` basis (one GEMM instead of two), and the windowed
    Nyquist cos column apart (its sin column is identically zero). Each bin
    is the same dot product over the same rows as in the pair layout.

    Returns ``(merged, nyq)``: ``(frame_size, n_fft)`` and ``(frame_size,)``.
    """
    if int(n_fft) % 2 != 0:
        raise ValueError("merged DFT layout requires even n_fft")
    merged, nyq = _merged_windowed_dft_cached(
        int(frame_size), int(n_fft), str(window_type)
    )
    return merged.copy(), nyq.copy()


@functools.lru_cache(maxsize=16)
def _dct_cached(n_in: int, n_out: int) -> np.ndarray:
    # Orthonormal DCT-II: y[k] = c_k * sum_n x[n] * cos(pi*k*(2n+1)/(2N))
    # with c_0 = sqrt(1/N), c_k = sqrt(2/N); equals scipy.fftpack.dct
    # (type=2, norm="ortho").
    n = np.arange(n_in, dtype=np.float64)[:, None]
    k = np.arange(n_out, dtype=np.float64)[None, :]
    basis = np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * n_in))
    scale = np.full((1, n_out), np.sqrt(2.0 / n_in))
    scale[0, 0] = np.sqrt(1.0 / n_in)
    return (basis * scale).astype(np.float32)


def dct_ortho_matrix(n_in: int, n_out: int) -> np.ndarray:
    """DCT-II (ortho) as a ``(n_in, n_out)`` matrix: ``mfcc = log_mel @ D``."""
    return _dct_cached(int(n_in), int(n_out)).copy()


@functools.lru_cache(maxsize=16)
def _lifter_cached(num_ceps: int, lifter: int) -> np.ndarray:
    n = np.arange(num_ceps, dtype=np.float64)
    return (1.0 + (lifter / 2.0) * np.sin(np.pi * n / lifter)).astype(np.float32)


def lifter_vector(num_ceps: int, lifter: int | None) -> np.ndarray:
    """Cepstral lifter ``1 + L/2 * sin(pi*n/L)``; ones when lifter is falsy."""
    if not lifter or lifter <= 0:
        return np.ones(num_ceps, dtype=np.float32)
    return _lifter_cached(int(num_ceps), int(lifter)).copy()
