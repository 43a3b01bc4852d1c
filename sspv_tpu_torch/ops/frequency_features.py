"""Frequency-domain features (Mel filterbank, MFCC, spectral entropy) and
the spectral tail of the feature path, in PyTorch.

Counterpart of ``sspv_tpu/ops/frequency_features.py``: ``mel_filterbank``
(:37), ``power_spectrum`` (:48, ``|rfft(frames, n_fft)|**2`` through
``torch.fft.rfft``), ``compute_mfcc`` (:55: filterbank product clamped at
1e-10, natural log, orthonormal DCT-II truncated to ``num_ceps``),
``calculate_spectral_entropy`` (:93) and ``entropy_from_power`` (:102);
``spectral_tail`` is ``FeaturePipeline._spectral_tail``
(``sspv_tpu/ops/pipeline.py:349``), the tail of the kernels' plain versions
(the CUDA kernels carry their own fused copy). The functions that take
frames run on the device of the frames, in float32 whatever the process's
TF32 switches say (``fp32.full_fp32``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import bases
from .fp32 import full_fp32

__all__ = [
    "calculate_spectral_entropy",
    "compute_mfcc",
    "entropy_from_power",
    "mel_filterbank",
    "power_spectrum",
    "spectral_tail",
]


def mel_filterbank(num_filters: int, n_fft: int, sample_rate: int,
                   fmin: float = 0.0, fmax: float | None = None, *,
                   device="cuda") -> torch.Tensor:
    """Mel filterbank matrix, ``(num_filters, n_fft//2 + 1)`` float32, on
    ``device``."""
    return torch.from_numpy(
        bases.mel_filterbank_np(num_filters, n_fft, sample_rate, fmin, fmax)
    ).to(device)


def power_spectrum(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    """``|rfft(frames, n_fft)|**2`` as float32, shape ``(.., n_fft//2+1)``
    (a frame longer than ``n_fft`` is truncated, as ``rfft(n=...)`` does)."""
    spec = torch.fft.rfft(frames.to(torch.float32), n=n_fft)
    return spec.real ** 2 + spec.imag ** 2


def compute_mfcc(frames: torch.Tensor, sample_rate: int, n_fft: int = 512,
                 num_filters: int = 26, num_ceps: int = 13, fmin: float = 0.0,
                 fmax: float | None = None) -> torch.Tensor:
    """MFCC matrix, shape ``(num_frames, num_ceps)`` float32."""
    x = frames.to(torch.float32)
    if x.numel() == 0:
        # the empty return keeps the CALLER's num_ceps; the clamp below
        # applies on the non-empty path only (a length-N DCT-II has N
        # coefficients)
        return x.new_zeros((0, int(num_ceps)))
    num_ceps = min(int(num_ceps), int(num_filters))
    power = power_spectrum(x, n_fft)
    fb_t = torch.from_numpy(np.ascontiguousarray(
        bases.mel_filterbank_np(num_filters, n_fft, sample_rate, fmin, fmax).T
    )).to(x.device)
    dct = torch.from_numpy(
        bases.dct_ortho_matrix(num_filters, num_ceps)).to(x.device)
    with full_fp32(x):
        return torch.log((power @ fb_t).clamp_min(1e-10)) @ dct


def calculate_spectral_entropy(frames: torch.Tensor,
                               n_fft: int = 512) -> torch.Tensor:
    """Normalized spectral entropy in [0, 1], shape ``(num_frames,)``."""
    x = frames.to(torch.float32)
    if x.numel() == 0:
        return x.new_zeros((0,))
    return entropy_from_power(power_spectrum(x, n_fft))


def entropy_from_power(psd: torch.Tensor) -> torch.Tensor:
    """Normalized Shannon entropy in [0, 1] of each row of a power spectrum
    (reference contract: zero-total rows normalize to 0 before the 1e-12
    clamp; natural log; divided by log(number of bins))."""
    psd_sum = psd.sum(dim=-1, keepdim=True)
    psd_norm = torch.where(psd_sum > 0, psd / psd_sum, torch.zeros_like(psd))
    psd_norm = psd_norm.clamp_min(1e-12)
    entropy = -(psd_norm * torch.log(psd_norm)).sum(dim=-1)
    return entropy / float(np.float32(np.log(psd.shape[-1])))


def spectral_tail(energy, zcr, power, *, fb_t, dct, lifter) -> dict:
    """Per-frame feature dict from energy, zcr and the ``(F, n_fft//2+1)``
    power spectrum: mel (clamped at 1e-10) -> log -> ortho DCT -> lifter,
    and the entropy of the same spectrum."""
    mel = (power @ fb_t).clamp_min(1e-10)
    mfcc = (torch.log(mel) @ dct) * lifter
    return {
        "energy": energy,
        "zcr": zcr,
        "entropy": entropy_from_power(power),
        "mfcc": mfcc,
    }
