"""Spectral tail of the feature path in PyTorch: mel -> log -> DCT ->
lifter and the spectral entropy, from an already computed power spectrum.

Counterparts: ``entropy_from_power`` (``sspv_tpu/ops/frequency_features.py:
102``) and ``FeaturePipeline._spectral_tail`` (``sspv_tpu/ops/pipeline.py:
349``). These are the plain versions' tail; the CUDA kernel carries its own
fused copy.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["entropy_from_power", "spectral_tail"]


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
