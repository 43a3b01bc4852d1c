"""sspv_tpu_torch — the PyTorch/CUDA port of sspv_tpu for NVIDIA Hopper GPUs.

It ports the offline signal path of the JAX package ``sspv_tpu``: the rows
view of 16 kHz audio -> fused per-frame features (energy, ZCR, spectral
entropy, MFCC) -> composite VAD -> VAD-gated banded-ACF pitch. The two
Pallas kernels of that path are hand-written CUDA kernels for ``sm_90a``
(``csrc/``); the rest is PyTorch. The JAX package stays the reference the
port is tested against. This package imports neither ``jax`` nor
``sspv_tpu``.

Every entry point takes its device explicitly; nothing picks one for you.
"""

from .ops.pipeline import FeatureBlock, FeatureConfig, FeaturePipeline

__version__ = "0.1.0"

__all__ = ["FeatureBlock", "FeatureConfig", "FeaturePipeline"]
