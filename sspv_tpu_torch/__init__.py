"""sspv_tpu_torch — the PyTorch/CUDA port of sspv_tpu for NVIDIA Hopper GPUs.

It ports the feature -> VAD -> pitch pipeline of the JAX package ``sspv_tpu``
and its streaming engine: per-frame energy, ZCR, spectral entropy and MFCC
of 16 kHz audio, the composite VAD, the VAD-gated banded-ACF pitch, on the
signal-view path (frame = 2 * hop) and on the frames path (any geometry),
and ``AudioRuntime`` over them; ``parallel.BatchPipeline`` runs batches of
signals and long signals over a mesh of devices, behind the ``batch`` and
``analyze`` CLIs. ``SignalProcessing`` (the historical static-method facade),
the function-for-function L1 ops in ``ops``, the ``models`` transforms and
the on-device resampler sit beside the pipeline, with the ``demo`` and
``test_system`` entry points over them. The three Pallas kernels of those paths are hand-written
CUDA kernels for ``sm_90a`` (``csrc/``); the rest is PyTorch.
The JAX package stays the reference the port is tested against. This
package imports neither ``jax`` nor ``sspv_tpu``.

Every entry point runs on the card (``device="cuda"``) unless the caller
asks for another device, such as ``device="cpu"``; without a card the
default raises instead of falling back to the CPU.
"""

from .config import Config
from .ops.pipeline import FeatureBlock, FeatureConfig, FeaturePipeline
from .runtime import AudioRuntime
from .signal_processing import SignalProcessing

__version__ = "0.4.0"

__all__ = ["AudioRuntime", "Config", "FeatureBlock", "FeatureConfig",
           "FeaturePipeline", "SignalProcessing"]
