"""The port's compute layer: PyTorch on the device, two hand-written CUDA
kernels (``view_kernels``) on the signal-view path.

Module names mirror ``sspv_tpu/ops`` so that each counterpart is easy to
find. Importing this package needs neither a GPU nor ``nvcc``: the kernels
build at their first launch.
"""

from .windows import get_window, hamming_window, hanning_window, rectangular_window
from .vad import (
    VadState,
    hangover_smooth,
    initial_vad_state,
    streaming_vad,
    vad_state_from_numpy,
    vad_state_to_numpy,
)
from .view_kernels import LAUNCHES, fused_view_features, fused_view_pitch
from .pitch import pitch_track_signal, pitch_track_signal_gated
from .pipeline import FeatureBlock, FeatureConfig, FeaturePipeline

__all__ = [
    "get_window",
    "hamming_window",
    "hanning_window",
    "rectangular_window",
    "VadState",
    "hangover_smooth",
    "initial_vad_state",
    "streaming_vad",
    "vad_state_from_numpy",
    "vad_state_to_numpy",
    "LAUNCHES",
    "fused_view_features",
    "fused_view_pitch",
    "pitch_track_signal",
    "pitch_track_signal_gated",
    "FeatureBlock",
    "FeatureConfig",
    "FeaturePipeline",
]
