"""The port's compute layer: PyTorch on the device, three hand-written CUDA
kernels (``view_kernels`` on the signal-view path, ``frame_kernels`` on the
frames path).

Module names mirror ``sspv_tpu/ops`` so that each counterpart is easy to
find. Importing this package needs neither a GPU nor ``nvcc``: the kernels
build at their first launch.
"""

from .windows import get_window, hamming_window, hanning_window, rectangular_window
from .vad import (
    VadState,
    hangover_smooth,
    initial_packed_state,
    initial_states,
    initial_vad_state,
    pack_state,
    stack_states,
    streaming_vad,
    unpack_state,
    unstack_states,
    vad_state_from_numpy,
    vad_state_to_numpy,
)
from .view_kernels import LAUNCHES, fused_view_features, fused_view_pitch
from .frame_kernels import fused_features
from .preprocessing import frame_signal, num_frames_for, stream_frames
from .time_features import autocorrelation_via_dft
from .pitch import (
    pitch_from_frames,
    pitch_track,
    pitch_track_gated,
    pitch_track_signal,
    pitch_track_signal_gated,
)
from .pipeline import FeatureBlock, FeatureConfig, FeaturePipeline

__all__ = [
    "get_window",
    "hamming_window",
    "hanning_window",
    "rectangular_window",
    "VadState",
    "hangover_smooth",
    "initial_packed_state",
    "initial_states",
    "initial_vad_state",
    "pack_state",
    "stack_states",
    "streaming_vad",
    "unpack_state",
    "unstack_states",
    "vad_state_from_numpy",
    "vad_state_to_numpy",
    "LAUNCHES",
    "fused_view_features",
    "fused_view_pitch",
    "fused_features",
    "frame_signal",
    "num_frames_for",
    "stream_frames",
    "autocorrelation_via_dft",
    "pitch_from_frames",
    "pitch_track",
    "pitch_track_gated",
    "pitch_track_signal",
    "pitch_track_signal_gated",
    "FeatureBlock",
    "FeatureConfig",
    "FeaturePipeline",
]
