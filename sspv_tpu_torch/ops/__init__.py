"""The port's compute layer: PyTorch on the device, four hand-written CUDA
kernels (``view_kernels`` on the signal-view path, ``frame_kernels`` on the
frames path, ``vad_kernels`` for the composite VAD after either), and the function-for-function L1 ops (windows, framing, time
and frequency features, VAD masks, pitch, resampling) that reach no kernel
in the JAX package either.

Module names mirror ``sspv_tpu/ops`` so that each counterpart is easy to
find. Importing this package needs neither a GPU nor ``nvcc``: the kernels
build at their first launch.
"""

from .windows import get_window, hamming_window, hanning_window, rectangular_window
from .vad import (
    VadState,
    adaptive_voice_activity_detection,
    hangover_smooth,
    hangover_smooth_scan,
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
    voice_activity_detection,
)
from .view_kernels import LAUNCHES, fused_view_features, fused_view_pitch
from .frame_kernels import ROUTES, fused_features
from .vad_kernels import fused_streaming_vad
from .preprocessing import (
    frame_signal,
    framing,
    num_frames_for,
    preemphasis,
    stream_frames,
)
from .time_features import (
    autocorrelation_via_dft,
    calculate_average_magnitude_difference,
    calculate_short_time_autocorrelation,
    calculate_short_time_energy,
    calculate_zero_crossing_rate,
)
from .frequency_features import (
    calculate_spectral_entropy,
    compute_mfcc,
    mel_filterbank,
    power_spectrum,
)
from .resample import (
    resample_batch_device,
    resample_output_len,
    resample_poly_device,
    resample_to_rate_device,
)
from .pitch import (
    pitch_from_frames,
    pitch_from_frames_amdf,
    pitch_track,
    pitch_track_amdf,
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
    "adaptive_voice_activity_detection",
    "hangover_smooth",
    "hangover_smooth_scan",
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
    "voice_activity_detection",
    "LAUNCHES",
    "ROUTES",
    "fused_view_features",
    "fused_view_pitch",
    "fused_features",
    "fused_streaming_vad",
    "frame_signal",
    "framing",
    "num_frames_for",
    "preemphasis",
    "stream_frames",
    "autocorrelation_via_dft",
    "calculate_average_magnitude_difference",
    "calculate_short_time_autocorrelation",
    "calculate_short_time_energy",
    "calculate_zero_crossing_rate",
    "calculate_spectral_entropy",
    "compute_mfcc",
    "mel_filterbank",
    "power_spectrum",
    "resample_batch_device",
    "resample_output_len",
    "resample_poly_device",
    "resample_to_rate_device",
    "pitch_from_frames",
    "pitch_from_frames_amdf",
    "pitch_track",
    "pitch_track_amdf",
    "pitch_track_gated",
    "pitch_track_signal",
    "pitch_track_signal_gated",
    "FeatureBlock",
    "FeatureConfig",
    "FeaturePipeline",
]
