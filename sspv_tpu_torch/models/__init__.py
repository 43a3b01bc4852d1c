"""Composable frontend transform models.

Counterpart of ``sspv_tpu/models``: configured, composable transform objects
(in the spirit of torchaudio's transforms), here ``torch.nn.Module``s. Each
maps ``(num_frames, frame_size)`` float32 frames (or a raw 1-D signal for
the ``from_signal`` variants) to feature tensors on its device, with all
constants built on the host at construction and registered as buffers.
"""

from .frontend import (
    FrameTransform,
    Spectrogram,
    MelSpectrogram,
    MFCC,
    SpectralEntropy,
    VADModel,
    SpeechFrontend,
    Pitch,
)

__all__ = [
    "FrameTransform",
    "Spectrogram",
    "MelSpectrogram",
    "MFCC",
    "SpectralEntropy",
    "VADModel",
    "SpeechFrontend",
    "Pitch",
]
