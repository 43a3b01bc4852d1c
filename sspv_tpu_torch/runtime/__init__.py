"""The port's streaming runtime: ``AudioRuntime`` and its audio sources."""

from .audio_source import (
    SUPPORTED_EXTENSIONS,
    AudioSource,
    FileAudioSource,
    PlaylistAudioSource,
    PyAudioSource,
)
from .engine import AudioRuntime

__all__ = [
    "SUPPORTED_EXTENSIONS",
    "AudioRuntime",
    "AudioSource",
    "FileAudioSource",
    "PlaylistAudioSource",
    "PyAudioSource",
]
