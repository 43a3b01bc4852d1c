#!/usr/bin/env python3
"""Audio input sources (host-side I/O layer): the port's copy of
``sspv_tpu/runtime/audio_source.py``, held equal to it by
``tests/test_torch_engine.py``.

Implements the reference's 3-method ``AudioSource`` contract
(``runtime/audio_source.py:32-45``): ``open()``, ``read(n) -> int16 ndarray``
(empty at EOF), ``close()``, with ``sample_rate``/``channels`` attributes and
an ``exhausted`` flag on file-like sources. This layer is deliberately plain
Python — it is I/O, not compute; the pipeline consumes its int16 chunks.

Sources:
- ``PyAudioSource``   — live microphone (lazy ``pyaudio`` import in open()).
- ``FileAudioSource`` — whole-file decode to an in-memory int16 array, then
  chunked reads. Decode ladder: soundfile -> audioread -> stdlib ``wave``
  (the last is an addition over the reference so plain WAV works without
  optional deps). Stereo is downmixed (mean across channels on the
  soundfile/wave path; channel 0 on the audioread path, matching the
  reference's two downmix behaviors, audio_source.py:137-141, 172-175).
  Optional polyphase resampling to a target rate.
- ``PlaylistAudioSource`` — several files presented as one continuous stream;
  exposes ``_paths``/``_index`` which UIs read for progress display.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "SUPPORTED_EXTENSIONS",
    "AudioSource",
    "PyAudioSource",
    "FileAudioSource",
    "PlaylistAudioSource",
]

# case-insensitive extension filter used by playlist/directory scans
SUPPORTED_EXTENSIONS = {
    ".wav", ".flac", ".ogg", ".oga", ".aiff", ".aif", ".mp3", ".m4a", ".aac", ".wma",
}


class AudioSource:
    """Base interface: open / read / close + sample_rate, channels."""

    sample_rate: int
    channels: int

    def open(self) -> None:
        raise NotImplementedError

    def read(self, num_frames: int) -> np.ndarray:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class PyAudioSource(AudioSource):
    """Live microphone via PyAudio; the import happens inside ``open()`` so
    constructing the default runtime never requires the package."""

    def __init__(
        self,
        sample_rate: int,
        channels: int,
        format_const: int,
        frames_per_buffer: int,
    ) -> None:
        self.sample_rate = sample_rate
        self.channels = channels
        self._format = format_const
        self._frames_per_buffer = frames_per_buffer
        self._pa = None
        self._stream = None

    def open(self) -> None:
        import pyaudio  # lazy: only a live-mic session needs it

        self._pa = pyaudio.PyAudio()
        self._stream = self._pa.open(
            format=self._format,
            channels=self.channels,
            rate=self.sample_rate,
            input=True,
            frames_per_buffer=self._frames_per_buffer,
        )

    def read(self, num_frames: int) -> np.ndarray:
        if self._stream is None:
            raise RuntimeError("PyAudioSource not opened")
        raw = self._stream.read(num_frames, exception_on_overflow=False)
        return np.frombuffer(raw, dtype=np.int16)

    def close(self) -> None:
        try:
            if self._stream is not None:
                self._stream.stop_stream()
                self._stream.close()
        finally:
            if self._pa is not None:
                self._pa.terminate()
            self._stream = None
            self._pa = None


def _decode_soundfile(path: str) -> tuple[np.ndarray, int]:
    import soundfile as sf

    data, sr = sf.read(path, dtype="int16", always_2d=False)
    arr = np.asarray(data, dtype=np.int16)
    if arr.ndim == 2 and arr.shape[1] > 1:
        arr = arr.mean(axis=1).astype(np.int16)
    return arr, int(sr)


def _decode_audioread(path: str) -> tuple[np.ndarray, int]:
    import audioread

    buffers: list[np.ndarray] = []
    with audioread.audio_open(path) as fh:
        sr = int(getattr(fh, "samplerate", 0) or 0)
        ch = int(getattr(fh, "channels", 1) or 1)
        for buf in fh:
            buffers.append(np.frombuffer(buf, dtype=np.int16))
    if not buffers:
        return np.array([], dtype=np.int16), sr
    arr = np.concatenate(buffers)
    if ch > 1:
        arr = arr.reshape(-1, ch)[:, 0]  # interleaved LRLR...: take channel 0
    return arr, sr


def _decode_wave_stdlib(path: str) -> tuple[np.ndarray, int]:
    """Fallback WAV decoder using only the standard library (16-bit PCM)."""
    import wave

    with wave.open(path, "rb") as wf:
        sr = wf.getframerate()
        ch = wf.getnchannels()
        width = wf.getsampwidth()
        raw = wf.readframes(wf.getnframes())
    if width == 2:
        arr = np.frombuffer(raw, dtype=np.int16)
    elif width == 1:
        arr = ((np.frombuffer(raw, dtype=np.uint8).astype(np.int16) - 128) << 8)
    elif width == 4:
        arr = (np.frombuffer(raw, dtype=np.int32) >> 16).astype(np.int16)
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    if ch > 1:
        arr = arr.reshape(-1, ch).mean(axis=1).astype(np.int16)
    return arr, int(sr)


class FileAudioSource(AudioSource):
    """Whole-file decode into memory, then chunked ``read`` with an
    ``exhausted`` EOF flag. ``sample_rate`` is exposed pre-open when a target
    rate is given (so a runtime constructed around it sees a valid rate)."""

    def __init__(self, file_path: str, sample_rate: Optional[int] = None) -> None:
        self._file_path = file_path
        self._target_sr = sample_rate
        self.sample_rate = int(sample_rate or 0)
        self.channels = 1
        self._pcm: Optional[np.ndarray] = None
        self._pos = 0
        self.exhausted: bool = False

    def open(self) -> None:
        self.exhausted = False
        arr: Optional[np.ndarray] = None
        sr = 0
        errors = []
        for decoder in (_decode_soundfile, _decode_audioread, _decode_wave_stdlib):
            try:
                arr, sr = decoder(self._file_path)
                break
            except Exception as e:  # try the next decoder in the ladder
                errors.append(f"{decoder.__name__}: {type(e).__name__}: {e}")
                arr = None
        if arr is None:
            raise RuntimeError(
                f"could not decode {self._file_path!r}: " + "; ".join(errors)
            )
        self.sample_rate = sr or int(self._target_sr or 0)
        if self._target_sr:
            if arr.size and int(self._target_sr) != self.sample_rate:
                arr = _resample_to(arr, self.sample_rate, int(self._target_sr))
            # a requested target rate always wins (reference sets it
            # unconditionally, audio_source.py:145-147) — even for an empty
            # file, so the engine's post-open rate refresh can't flip the
            # runtime to the file's native rate
            self.sample_rate = int(self._target_sr)
        self._pcm = arr
        self._pos = 0

    def read(self, num_frames: int) -> np.ndarray:
        if self._pcm is None:
            return np.array([], dtype=np.int16)
        start = self._pos
        end = min(start + int(num_frames), len(self._pcm))
        self._pos = end
        if end >= len(self._pcm):
            self.exhausted = True
        return self._pcm[start:end].astype(np.int16, copy=False)

    def close(self) -> None:
        self._pcm = None
        self._pos = 0
        self.exhausted = True


class PlaylistAudioSource(AudioSource):
    """Sequential multi-file source presenting one continuous int16 stream:
    when the current file runs dry it is closed and the next opened."""

    def __init__(self, file_paths: Sequence[str], sample_rate: Optional[int] = None) -> None:
        self._paths = list(file_paths)
        self._target_sr = sample_rate
        self._current: Optional[FileAudioSource] = None
        self._index = 0
        self.sample_rate = int(sample_rate or 0)
        self.channels = 1
        self.exhausted: bool = False

    def open(self) -> None:
        self._index = 0
        self.exhausted = False
        self._open_current()

    def _open_current(self) -> None:
        if self._index >= len(self._paths):
            self._current = None
            self.exhausted = True
            return
        src = FileAudioSource(self._paths[self._index], sample_rate=self._target_sr)
        src.open()
        if self._target_sr is None and src.sample_rate:
            # Lock the whole playlist to the first file's native rate: the
            # engine reads the source rate once before its capture loop, so
            # a mid-playlist rate change would silently corrupt frame timing.
            # Later files resample to match instead.
            self._target_sr = int(src.sample_rate)
        self.sample_rate = int(src.sample_rate or (self._target_sr or 0))
        self._current = src

    def read(self, num_frames: int) -> np.ndarray:
        if self._current is None:
            self.exhausted = True
            return np.array([], dtype=np.int16)
        chunk = self._current.read(num_frames)
        # loop (not a single retry): a zero-sample file mid-playlist must be
        # skipped entirely, or an empty chunk with exhausted=False leaks to
        # consumers relying on the "empty read means EOF" contract
        while chunk.size == 0:
            self._current.close()
            self._index += 1
            self._open_current()
            if self._current is None:
                return np.array([], dtype=np.int16)
            chunk = self._current.read(num_frames)
        return chunk

    def close(self) -> None:
        if self._current is not None:
            self._current.close()
        self._current = None
        self._index = 0
        self.exhausted = True


def _resample_to(arr: np.ndarray, src_sr: int, dst_sr: int,
                 device=None) -> np.ndarray:
    """Polyphase resample to ``dst_sr``, clipped back to int16.

    With ``Config.TPU_DEVICE_RESAMPLE`` set, whole-file-sized arrays (at
    least ``TPU_DEVICE_RESAMPLE_MIN_SECONDS`` of audio) run on ``device``
    (``ops/resample.py``, SciPy parity; ``None``: the resampler's default,
    the card); anything shorter takes the host
    SciPy path, so per-chunk callers never pay a round trip to the device.
    A failure of the device call raises: nothing falls back to the host.
    """
    if src_sr == dst_sr:
        return arr.astype(np.int16, copy=False)
    from ..config import Config

    if bool(Config.TPU_DEVICE_RESAMPLE) and arr.size >= int(
        float(Config.TPU_DEVICE_RESAMPLE_MIN_SECONDS) * src_sr
    ):
        from ..ops.resample import resample_to_rate_device

        on = {} if device is None else {"device": device}
        return resample_to_rate_device(arr, int(src_sr), int(dst_sr), **on)
    import scipy.signal as sps

    g = math.gcd(int(src_sr), int(dst_sr))
    y = sps.resample_poly(arr.astype(np.float32), up=dst_sr // g, down=src_sr // g)
    return np.clip(y, -32768.0, 32767.0).astype(np.int16)
