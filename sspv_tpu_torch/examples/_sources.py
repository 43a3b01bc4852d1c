#!/usr/bin/env python3
"""Shared synthetic AudioSource implementations for the example harnesses.

One definition of the in-memory int16 source contract (``open``/``read``/
``close`` + ``exhausted``, mirroring ``runtime.audio_source.AudioSource``)
and of the speech-like test signal, so the EOF edge and pacing semantics
cannot drift between harnesses. The pacing variants are explicit subclasses
because the harnesses deliberately measure different cadences:

- ``ArraySource``      — flood (as fast as the engine asks); throughput runs
- ``DueTimePacedSource`` — each fixed chunk served at its real-time due
  moment, arrival timestamps recorded; end-to-end latency runs
- ``WallClockPacedSource`` — cumulative samples capped at the wall clock
  (a live microphone's cadence); serving-capacity runs
- ``LoopingPacedSource`` — endless wall-clock-paced loop of one buffer;
  soak runs
"""

from __future__ import annotations

import time

import numpy as np

__all__ = [
    "speech_signal",
    "ArraySource",
    "DueTimePacedSource",
    "WallClockPacedSource",
    "LoopingPacedSource",
]


def speech_signal(
    seconds: float, sample_rate: int, seed: int = 0, tone_hz: float = 150.0
) -> np.ndarray:
    """Alternating 0.5 s voiced (tone at ``tone_hz``, amplitude 9000) and
    quiet-noise segments — loud enough to trip the fixed VAD threshold."""
    n = int(seconds * sample_rate)
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sample_rate
    sig = rng.normal(0, 600, n)
    voiced = ((t * 2).astype(int) % 2) == 1
    sig = np.where(voiced, 9000 * np.sin(2 * np.pi * tone_hz * t), sig)
    return sig.astype(np.int16)


class ArraySource:
    """Finite in-memory int16 source: serves up to ``chunk_samples`` (or the
    requested count when None) per read, as fast as the engine asks."""

    def __init__(self, data, sample_rate: int, chunk_samples: int | None = None):
        self.sample_rate = int(sample_rate)
        self.channels = 1
        self._data = np.asarray(data, dtype=np.int16)
        self._chunk = chunk_samples
        self._pos = 0
        self.exhausted = False

    def open(self) -> None:
        self._pos = 0
        self.exhausted = False

    def _serve(self, end: int) -> np.ndarray:
        chunk = self._data[self._pos:end]
        self._pos = end
        if self._pos >= len(self._data):
            self.exhausted = True
        return chunk

    def read(self, num_frames: int) -> np.ndarray:
        if self._pos >= len(self._data):
            self.exhausted = True
            return np.array([], dtype=np.int16)
        step = self._chunk if self._chunk else int(num_frames)
        return self._serve(min(len(self._data), self._pos + step))

    def close(self) -> None:
        pass


class DueTimePacedSource(ArraySource):
    """Serves fixed-size chunks at their real-time due moment and records
    when each chunk's last sample became available (latency measurement)."""

    def __init__(self, data, sample_rate: int, chunk_samples: int):
        super().__init__(data, sample_rate, chunk_samples=chunk_samples)
        self.chunk_end_times: list[float] = []
        self._t0: float | None = None

    def open(self) -> None:
        super().open()
        self._t0 = time.perf_counter()

    def read(self, num_frames: int) -> np.ndarray:
        if self._pos >= len(self._data):
            self.exhausted = True
            return np.array([], dtype=np.int16)
        end = min(len(self._data), self._pos + self._chunk)
        due = (end / self.sample_rate) + self._t0
        now = time.perf_counter()
        if now < due:
            time.sleep(due - now)
        chunk = self._serve(end)
        self.chunk_end_times.append(time.perf_counter())
        return chunk


class WallClockPacedSource(ArraySource):
    """Caps cumulative served samples at the wall-clock target (a live
    microphone's cadence); returns empty chunks while ahead of real time."""

    def open(self) -> None:
        super().open()
        self._t0 = time.monotonic()

    def read(self, num_frames: int) -> np.ndarray:
        target = int((time.monotonic() - self._t0) * self.sample_rate)
        if self._pos >= min(target, len(self._data)):
            if self._pos >= len(self._data):
                self.exhausted = True
                return np.array([], dtype=np.int16)
            time.sleep(0.004)
            return np.array([], dtype=np.int16)
        step = self._chunk if self._chunk else int(num_frames)
        return self._serve(min(len(self._data), self._pos + step, target))


class LoopingPacedSource:
    """Endless synthetic speech-like source, wall-clock paced, looping one
    buffer (the soak harness: 4-phase quiet/tone/noise/quiet signal)."""

    def __init__(self, sample_rate: int):
        self.sample_rate = int(sample_rate)
        self.channels = 1
        self.exhausted = False
        rng = np.random.default_rng(0)
        n = 10 * sample_rate
        t = np.arange(n) / sample_rate
        seg = (t * 2).astype(int) % 4
        sig = rng.normal(0, 30, n)
        sig = np.where(seg == 1, 7000 * np.sin(2 * np.pi * 150 * t), sig)
        sig = np.where(seg == 2, rng.normal(0, 2000, n), sig)
        self._d = np.clip(sig, -32768, 32767).astype(np.int16)
        self._p = 0
        self._t0: float | None = None

    def open(self) -> None:
        self._p = 0
        self._t0 = time.monotonic()

    def read(self, k: int) -> np.ndarray:
        # pace to real time like a microphone would
        target = int((time.monotonic() - self._t0) * self.sample_rate)
        if self._p >= target:
            time.sleep(k / self.sample_rate / 4)
            return np.array([], np.int16)
        out = np.empty(k, np.int16)
        got = 0
        while got < k:
            take = min(k - got, len(self._d) - self._p % len(self._d))
            s = self._p % len(self._d)
            out[got:got + take] = self._d[s:s + take]
            got += take
            self._p += take
        return out

    def close(self) -> None:
        pass
