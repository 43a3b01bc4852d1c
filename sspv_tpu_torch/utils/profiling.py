"""Profiling helpers.

Counterpart of ``sspv_tpu/utils/profiling.py``: a wall-clock
``RealTimeFactor`` timer and a ``torch.profiler`` trace context in place of
the JAX one.
"""

from __future__ import annotations

import contextlib
import os
import time

__all__ = ["RealTimeFactor", "device_trace"]


class RealTimeFactor:
    """Measure wall time against audio duration.

    >>> rtf = RealTimeFactor(audio_seconds=2.0)
    >>> with rtf:
    ...     process()
    >>> rtf.factor   # processing_time / duration  (lower is better)
    >>> rtf.speedup  # duration / processing_time  (x real-time)

    Work queued on a CUDA stream is asynchronous: call
    ``torch.cuda.synchronize()`` inside the block before it ends.
    """

    def __init__(self, audio_seconds: float):
        self.audio_seconds = float(audio_seconds)
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False

    @property
    def factor(self) -> float:
        if self.audio_seconds:
            return self.elapsed / self.audio_seconds
        # zero audio with nonzero wall time is infinitely slow per audio
        # second, not 0 (the best possible reading)
        return float("inf") if self.elapsed else 0.0

    @property
    def speedup(self) -> float:
        if self.elapsed:
            return self.audio_seconds / self.elapsed
        # an unmeasurably fast run is inf x real-time, not 0 x
        return float("inf") if self.audio_seconds else 0.0


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block (host ops,
    and the CUDA kernels when a card is present) and write it as
    ``trace.json`` (Chrome trace format, viewable in Perfetto) into
    ``log_dir``. Yields the profiler, whose ``key_averages()`` is readable
    after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
