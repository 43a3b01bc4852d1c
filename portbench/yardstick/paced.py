"""A live microphone's cadence: an in-memory int16 source that serves fixed
chunks at their real-time due moments.

Frozen copy of ``sspv_tpu_torch/examples/_sources.py``
(``ArraySource`` + ``DueTimePacedSource``), with the ``AudioSource``
contract of ``sspv_tpu_torch.runtime.audio_source`` (``open``/``read``/
``close``, ``exhausted``, ``sample_rate``, ``channels``). Changed from the
original:

- chunk ``j`` is due at ``t0 + (j + 1) * chunk / sample_rate`` on
  ``time.monotonic``'s clock, where ``t0`` is given (streams share one
  clock and are staggered by their own offsets), not taken at ``open``;
- it stamps each chunk's DUE time (``due``), which the latency metric
  measures from; the original recorded when the chunk was served, after
  any lateness, which hid a stalled source;
- how late it served a chunk is kept apart (``max_late_s``): the lateness
  of the generator, reported beside the metric;
- ``read`` returns an empty chunk once the data runs out; the source ends
  when the harness stops the engine.
"""

from __future__ import annotations

import time

import numpy as np


class DueTimePacedSource:
    def __init__(self, data: np.ndarray, sample_rate: int, chunk: int,
                 t0: float):
        self.sample_rate = int(sample_rate)
        self.channels = 1
        self.exhausted = False
        self._data = np.asarray(data, dtype=np.int16)
        self._chunk = int(chunk)
        self._t0 = float(t0)
        self._pos = 0
        self.max_late_s = 0.0

    def due(self, end_sample: int) -> float:
        """When the chunk that ends at ``end_sample`` is due (its last
        sample exists in real time)."""
        return self._t0 + end_sample / self.sample_rate

    def open(self) -> None:
        self._pos = 0
        self.exhausted = False

    def read(self, num_frames: int) -> np.ndarray:
        if self._pos >= len(self._data):
            self.exhausted = True
            return np.zeros(0, dtype=np.int16)
        end = min(len(self._data), self._pos + self._chunk)
        due = self.due(end)
        now = time.monotonic()
        if now < due:
            time.sleep(due - now)
        else:
            self.max_late_s = max(self.max_late_s, now - due)
        chunk = self._data[self._pos:end]
        self._pos = end
        return chunk

    def close(self) -> None:
        pass
