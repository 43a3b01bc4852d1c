#!/usr/bin/env python3
"""Backend-agnostic visualization state.

The reference couples its plotting state to pyqtgraph (visualization.py);
here the poll/auto-range logic is a plain-Python core shared by the Qt and
headless backends, so it is unit-testable without a display.

- ``RuntimeContract``: the 6-method duck-typed surface the UI needs from a
  runtime (visualization.py:20-26) — documented, not enforced.
- ``PlotModel``: one poll() pulls waveform + (energy, zcr, vad) series from
  the runtime (via ``get_recent_audio``/``get_recent_processed``) and updates
  per-plot auto-ranges from a bounded min/max history, mirroring the
  reference's 10-sample range tracker with per-type margin policies
  (visualization.py:99-242).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

__all__ = ["RangeTracker", "PlotModel", "PLOT_KINDS"]

PLOT_KINDS = ("waveform", "energy", "zcr", "vad")

# initial fixed ranges per plot kind (reference visualization.py:285-311)
_INITIAL_RANGES = {
    "waveform": (-32768.0, 32768.0),
    "energy": (0.0, 1e10),
    "zcr": (0.0, 0.5),
    "vad": (-0.1, 1.1),
}


@dataclass
class RangeTracker:
    """Auto-range from a bounded history of per-update min/max samples."""

    kind: str
    history: deque = field(default_factory=lambda: deque(maxlen=10))

    def update(self, data: np.ndarray) -> tuple[float, float]:
        if data.size == 0:
            return _INITIAL_RANGES[self.kind]
        lo, hi = float(np.min(data)), float(np.max(data))
        self.history.append((lo, hi))
        lo = min(h[0] for h in self.history)
        hi = max(h[1] for h in self.history)
        if self.kind == "vad":
            return (-0.1, 1.1)  # binary plot keeps a fixed frame
        if self.kind == "waveform":
            # symmetric around zero with 10% headroom, floor to avoid a
            # zero-height window on silence
            amp = max(abs(lo), abs(hi), 1.0) * 1.1
            return (-amp, amp)
        if self.kind == "zcr":
            return (0.0, min(max(hi * 1.2, 0.05), 1.0))
        # energy: zero-floored with headroom
        return (0.0, max(hi * 1.2, 1e-6))


class PlotModel:
    """Polls a runtime and maintains the four display series + ranges."""

    def __init__(self, runtime):
        self.runtime = runtime
        self.trackers = {k: RangeTracker(k) for k in PLOT_KINDS}
        self.waveform = np.array([], dtype=np.int16)
        self.energies = np.array([])
        self.zcrs = np.array([])
        self.vads = np.array([])
        # optional real-time F0 series (engines with TPU_ENGINE_PITCH on);
        # empty on runtimes without a pitch track — backends render it only
        # when data is present, so the reference's 4-plot layout is the
        # default and pitch is an additive fifth panel
        self.f0 = np.array([])
        self.ranges = dict(_INITIAL_RANGES)
        self._auto_range = True

    @property
    def auto_range(self) -> bool:
        return self._auto_range

    @auto_range.setter
    def auto_range(self, value) -> None:
        """Re-enabling clears the min/max history: extrema recorded before
        (or while) auto-range was off must not frame the new data
        (reference clears on re-enable, visualization.py:244-259)."""
        value = bool(value)
        if value and not self._auto_range:
            for t in self.trackers.values():
                t.history.clear()
        self._auto_range = value

    def poll(self) -> None:
        self.waveform = self.runtime.get_recent_audio()
        # one aligned snapshot when the runtime offers it (AudioRuntime):
        # separate accessor calls can straddle a live block append and
        # shift the F0 panel against the feature panels
        get_display = getattr(self.runtime, "get_recent_display", None)
        if get_display is not None:
            self.energies, self.zcrs, self.vads, self.f0 = get_display()
        else:
            self.energies, self.zcrs, self.vads = (
                self.runtime.get_recent_processed()
            )
        if self.auto_range:
            self.ranges = {
                "waveform": self.trackers["waveform"].update(self.waveform),
                "energy": self.trackers["energy"].update(self.energies),
                "zcr": self.trackers["zcr"].update(self.zcrs),
                "vad": self.trackers["vad"].update(self.vads),
            }

    def summary(self) -> str:
        """Status line matching the reference's running summary label
        (visualization.py:585-593)."""
        if self.energies.size == 0:
            return "no data"
        voiced_pct = float(np.mean(self.vads == 1)) * 100 if self.vads.size else 0.0
        line = (
            f"frames={self.energies.size} "
            f"mean_energy={float(np.mean(self.energies)):.3e} "
            f"mean_zcr={float(np.mean(self.zcrs)):.3f} "
            f"voiced={voiced_pct:.1f}%"
        )
        voiced_f0 = self.f0[self.f0 > 0]
        if voiced_f0.size:
            line += f" f0={float(np.median(voiced_f0)):.1f}Hz"
        return line

    def progress(self) -> str:
        """Playlist progress (reads _paths/_index like the reference,
        visualization.py:523-528)."""
        src = getattr(self.runtime, "audio_source", None)
        paths = getattr(src, "_paths", None)
        if not paths:
            return ""
        if bool(getattr(src, "exhausted", False)):
            # close() resets _index to 0; a finished playlist must read
            # "file N/N", not "file 1/N"
            return f"file {len(paths)}/{len(paths)}"
        idx = min(int(getattr(src, "_index", 0)) + 1, len(paths))
        return f"file {idx}/{len(paths)}"
