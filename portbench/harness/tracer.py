"""The ``--trace 1`` profiler: ``torch.profiler`` (CPU and CUDA activity)
over a steady part of the measured window.

The driver starts the profiler in set-up (before its threads load the
interpreter, which slows the start-up further), in its warm-up step (its tracer
starts there, which takes some seconds on the card, and what it records is
dropped: a cold trace loses kernels); a quarter into the window it records
one active step of ``TRACE_SECONDS`` (or 40 % of a shorter window). The driver calls
:meth:`Tracer.poll` where a step may start or end: between synchronised
calls in a closed loop, so that the traced calls are whole, or on its main
thread's clock where other threads do the work. ``calls`` gathers the
shapes of the calls the active step saw, for the roofline readers.
"""

from __future__ import annotations

import json
import os
import time
import warnings

import torch

from ..yardstick.trace import read_trace

ACTIVITIES = ("CPU", "CUDA")
TRACE_SECONDS = 3.0


class Tracer:
    def __init__(self, enabled: bool, seconds: float, tmpdir: str):
        self.enabled = enabled
        self.active = False
        self.calls: list[dict] = []
        self._state = "idle"
        self._path = os.path.join(tmpdir, f"portbench_trace_{os.getpid()}.json")
        self._start = 0.25 * seconds
        self._length = min(TRACE_SECONDS, 0.4 * seconds)
        self._t0 = self._active_at = None
        self._prof = None
        # when the profiler stopped recording (``time.monotonic``)
        self.stopped_at = None
        self.notes: dict = {}

    def start(self) -> None:
        """Start the profiler in its warm-up step, at the end of set-up: its
        start-up (CUPTI's, some seconds on the card) stays out of the
        window, and what the warm-up step records is dropped."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [getattr(ProfilerActivity, a) for a in ACTIVITIES
                if a != "CUDA" or torch.cuda.is_available()]
        self._prof = profile(
            activities=acts,
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(self._path))
        t = time.monotonic()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self._prof.start()
        self._state = "warmup"
        self.notes["profiler_start_s"] = time.monotonic() - t

    def begin(self, t0: float) -> None:
        """The window starts at ``t0`` (``time.monotonic``)."""
        self._t0 = t0

    def poll(self, now: float) -> None:
        if self._state == "warmup" and now - self._t0 >= self._start:
            self._prof.step()
            self._state, self.active = "active", True
            self._active_at = time.monotonic()
            self.notes["active_s"] = self._active_at - self._t0
        if self._state == "active" and now - self._active_at >= self._length:
            self._finish()

    def _finish(self) -> None:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if self._state == "active":
                self._prof.step()
            self._prof.stop()
        self._state, self.active = "done", False
        self.stopped_at = time.monotonic()
        self.notes["stopped_s"] = self.stopped_at - self._t0
        self.notes["calls_traced"] = len(self.calls)

    def record(self, call: dict) -> None:
        """The shapes of one call that ran whole inside the active step."""
        if self.active:
            self.calls.append(call)

    def close(self) -> dict | None:
        """Stop a profiler still running; the device figures of the active
        step (``yardstick.trace.read_trace``), or None if there were none."""
        if self._state in ("warmup", "active"):
            self._finish()
        if not os.path.exists(self._path):
            return None
        try:
            with open(self._path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            self.notes["trace_mb"] = os.path.getsize(self._path) / 1e6
            os.remove(self._path)
        self.notes["events"] = len(events)
        return read_trace(events)
