"""Profiling helpers.

Counterpart of ``sspv_tpu/utils/profiling.py``: a wall-clock
``RealTimeFactor`` timer and a ``torch.profiler`` trace context in place of
the JAX one; and the program's spans (:func:`span`), which the JAX package
has no counterpart of.

A span marks one step of the program on the host, from entry to return. It
records only while a ``torch.profiler`` profile is recording (its active
step): then it is a ``user_annotation`` on the profiler's timeline, beside
the device's kernels, and also one record in an in-memory store that sees
every thread, whichever threads the profiler follows.
Otherwise it costs one read of the profiler's flag. Every span of the
program is named ``sspv.<layer>.<step>``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

from torch.autograd import _record_function_with_args_enter as _annotate
from torch.autograd import _record_function_with_args_exit as _annotated
from torch.autograd import profiler as _autograd_profiler

__all__ = ["RealTimeFactor", "SpanRecord", "clear_spans", "device_trace",
           "span", "span_totals", "spans"]

# the store's bound: records past it are dropped and counted
MAX_SPANS = 1 << 18


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


class SpanRecord(NamedTuple):
    """One span: ``index`` (drawn when it was entered), ``name``, the
    thread's id, ``start_ns``/``end_ns`` on ``time.monotonic_ns``, the
    index of the span around it on its thread (None at the root) and its
    request id."""

    index: int
    name: str
    thread: int
    start_ns: int
    end_ns: int
    parent: int | None
    req: int | None


_OFF = contextlib.nullcontext()
_ids = itertools.count()
_local = threading.local()
_lock = threading.Lock()
# plain tuples of ints, a str and None: the collector stops tracking them,
# so a full store adds nothing to a full collection, which stalls every
# thread (a NamedTuple stays tracked)
_records: list[tuple] = []
_dropped = 0


class _Span:
    # The annotation is the event ``torch.profiler.record_function`` makes,
    # entered through torch.autograd's binding, which skips the operator
    # dispatch: a third of the cost, and nine engine threads recording
    # spans under a profiler keep up with their audio, which through
    # ``record_function`` they did not.
    __slots__ = ("name", "req", "index", "parent", "start", "handle")

    def __init__(self, name: str, req):
        self.name, self.req = name, req

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.index = next(_ids)
        outer = stack[-1] if stack else None
        self.parent = outer.index if outer else None
        if self.req is None:
            self.req = outer.req if outer else self.index
        self.handle = _annotate(self.name)
        stack.append(self)
        self.start = time.monotonic_ns()
        return self.req

    def __exit__(self, *exc):
        global _dropped
        try:
            _annotated(self.handle)
        finally:
            end = time.monotonic_ns()
            _local.stack.pop()
            with _lock:
                if len(_records) < MAX_SPANS:
                    _records.append((self.index, self.name,
                                     threading.get_ident(), self.start, end,
                                     self.parent, self.req))
                else:
                    _dropped += 1
        return False


def span(name: str, req: int | None = None):
    """A context manager marking one step of the program, from entry to
    return. While no ``torch.profiler`` profile is recording it is a shared
    no-op (one read of the profiler's flag). While one is: a
    ``user_annotation`` named ``name``, as ``record_function(name)`` makes,
    and on exit one :class:`SpanRecord` in the store. Its value is the span's request id:
    ``req`` if given, else that of the span around it on its thread, else
    its own index (None while nothing records). A caller that follows one
    piece of work across threads or calls passes the id it got."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, req)


def spans() -> tuple[list[SpanRecord], int]:
    """The stored records, in the order their spans ended, and how many
    were dropped past ``MAX_SPANS``."""
    with _lock:
        records, dropped = list(_records), _dropped
    return [SpanRecord(*r) for r in records], dropped


def span_totals() -> dict:
    """Per span name: ``count``, ``seconds`` (the sum of the spans'
    durations) and ``self_seconds`` (less the time of the stored spans
    directly inside them)."""
    records, _ = spans()
    inner: dict[int, int] = {}
    for r in records:
        if r.parent is not None:
            inner[r.parent] = inner.get(r.parent, 0) + r.end_ns - r.start_ns
    out: dict[str, dict] = {}
    for r in records:
        t = out.setdefault(r.name, {"count": 0, "seconds": 0.0,
                                    "self_seconds": 0.0})
        ns = r.end_ns - r.start_ns
        t["count"] += 1
        t["seconds"] += ns / 1e9
        t["self_seconds"] += (ns - inner.get(r.index, 0)) / 1e9
    return out


def clear_spans() -> None:
    """Empty the store and its count of dropped records."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0
