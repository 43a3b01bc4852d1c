"""Live streams: ``streams`` ``AudioRuntime`` engines sharing one
``FeaturePipeline`` (as ``sspv_tpu_torch/examples/multistream_bench.py``
shares it), each fed by a source paced at real time in chunks of the
configuration's ``chunk_size`` samples, with its own audio.

Traffic parameters: ``streams``; ``warm_s``: seconds the engines run
before the window; ``grace_s``: how long the window's frames are awaited
past it; ``floor_rms``; ``sample``: how many streams are checked (every
frame each published). Each stream is offset from the shared clock by its
own share of one chunk's period (the same set of offsets for every seed,
in the seed's order), as independent microphones are.

Measured on the host's clock (``metrics`` of the window's result):

- ``host_cpu_ms_per_audio_s``: the CPU time (user and system, every thread
  of the process: the engines' threads, the pipeline's, the CUDA driver's)
  spent across the window, less the harness's own threads (the main thread
  and the poller, each by its thread CPU clock), in milliseconds per second
  of live audio the streams delivered in that time (streams times the
  window's seconds on the monotonic clock);
- ``frame_lag_p95_ms``: the 95th percentile over every frame of every
  stream whose last sample was due in the window of the time from that due
  moment (the end of the chunk that holds the sample) to the moment the
  frame's result is in the engine's ``processed_data``. A poller thread
  reads each engine's ``frames_processed`` every millisecond and stamps
  each change; a frame that never arrives counts as infinitely late. In a
  traced run it is taken over the frames due from ``QUIET_S`` after the
  profiler stopped (its recording and its export stall the host loops by
  tenths of a second), over them all where none are.

Counters: the engines' ``frames_processed`` and ``dispatch_count`` across
the window.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..harness import plans
from ..harness.audio import speech
from ..yardstick.paced import DueTimePacedSource
from ..yardstick.stats import percentile

POLL_S = 0.001
QUIET_S = 0.5


class Poller:
    """Stamps every change of each engine's ``frames_processed``."""

    def __init__(self, engines):
        self.engines = engines
        self.stamps = [[(0.0, 0)] for _ in engines]
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _once(self) -> None:
        now = time.monotonic()
        for i, rt in enumerate(self.engines):
            n = rt.frames_processed
            if n != self.stamps[i][-1][1]:
                self.stamps[i].append((now, n))

    def _run(self) -> None:
        while not self._stop.is_set():
            self._once()
            time.sleep(POLL_S)

    def start(self):
        self.thread.start()

    def stop(self):
        """Stop polling, after one last pass: a change since the thread's
        last pass is stamped now, not lost."""
        self._stop.set()
        self.thread.join(timeout=10)
        self._once()

    def arrival(self, i: int, frames: np.ndarray) -> np.ndarray:
        """When each of stream ``i``'s ``frames`` (indices) was first
        published (inf: never)."""
        times = np.array([t for t, _ in self.stamps[i]] + [np.inf])
        counts = np.array([n for _, n in self.stamps[i]])
        return times[np.searchsorted(counts, frames, side="right")]


def _cpu(clocks) -> float:
    """The process's CPU seconds less those of the threads whose CPU
    clocks are ``clocks``."""
    return time.process_time() - sum(time.clock_gettime(c) for c in clocks)


class Driver:
    PITCH = False

    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.n = int(t["streams"])
        self.chunk = int(ctx.config["engine"]["chunk_size"])
        r = plans.rng(ctx.seed)
        sr = ctx.cfg["sample_rate"]
        self.offsets = r.permutation(self.n) / self.n * self.chunk / sr
        self.sample = [int(i) for i in r.permutation(self.n)[: int(t["sample"])]]
        self.engines = []
        self.poller = None

    def inputs(self) -> None:
        """Each stream's audio, made on the device from the seed, on the
        host: the warm-up, the longest window and the grace."""
        ctx = self.ctx
        sr = ctx.cfg["sample_rate"]
        total_s = float(ctx.traffic["warm_s"]) + self.max_seconds()
        self.total = int(total_s * sr) + self.chunk
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(ctx.seed & (2**63 - 1))
        self.audio = speech(self.n * self.total, sr, gen,
                            float(ctx.traffic["floor_rms"])).reshape(
                                self.n, self.total).cpu()

    def checked(self, seconds: float) -> list:
        """``(pcm, frames)`` of what a run of ``seconds`` checks: each
        sampled stream's frames due by the window's end."""
        c = self.ctx.cfg
        end = (float(self.ctx.traffic["warm_s"]) + seconds) * c["sample_rate"]
        n = 1 + (int(end) - c["frame_size"]) // c["hop_size"]
        return [(self.audio[i], n) for i in self.sample]

    def setup(self, tracer) -> None:
        from sspv_tpu_torch.config import Config
        from sspv_tpu_torch.ops.pipeline import FeatureConfig, FeaturePipeline
        from sspv_tpu_torch.runtime import AudioRuntime

        ctx = self.ctx
        c = ctx.cfg
        sr = c["sample_rate"]
        self.inputs()
        # as multistream_bench: one float32 matmul precision for every
        # engine thread, one pipeline, a throwaway engine to warm it
        torch.set_float32_matmul_precision("highest")
        Config.CHUNK_SIZE = self.chunk
        # every frame the run publishes stays readable for the check
        Config.PROCESSED_DATA_BUFFER_SIZE = int(self.total / c["hop_size"]) + 64
        self.pipe = FeaturePipeline(FeatureConfig(**c), device=ctx.device)
        warm = AudioRuntime(audio_source=DueTimePacedSource(
            self.audio[0, : 2 * sr].numpy(), sr, self.chunk, 0.0),
            pipeline=self.pipe)
        warm.set_audio_source(warm.audio_source, auto_stop_on_eof=True)
        warm.start()
        deadline = time.monotonic() + 600
        while warm.is_running and time.monotonic() < deadline:
            time.sleep(0.01)
        warm.stop()
        if warm.last_error is not None:
            raise RuntimeError(f"warm-up engine failed: {warm.last_error!r}")
        # the profiler's start-up, before the streams load the interpreter
        tracer.start()
        self.t_zero = time.monotonic() + 0.2
        self.sources = [DueTimePacedSource(self.audio[i].numpy(), sr,
                                           self.chunk, self.t_zero + off)
                        for i, off in enumerate(self.offsets)]
        self.engines = [AudioRuntime(audio_source=s, pipeline=self.pipe)
                        for s in self.sources]
        self.poller = Poller(self.engines)
        self.poller.start()
        for rt in self.engines:
            rt.start()
        self.w0 = self.t_zero + float(ctx.traffic["warm_s"])
        while time.monotonic() < self.w0:
            time.sleep(0.001)

    def max_seconds(self) -> float:
        """Seconds of audio each stream holds past its warm-up: the longest
        window a run may ask for plus the grace."""
        return float(self.ctx.traffic["max_window_s"]) + float(
            self.ctx.traffic["grace_s"])

    def _due(self, i: int, frames: np.ndarray) -> np.ndarray:
        """When each frame's last sample was due: the end of its chunk."""
        c = self.ctx.cfg
        last = frames * c["hop_size"] + c["frame_size"]
        end = -(-last // self.chunk) * self.chunk
        return self.t_zero + self.offsets[i] + end / c["sample_rate"]

    def window(self, seconds: float, tracer) -> dict:
        if seconds > float(self.ctx.traffic["max_window_s"]):
            raise SystemExit(f"portbench: this mix holds audio for windows "
                             f"of up to {self.ctx.traffic['max_window_s']} s")
        c = self.ctx.cfg
        # the harness's own threads, whose CPU time is not the program's
        clocks = [time.pthread_getcpuclockid(t.ident)
                  for t in (threading.current_thread(), self.poller.thread)]
        f0 = sum(rt.frames_processed for rt in self.engines)
        d0 = sum(rt.dispatch_count for rt in self.engines)
        t0, cpu0 = time.monotonic(), _cpu(clocks)
        w1 = self.w0 + seconds
        while (now := time.monotonic()) < w1:
            tracer.poll(now)
            time.sleep(0.005)
        t1, cpu1 = time.monotonic(), _cpu(clocks)
        tracer.poll(t1)
        f1 = sum(rt.frames_processed for rt in self.engines)
        d1 = sum(rt.dispatch_count for rt in self.engines)
        cpu_ms = 1e3 * (cpu1 - cpu0) / (self.n * (t1 - t0))
        # the frames due in the window, per stream, and their arrival
        n_all = 1 + (self.total - c["frame_size"]) // c["hop_size"]
        idx = np.arange(n_all)
        due = [self._due(i, idx) for i in range(self.n)]
        want = [idx[(d >= self.w0) & (d < w1)] for d in due]
        need = [int(w[-1]) + 1 if len(w) else 0 for w in want]
        deadline = w1 + float(self.ctx.traffic["grace_s"])
        while time.monotonic() < deadline and any(
                rt.frames_processed < k for rt, k in zip(self.engines, need)):
            time.sleep(0.01)
        errors = [rt.last_error for rt in self.engines if rt.last_error]
        self.poller.stop()
        lags = np.concatenate([self.poller.arrival(i, w) - due[i][w]
                               for i, w in enumerate(want)])
        self.last = (np.concatenate([due[i][w] for i, w in enumerate(want)]),
                     lags)
        failed = int(np.isinf(lags).sum())
        timed = lags
        if tracer.stopped_at is not None:
            after = self.last[0] >= tracer.stopped_at + QUIET_S
            timed = lags[after] if after.any() else lags
        p95 = percentile(timed.tolist(), 95)
        if np.isinf(p95):
            p95 = deadline - self.w0
        late = max(s.max_late_s for s in self.sources)
        return {"metrics": {"frame_lag_p95_ms": 1e3 * p95,
                            "host_cpu_ms_per_audio_s": cpu_ms},
                "attempted": int(len(lags)), "failed": failed,
                "counters": {"engine.frames": f1 - f0,
                             "engine.dispatches": d1 - d0},
                "notes": {"frame_lag_p95_ms": 1e3 * p95,
                          "frame_lag_p50_ms": 1e3 * percentile(timed.tolist(), 50),
                          "frames": int(len(lags)),
                          "frames_timed": int(len(timed)),
                          "source_max_late_ms": 1e3 * late,
                          "engine_errors": [repr(e) for e in errors]}}

    def release(self) -> list:
        self.close()
        items = []
        for i in self.sample:
            rt = self.engines[i]
            rows = list(rt.processed_data)
            prog = {
                "energy": np.array([d["energy"] for d in rows]),
                "zcr": np.array([d["zcr"] for d in rows]),
                "entropy": np.array([d["spec_entropy"] for d in rows]),
                "mfcc": np.array([d["mfcc"] for d in rows]),
                "vad": np.array([d["vad"] for d in rows]),
                "vad_adaptive": np.array([d["vad_adaptive"] for d in rows]),
            }
            items.append((self.audio[i], prog, len(rows)))
        self.engines = []
        self.pipe = None
        if torch.device(self.ctx.device).type == "cuda":
            torch.cuda.empty_cache()
        return items

    def close(self) -> None:
        for rt in self.engines:
            rt.is_running = False
        for rt in self.engines:
            rt.stop()
        if self.poller is not None:
            self.poller.stop()
