#!/usr/bin/env python3
"""Concurrent-stream serving benchmark: N independent ``AudioRuntime``
engines share one card and ONE ``FeaturePipeline``.

The reference is a single-stream desktop app; a serving deployment instead
runs many live streams against one accelerator. Each engine owns its
device state (packed VAD-state vector) and dispatches its own blocks from
its own thread; the pipeline's constants are shared and read-only, its
kernels count their launches under a lock, and the engines' work queues on
the device's default stream, each block's readback behind its own event.
Flood-paced sources measure the ceiling; ``--paced`` streams run at a live
microphone's cadence.

Usage:
    python -m sspv_tpu_torch.examples.multistream_bench [n_streams]
        [seconds_each] [--paced] [--device cuda]

Prints one JSON line: the aggregate and per-stream real-time factors (or,
paced, the lag and completeness), the dispatches and, in the samples
dispatch, K1's launches beside them, the device and the card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..utils.device import card_line, resolve_device
from ._sources import ArraySource, WallClockPacedSource, speech_signal


def FloodSource(seconds, sample_rate, seed=0, chunk_samples=16000):
    """Serves ``seconds`` of synthetic speech as fast as the engine asks."""
    sig = speech_signal(seconds, sample_rate, seed=seed, tone_hz=120 + 40 * seed)
    return ArraySource(sig, sample_rate, chunk_samples=chunk_samples)


def PacedSource(seconds, sample_rate, seed=0, chunk_samples=16000):
    """FloodSource clocked to real time (a live microphone's cadence)."""
    sig = speech_signal(seconds, sample_rate, seed=seed, tone_hz=120 + 40 * seed)
    return WallClockPacedSource(sig, sample_rate, chunk_samples=chunk_samples)


def _shared_pipeline(device):
    """Config from the environment, the matmul precision pinned for every
    engine thread, one pipeline warmed up by a throwaway engine so the
    timed region measures steady-state serving, not the kernels' build."""
    from ..config import Config
    from ..ops.pipeline import FeatureConfig, FeaturePipeline
    from ..runtime import AudioRuntime

    Config.load_from_env()
    # ops.fp32.full_fp32 writes the process-wide setting, which is not safe
    # against concurrent threads: pinned here, it never writes
    torch.set_float32_matmul_precision("highest")
    sr = Config.SAMPLE_RATE
    frame, hop = Config.FRAME_SIZE, Config.HOP_SIZE
    shared_pipe = FeaturePipeline(FeatureConfig.from_config(Config),
                                  device=device)
    warm = AudioRuntime(audio_source=FloodSource(2.0, sr), pipeline=shared_pipe)
    warm.start()
    t0 = time.time()
    while warm.frames_processed < 1 + (2 * sr - frame) // hop:
        if warm.last_error is not None or time.time() - t0 > 600:
            warm.stop()
            raise RuntimeError(f"warmup failed: {warm.last_error!r}")
        time.sleep(0.05)
    warm.stop()
    return shared_pipe, sr, frame, hop


def _launches(engines, before: dict) -> dict:
    """The timed engines' dispatches and, in the samples dispatch, K1's
    launches beside them."""
    from ..ops import LAUNCHES

    out = {"total_dispatches": sum(rt.dispatch_count for rt in engines)}
    if engines[0]._samples_dispatch:
        out["k1_launches"] = LAUNCHES["view_features"] - before["view_features"]
    return out


def run_paced(n_streams: int, seconds: float, device="cuda"):
    """N live-cadence streams on one card: the serving-capacity demo.

    Success = every stream keeps up with real time (its processed-frame
    count tracks the wall clock); reports per-stream end-to-end lag.
    Returns ``(result, engines)``; raises on a stream error or a timeout.
    """
    from ..ops import LAUNCHES
    from ..runtime import AudioRuntime

    device = resolve_device(device)
    shared_pipe, sr, frame, hop = _shared_pipeline(device)
    sources = [
        PacedSource(seconds, sr, seed=i, chunk_samples=1024)
        for i in range(n_streams)
    ]
    engines = [
        AudioRuntime(audio_source=src, pipeline=shared_pipe)
        for src in sources
    ]
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    for rt in engines:
        rt.start()
    expected = 1 + (int(seconds * sr) - frame) // hop
    # the engine publishes the final in-flight block + carried tail only on
    # stop()-drain, so "kept up" = within a few coalescing intervals of the
    # live edge; exact completeness is checked after the drain below
    drain_slack = int(3.0 * sr / hop)
    worst_lag = 0.0
    try:
        while True:
            now = time.perf_counter() - t0
            due = min(expected, max(0, int((now - 0.5) * sr / hop)))
            lags = [max(0, due - rt.frames_processed) * hop / sr
                    for rt in engines]
            worst_lag = max(worst_lag, max(lags))
            for i, rt in enumerate(engines):
                if rt.last_error is not None:
                    raise RuntimeError(f"stream {i} error: {rt.last_error!r}")
            if all(src.exhausted for src in sources) and all(
                rt.frames_processed >= expected - drain_slack for rt in engines
            ):
                break
            if now > seconds * 3 + 60:
                raise RuntimeError("timeout; frames: "
                                   f"{[rt.frames_processed for rt in engines]}")
            time.sleep(0.25)
        wall = time.perf_counter() - t0
    finally:
        for rt in engines:
            rt.stop()  # drains the in-flight block + tail frames
    complete = all(rt.frames_processed >= expected for rt in engines)
    return {
        "mode": "paced",
        "device": str(device),
        "card": card_line(device),
        "n_streams": n_streams,
        "seconds_each": seconds,
        "wall_s": round(wall, 2),
        "realtime_ok": wall < seconds * 1.2,
        "all_frames_after_drain": complete,
        "worst_observed_lag_s": round(worst_lag, 3),
        **_launches(engines, before),
    }, engines


def run_flood(n_streams: int, seconds: float, device="cuda"):
    """N streams served as fast as the engines ask: the throughput ceiling.
    Returns ``(result, engines)``; raises on a stream error or a timeout."""
    from ..ops import LAUNCHES
    from ..runtime import AudioRuntime

    device = resolve_device(device)
    # ONE shared FeaturePipeline for every stream: it holds no per-stream
    # state (all mutable state lives in each engine's packed VAD-state
    # vector), so N engines reuse the same constants and kernels
    shared_pipe, sr, frame, hop = _shared_pipeline(device)
    expected = 1 + (int(seconds * sr) - frame) // hop

    engines = [
        AudioRuntime(
            audio_source=FloodSource(seconds, sr, seed=i), pipeline=shared_pipe
        )
        for i in range(n_streams)
    ]
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    for rt in engines:
        rt.start()
    done = [False] * n_streams
    finish = [0.0] * n_streams
    deadline = time.time() + max(600.0, 20 * seconds)
    try:
        while not all(done):
            for i, rt in enumerate(engines):
                if not done[i] and rt.frames_processed >= expected:
                    done[i] = True
                    finish[i] = time.perf_counter() - t0
                if rt.last_error is not None:
                    raise RuntimeError(f"stream {i} error: {rt.last_error!r}")
            if time.time() > deadline:
                raise RuntimeError("timeout; frames: "
                                   f"{[rt.frames_processed for rt in engines]}")
            time.sleep(0.005)
    finally:
        for rt in engines:
            rt.stop()
    wall = max(finish)
    agg = n_streams * seconds / wall
    return {
        "device": str(device),
        "card": card_line(device),
        "n_streams": n_streams,
        "seconds_each": seconds,
        "wall_s": round(wall, 3),
        "aggregate_audio_x_realtime": round(agg, 1),
        "per_stream_x_realtime": round(agg / n_streams, 1),
        **_launches(engines, before),
        "per_stream_finish_s": [round(f, 3) for f in finish],
    }, engines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sspv_tpu_torch.examples.multistream_bench")
    ap.add_argument("n_streams", nargs="?", type=int, default=4)
    ap.add_argument("seconds_each", nargs="?", type=float, default=60.0)
    ap.add_argument("--paced", action="store_true",
                    help="live-cadence sources instead of flood")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run = run_paced if args.paced else run_flood
    result, _ = run(args.n_streams, args.seconds_each, args.device)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
