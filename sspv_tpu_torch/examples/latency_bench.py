#!/usr/bin/env python3
"""End-to-end paced streaming latency of the port's AudioRuntime engine.

Measures, per frame, the wall-clock delay between "the frame's last sample
became available from the (real-time-paced) source" and "the frame's result
appeared in ``processed_data``": the engine-side counterpart of the
reference's published row (35.6 ms processing within a < 50 ms budget,
what the reference claims, not a target of this port).

Usage:
    python -m sspv_tpu_torch.examples.latency_bench [--mode default|ll]
        [--chunk 1024] [--seconds 30] [--warmup 10] [--device cuda]

Prints one JSON line per run with median/p90/max latency in ms, the device
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import threading
import time

import numpy as np

from ..utils.device import card_line, resolve_device, synchronize
from ._sources import DueTimePacedSource, speech_signal


@contextlib.contextmanager
def scoped_config(**knobs):
    """Set ``Config`` knobs for the run and put the earlier values back."""
    from ..config import Config

    before = {k: getattr(Config, k) for k in knobs}
    for k, v in knobs.items():
        setattr(Config, k, v)
    try:
        yield Config
    finally:
        for k, v in before.items():
            setattr(Config, k, v)


def run_once(mode: str, chunk: int, seconds: float, warmup_s: float,
             device="cuda") -> dict:
    from ..runtime import AudioRuntime

    device = resolve_device(device)
    with scoped_config(TPU_LOW_LATENCY=1 if mode == "ll" else 0,
                       # keep every frame observable
                       PROCESSED_DATA_BUFFER_SIZE=10**6) as Config:
        src = DueTimePacedSource(
            speech_signal(seconds, Config.SAMPLE_RATE), Config.SAMPLE_RATE,
            chunk,
        )
        rt = AudioRuntime(audio_source=src, device=device)
    rt.auto_stop_on_eof = True

    # pre-warm the programs the engine will ACTUALLY dispatch (the packed
    # paths, per its samples/frames layout decision) on every bucket, so the
    # kernels' build and each bucket's first call never land inside the
    # paced measurement window
    for b in rt._buckets:
        packed0 = rt.pipeline.initial_packed_state()
        if rt._samples_dispatch:
            blen = (b - 1) * rt.hop_size + rt.frame_size
            rt.pipeline.process_signal_packed(
                np.zeros((blen,), np.int16), packed0, blen
            )
        else:
            rt.pipeline.process_block_packed(
                np.zeros((b, rt.frame_size), np.float32), packed0, b - 1
            )
    synchronize(rt.pipeline.device)

    # publish-time watcher: first-seen wall-clock per frame index
    pub_times: list[float] = []
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            n = len(rt.processed_data)
            now = time.perf_counter()
            while len(pub_times) < n:
                pub_times.append(now)
            time.sleep(0.0005)

    w = threading.Thread(target=watch, daemon=True)
    w.start()
    rt.start()
    deadline = time.time() + seconds + 120
    while rt.is_running and time.time() < deadline:
        time.sleep(0.02)
    rt.stop()
    # let the watcher observe the drain
    time.sleep(0.05)
    n_final = len(rt.processed_data)
    now = time.perf_counter()
    while len(pub_times) < n_final:
        pub_times.append(now)
    stop.set()
    w.join()
    if rt.last_error is not None:
        raise rt.last_error

    frame, hop, sr = rt.frame_size, rt.hop_size, rt.rate
    lat = []
    for i in range(len(pub_times)):
        last_idx = i * hop + frame - 1
        k = last_idx // chunk
        if k >= len(src.chunk_end_times):
            break
        lat.append(pub_times[i] - src.chunk_end_times[k])
    lat = np.array(lat[int(warmup_s * sr / hop):]) * 1000.0
    assert lat.size > 0, "no frames measured after warmup"

    return {
        "metric": "paced_streaming_latency",
        "mode": mode,
        "chunk_samples": chunk,
        "chunk_ms": round(chunk / sr * 1000, 1),
        "frames": int(lat.size),
        "median_ms": round(float(np.median(lat)), 1),
        "p90_ms": round(float(np.percentile(lat, 90)), 1),
        "max_ms": round(float(lat.max()), 1),
        "buckets": list(rt._buckets),
        "frames_published": n_final,
        "frames_expected": 1 + (int(seconds * sr) - frame) // hop,
        "dispatches": rt.dispatch_count,
        "samples_dispatch": rt._samples_dispatch,
        "device": str(device),
        "card": card_line(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sspv_tpu_torch.examples.latency_bench")
    ap.add_argument("--mode", choices=["default", "ll"], default="default")
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--warmup", type=float, default=10.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run_once(args.mode, args.chunk, args.seconds,
                              args.warmup, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
