#!/usr/bin/env python3
"""Probe pitch-track throughput vs dispatch length.

Times ``pitch_track_signal`` (K2 over the rows view of the signal) at
several lengths with the same methodology as ``length_probe``: 8 calls
pipelined with one readback at the end, the median CUDA-event time per
call, and the best of 3 calls each waited for alone:

    python -m sspv_tpu_torch.tools.pitch_probe 3600 14400 [--device cuda]

One JSON line per length. The VAD gate is all-ones: gating is a final
elementwise ``where`` over the outputs, so the timed compute is that of a
real gate while the probe stays independent of the feature pipeline.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..utils.device import card_line, resolve_device, synchronize
from .length_probe import make_signal, pipelined


def probe(seconds: float, device, signal=None) -> dict:
    """One length: ``signal`` (default: ``synth_signal(seconds)``) on
    ``device``, gated by an all-ones VAD."""
    from ..ops import pitch_track_signal

    device = resolve_device(device)
    sr = 16000
    sig_np, synth_s = make_signal(seconds, signal)
    sig = torch.from_numpy(sig_np).to(device)
    del sig_np
    n = 1 + (int(seconds * sr) - 320) // 160
    vad = torch.ones((n,), dtype=torch.int32, device=device)
    synchronize(device)

    def call():
        f0, conf = pitch_track_signal(sig, vad, min_confidence=0.3)
        return f0[-1] + conf[-1]

    t0 = time.perf_counter()
    float(call())
    first_s = time.perf_counter() - t0
    per_call, ms = pipelined(call, device)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        float(call())
        times.append(time.perf_counter() - t0)
    serialized = min(times)
    best = min(per_call, serialized)
    return {
        "seconds_per_call": seconds,
        "frames": n,
        "pipelined_time_s": round(per_call, 5),
        "serialized_time_s": round(serialized, 5),
        "audio_s_per_s": round(seconds / best, 1),
        "event_ms_median": ms,
        "first_call_s": round(first_s, 3),
        "synth_s": synth_s,
        "device": str(device),
        "card": card_line(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sspv_tpu_torch.tools.pitch_probe")
    ap.add_argument("lengths", nargs="*", type=float,
                    help="signal lengths in seconds (default 3600 14400)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for seconds in args.lengths or [3600.0, 14400.0]:
        print(json.dumps(probe(seconds, device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
