#!/usr/bin/env python3
"""Probe how per-call overhead amortizes with signal length.

Times features + VAD (``FeaturePipeline.process_signal_device`` on the
uploaded ``(n+1, hop)`` rows view: K1 and one full-length VAD) at several
signal lengths, pipelined: 8 calls queued back to back and ONE readback at
the end, so the host never waits between calls. On a CUDA device each call
is also bracketed by CUDA events, whose median is the device time per
call:

    python -m sspv_tpu_torch.tools.length_probe 3600 14400 [--device cuda]

One JSON line per length, with the host seconds ``synth_signal`` took to
make the audio (the probe's set-up, not timed with the calls; null where
the caller passed the audio in).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..utils.device import card_line, resolve_device, synchronize

REPS = 8


def pipelined(fn, device, reps: int = REPS):
    """``reps`` calls of ``fn`` (returning a scalar tensor) queued back to
    back, one readback of their sum at the end: ``(host seconds per call,
    median CUDA-event ms per call or None)``."""
    cuda = device.type == "cuda"
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)] \
        if cuda else []
    tails = []
    t0 = time.perf_counter()
    for i in range(reps):
        if cuda:
            events[i][0].record()
        tails.append(fn())
        if cuda:
            events[i][1].record()
    float(torch.stack(tails).sum())
    seconds = (time.perf_counter() - t0) / reps
    ms = (float(np.median([a.elapsed_time(b) for a, b in events]))
          if cuda else None)
    return seconds, ms


def make_signal(seconds: float, signal=None):
    """``(synth_signal(seconds), its host seconds)``, or ``(signal, None)``
    where the caller made the same audio already."""
    from ..utils.synth import synth_signal

    if signal is not None:
        return signal, None
    t0 = time.perf_counter()
    signal = synth_signal(seconds)
    return signal, round(time.perf_counter() - t0, 2)


def probe(seconds: float, device, signal=None) -> dict:
    """One length: ``signal`` (default: ``synth_signal(seconds)``, made
    here and its host seconds reported) as the rows view on ``device``."""
    from ..ops.pipeline import FeatureConfig, FeaturePipeline

    device = resolve_device(device)
    pipe = FeaturePipeline(FeatureConfig(), device=device)
    state0 = pipe.initial_state()
    sig_np, synth_s = make_signal(seconds, signal)
    # the shipped dispatch form: the host-formed (n+1, hop) rows view
    rows = pipe.host_rows_view(sig_np)
    sig = torch.from_numpy(rows if rows is not None else sig_np).to(device)
    del sig_np, rows
    synchronize(device)

    def call():
        block, _ = pipe.process_signal_device(sig, state0)
        return block.vad[-1]

    t0 = time.perf_counter()
    int(call())
    first_s = time.perf_counter() - t0
    per_call, ms = pipelined(call, device)
    return {
        "seconds": seconds,
        "frames": int(sig.shape[0] - 1) if sig.dim() == 2 else None,
        "pipelined_time_s": round(per_call, 5),
        "audio_x_realtime": round(seconds / per_call, 1),
        "event_ms_median": ms,
        "first_call_s": round(first_s, 3),
        "synth_s": synth_s,
        "device": str(device),
        "card": card_line(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sspv_tpu_torch.tools.length_probe")
    ap.add_argument("lengths", nargs="*", type=float,
                    help="signal lengths in seconds (default 3600 7200)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for seconds in args.lengths or [3600.0, 7200.0]:
        print(json.dumps(probe(seconds, device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
