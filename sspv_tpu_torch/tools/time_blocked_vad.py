#!/usr/bin/env python3
"""Time features + VAD with ``vad_trailing_impl="blocked"`` against
``"conv"``, and count where the two decide apart over the whole signal.

The port's two trailing-sum forms (``ops/vad.py``): ``"conv"`` is the
direct sum of each 256-frame window (``unfold`` then ``sum``, no
convolution), ``"blocked"`` the two-level block cumsums
(``_blocked_trailing_sums``). Each runs in
``FeaturePipeline.process_signal_device`` on the uploaded ``(n+1, hop)``
rows view: K1 and one full-length VAD. Timed with ``length_probe``'s
method (calls queued back to back, one readback, the median CUDA-event
time per call beside the host clock):

    python -m sspv_tpu_torch.tools.time_blocked_vad [seconds] [--device cuda]

One JSON line per form (default 3,600 s), then one with the number of
frames whose decision differs. Both forms sum in float64, so expect 0; the
gate is the original's, at most 3.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..utils.device import card_line, resolve_device, synchronize
from .length_probe import make_signal, pipelined

IMPLS = ("conv", "blocked")
REPS = 6
MAX_MISMATCHES = 3


def run(seconds: float, device, signal=None) -> tuple[list[dict], dict]:
    """Both forms on ``signal`` (default ``synth_signal(seconds)``):
    ``(the JSON lines, {impl: the VAD decisions as a NumPy array})``."""
    from ..ops.pipeline import FeatureConfig, FeaturePipeline

    device = resolve_device(device)
    card = card_line(device)
    sig_np, _ = make_signal(seconds, signal)
    pipes = {impl: FeaturePipeline(FeatureConfig(vad_trailing_impl=impl),
                                   device=device) for impl in IMPLS}
    rows = torch.from_numpy(pipes["conv"].host_rows_view(sig_np)).to(device)
    del sig_np
    synchronize(device)
    lines, vads = [], {}
    for impl, pipe in pipes.items():
        state0 = pipe.initial_state()
        block, _ = pipe.process_signal_device(rows, state0)
        vads[impl] = block.vad.cpu().numpy()

        def call():
            return pipe.process_signal_device(rows, state0)[0].vad[-1]

        per, ms = pipelined(call, device, REPS)
        lines.append({"variant": f"full_vad_{impl}", "time_s": round(per, 6),
                      "audio_x_realtime": round(seconds / per, 1),
                      "event_ms_median": ms, "device": str(device),
                      "card": card})
    mismatches = int(np.sum(vads["conv"] != vads["blocked"]))
    lines.append({"decision_mismatches": mismatches,
                  "frames": int(vads["conv"].size),
                  "voiced": int(vads["conv"].sum()),
                  "device": str(device), "card": card})
    return lines, vads


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sspv_tpu_torch.tools.time_blocked_vad")
    ap.add_argument("seconds", nargs="?", type=float, default=3600.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    lines, _ = run(args.seconds, args.device)
    for line in lines:
        print(json.dumps(line), flush=True)
    mismatches = lines[-1]["decision_mismatches"]
    if mismatches > MAX_MISMATCHES:
        raise SystemExit(f"{mismatches} decision mismatches: more than "
                         f"{MAX_MISMATCHES} threshold ties")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
