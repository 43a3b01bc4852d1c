#!/usr/bin/env python3
"""Stability soak: run the port's streaming engine continuously and watch
for drift — frame-rate stalls, memory growth, dropped errors.

The reference claims 24 h continuous operation with no crashes or leaks
but ships no tooling to demonstrate it; this harness is that tooling. A
looping synthetic source streams at real time; every 5 s the log gets one
line

    t=  5.0s rss=  812.3MB calls=77 recent_frames=100 voiced=31 cuda_mb=   11.2MB err=None

with the process's resident memory, the engine's device dispatches
(``dispatch_count``) and, on a CUDA device, the card's allocated memory
(``torch.cuda.memory_allocated``): a leak per device call that stays on the
card never shows in host RSS. ``python -m sspv_tpu_torch.tools.soak_report``
turns a log into slopes per second and per call.

    python -m sspv_tpu_torch.examples.soak [seconds] [--device cuda]

``seconds`` defaults to 60. Empty output counts as a failure only after
``SOAK_GRACE_SECONDS`` (default 600).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..utils.device import card_line, resolve_device
from ._sources import LoopingPacedSource


def rss_mb() -> float:
    with open(f"/proc/{os.getpid()}/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sspv_tpu_torch.examples.soak")
    ap.add_argument("seconds", nargs="?", type=float, default=60.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    grace = float(os.environ.get("SOAK_GRACE_SECONDS", "600"))
    device = resolve_device(args.device)
    from ..config import Config
    from ..runtime import AudioRuntime

    Config.load_from_env()  # honor RTP_* overrides
    print(f"soak on {device} ({card_line(device)}) for {args.seconds:g} s",
          flush=True)
    rt = AudioRuntime(audio_source=LoopingPacedSource(Config.SAMPLE_RATE),
                      device=device)
    rt.start()
    t0 = time.time()
    ok = True
    produced = 0
    try:
        while time.time() - t0 < args.seconds:
            time.sleep(5.0)
            elapsed = time.time() - t0
            e, _, v = rt.get_recent_processed()
            produced = max(produced, e.size)
            cuda = (f"cuda_mb={torch.cuda.memory_allocated(device) / 2**20:9.1f}MB "
                    if device.type == "cuda" else "")
            print(
                f"t={elapsed:6.1f}s rss={rss_mb():7.1f}MB "
                f"calls={rt.dispatch_count} "
                f"recent_frames={e.size} voiced={int(v.sum()) if v.size else 0} "
                f"{cuda}err={rt.last_error}",
                flush=True,
            )
            if rt.last_error is not None:
                ok = False
                break
            # empty output is a failure only after the warm-up grace
            if elapsed > grace and produced == 0:
                ok = False
                break
    finally:
        rt.stop()
    ok = ok and rt.last_error is None and produced > 0
    print("soak:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
