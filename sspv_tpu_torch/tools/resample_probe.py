#!/usr/bin/env python3
"""Host SciPy against on-device polyphase resampling, by signal length.

A file at another rate than 16 kHz pays a SciPy FIR pass on the host
(``runtime/audio_source.py`` ``_resample_to``) before its samples reach
the card, unless ``TPU_DEVICE_RESAMPLE`` sends it to
``ops/resample.resample_poly_device`` (one strided correlation, unfold +
matmul). This probe measures both at each length and rate pair:

    python -m sspv_tpu_torch.tools.resample_probe [seconds ...] [--device cuda]

(default 60 600). One JSON line per length and rate pair: the host and
device seconds per call, the device's first call (nothing compiles; it
uploads the filter), the device timed with ``length_probe``'s method (8
calls queued back to back, one readback, the median CUDA-event time per
call), the largest int16 difference from SciPy in LSB (the port's gate is
1), and ``resample.CALLS``, the device calls the line made.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from ..utils.device import card_line, resolve_device, synchronize
from .length_probe import REPS, pipelined

RATE_PAIRS = [(44100, 16000), (22050, 16000), (8000, 16000), (48000, 16000)]


def probe(seconds: float, src: int, dst: int, device, seed: int = 0) -> dict:
    """One length and rate pair on ``device``: int16 noise from ``seed``."""
    import scipy.signal as sps

    from ..ops import resample

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 5000, int(seconds * src)).clip(-32768, 32767) \
        .astype(np.int16)
    g = math.gcd(src, dst)
    up, down = dst // g, src // g

    t0 = time.perf_counter()
    y_host = sps.resample_poly(x.astype(np.float32), up, down)
    host_s = time.perf_counter() - t0

    calls0 = resample.CALLS["resample"]
    xd = torch.from_numpy(x).to(device)
    synchronize(device)
    t0 = time.perf_counter()
    y_dev = resample.resample_poly_device(xd, up, down).cpu().numpy()
    first_s = time.perf_counter() - t0
    dev_s, ms = pipelined(
        lambda: resample.resample_poly_device(xd, up, down)[-1], device, REPS)

    yh = np.clip(y_host, -32768, 32767).astype(np.int16)
    yd = np.clip(y_dev, -32768, 32767).astype(np.int16)
    lsb = int(np.abs(yd.astype(np.int32) - yh.astype(np.int32)).max())
    return {
        "seconds": seconds, "src_sr": src, "dst_sr": dst,
        "host_s": round(host_s, 6), "device_s": round(dev_s, 6),
        "event_ms_median": ms,
        "device_first_call_s": round(first_s, 4),
        "host_audio_s_per_s": round(seconds / host_s, 1),
        "device_audio_s_per_s": round(seconds / dev_s, 1),
        "speedup": round(host_s / dev_s, 2),
        "max_int16_lsb_diff": lsb,
        "resample_calls": resample.CALLS["resample"] - calls0,
        "device": str(device), "card": card_line(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sspv_tpu_torch.tools.resample_probe")
    ap.add_argument("lengths", nargs="*", type=float,
                    help="signal lengths in seconds (default 60 600)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for seconds in args.lengths or [60.0, 600.0]:
        for src, dst in RATE_PAIRS:
            print(json.dumps(probe(seconds, src, dst, device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
