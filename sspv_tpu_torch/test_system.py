#!/usr/bin/env python3
"""Standalone assert-based self-check (no pytest needed): the port's copy of
``sspv_tpu/test_system.py``.

Windows, energy, ZCR against theory, the normalized ACF, the VAD truth
table and the framing count formula through the ``SignalProcessing``
facade, and one fused-pipeline run. Run directly:

    python -m sspv_tpu_torch.test_system [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np

from .config import Config
from .signal_processing import SignalProcessing, on_device


def run_self_test(device="cuda") -> bool:
    """The checks, with the facade on ``SignalProcessing.device`` and the
    fused pipeline on ``device`` (``main`` sets both from ``--device``)."""
    ok = True

    def check(name, cond):
        nonlocal ok
        status = "PASS" if cond else "FAIL"
        print(f"[{status}] {name}")
        ok = ok and bool(cond)

    n = Config.FRAME_SIZE
    w = SignalProcessing.hamming_window(n)
    check("hamming window length", len(w) == n)
    check("hamming peak ~ 1", abs(float(np.max(w)) - 1.0) < 1e-4)
    check("rectangular all ones", np.all(SignalProcessing.rectangular_window(n) == 1))

    noise = np.random.randn(n) * 1000
    check("energy positive on noise", SignalProcessing.calculate_short_time_energy(noise) > 0)
    check("energy zero on silence",
          np.isclose(SignalProcessing.calculate_short_time_energy(np.zeros(n)), 0))

    freq = 100
    t = np.arange(n) / Config.SAMPLE_RATE
    sine = np.sin(2 * np.pi * freq * t) * 1000
    zcr = SignalProcessing.calculate_zero_crossing_rate(sine)
    theory = 2 * freq * n / Config.SAMPLE_RATE / n
    check(f"zcr of {freq}Hz sine ~ theory", abs(zcr - theory) < 0.01)

    acf = SignalProcessing.calculate_short_time_autocorrelation(np.sin(2 * np.pi * freq * t), 100)
    check("normalized acf[0] == 1", np.isclose(acf[0], 1.0))
    check("acf length == max_lag", len(acf) == 100)

    check("vad truth: loud+low-zcr voiced",
          SignalProcessing.voice_activity_detection(10000, 0.2) == 1)
    check("vad truth: quiet silent",
          SignalProcessing.voice_activity_detection(500, 0.05) == 0)

    sig = np.random.randn(1000)
    frames = SignalProcessing.framing(sig, Config.FRAME_SIZE, Config.HOP_SIZE)
    expected = 1 + int(np.ceil((1000 - Config.FRAME_SIZE) / Config.HOP_SIZE))
    check("framing count formula", len(frames) == expected)
    check("frame width", frames.shape[1] == Config.FRAME_SIZE)

    batch = SignalProcessing.calculate_short_time_energy(frames)
    check("batched energy runs on the requested device",
          batch.shape == (expected,) and bool(np.all(batch > 0)))

    from .ops.pipeline import FeatureConfig, FeaturePipeline

    pipe = FeaturePipeline(FeatureConfig.from_config(Config), device=device)
    block, _ = pipe.process_signal(np.random.randn(Config.SAMPLE_RATE).astype(np.float32) * 500)
    expected_frames = 1 + int(
        np.ceil((Config.SAMPLE_RATE - Config.FRAME_SIZE) / Config.HOP_SIZE)
    )  # 99 at the defaults; derived so a Config change can't break the check
    check("fused pipeline frame count",
          int(block.energy.shape[0]) == expected_frames)
    check("fused pipeline mfcc finite", bool(block.mfcc.isfinite().all()))

    print("\nself-test:", "ALL PASS" if ok else "FAILURES PRESENT")
    return ok


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda",
                        help="device to run on: cuda (default) or cpu")
    args = parser.parse_args(argv)
    with on_device(args.device):
        return 0 if run_self_test(device=args.device) else 1


if __name__ == "__main__":
    raise SystemExit(main())
