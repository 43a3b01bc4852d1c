#!/usr/bin/env python3
"""Offline batch demo: the port's copy of ``sspv_tpu/demo.py``.

Synthesizes a 2 s labeled signal (silence -> 100 Hz voiced tone ->
white-noise unvoiced -> silence), runs the WHOLE signal through the facade's
batched features and the fixed-threshold VAD, reports the real-time factor
plus the detection accuracy against the known segmentation, then runs the
fused feature -> VAD pipeline on the same signal in one call.

    python -m sspv_tpu_torch.demo [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .config import Config
from .ops.pipeline import FeatureConfig, FeaturePipeline
from .signal_processing import SignalProcessing, on_device


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def demo_signal_processing(device="cuda"):
    """The demo, with the facade on ``SignalProcessing.device`` and the
    fused pipeline on ``device`` (``main`` sets both from ``--device``)."""
    print("=" * 60)
    print(f"Speech signal processing on {device} - demo")
    print("=" * 60)

    duration = 2
    sr = Config.SAMPLE_RATE
    t = np.arange(int(duration * sr)) / sr
    signal = np.zeros_like(t)
    freq = 100
    voiced = slice(int(0.5 * sr), int(1.0 * sr))
    unvoiced = slice(int(1.0 * sr), int(1.5 * sr))
    signal[voiced] = np.sin(2 * np.pi * freq * t[voiced]) * 1000
    signal[unvoiced] = np.random.randn(unvoiced.stop - unvoiced.start) * 300

    print(f"synthesized test signal: {duration}s @ {sr}Hz")
    print("layout: silence -> voiced tone -> unvoiced noise -> silence")

    frames = SignalProcessing.framing(signal, Config.FRAME_SIZE, Config.HOP_SIZE)
    print(f"\nframing: {len(frames)} frames x {Config.FRAME_SIZE} samples")

    # batched feature + fixed-threshold VAD over all frames at once
    print("\nprocessing (batched on device)...")
    energies = SignalProcessing.calculate_short_time_energy(frames)
    zcrs = SignalProcessing.calculate_zero_crossing_rate(frames)
    # warm-up so the reported time is steady-state compute, not start-up
    _ = SignalProcessing.voice_activity_detection(energies, zcrs, 100000, 0.05)

    start = time.time()
    energies = SignalProcessing.calculate_short_time_energy(frames)
    zcrs = SignalProcessing.calculate_zero_crossing_rate(frames)
    vads = SignalProcessing.voice_activity_detection(
        energies, zcrs, energy_threshold=100000, zcr_threshold=0.05
    ).astype(int)
    elapsed = time.time() - start
    print(f"done. elapsed: {elapsed:.4f}s, real-time factor: {elapsed/duration:.5f}")

    total = len(frames)
    voiced_n = int(np.sum(vads))
    print("\n" + "=" * 50)
    print("results")
    print("=" * 50)
    print(f"frames: {total}")
    print(f"voiced: {voiced_n} ({voiced_n/total*100:.1f}%)")
    print(f"silent: {total-voiced_n} ({(total-voiced_n)/total*100:.1f}%)")

    print("\nrepresentative frames:")
    times = np.arange(total) * Config.HOP_SIZE / sr
    for i in (5, 15, 25, 35):
        if i < total:
            kind = "voice" if vads[i] else "silence"
            print(
                f"frame {i:2d} ({times[i]:.2f}s): energy={energies[i]:.1e}, "
                f"zcr={zcrs[i]:.3f}, type={kind}"
            )

    truth = ((times >= 0.5) & (times <= 1.5)).astype(int)
    accuracy = float(np.mean(vads == truth)) * 100
    print(f"\ndetection accuracy vs known segmentation: {accuracy:.1f}%")

    # the fused full pipeline (engine semantics incl. MFCC/entropy/adaptive
    # VAD) for comparison: one call for the whole signal
    pipe = FeaturePipeline(FeatureConfig.from_config(Config), device=device)
    pipe.process_signal_auto(signal)
    _sync(device)
    t0 = time.time()
    pipe.process_signal_auto(signal)
    _sync(device)
    fused = time.time() - t0
    print(
        f"\nfused pipeline (energy+zcr+entropy+mfcc+adaptive VAD): "
        f"{fused:.4f}s for {duration}s audio -> {duration/fused:.0f}x real-time"
    )
    print("=" * 50)
    print("demo complete")
    print("=" * 50)
    return {
        "energies": energies,
        "zcrs": zcrs,
        "vads": vads,
        "accuracy": accuracy,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda",
                        help="device to run on: cuda (default) or cpu")
    args = parser.parse_args(argv)
    try:
        with on_device(args.device):
            demo_signal_processing(device=args.device)
    except KeyboardInterrupt:
        print("\ndemo interrupted")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
