#!/usr/bin/env python3
"""Generate sample ``.npz`` exports through the port's streaming engine
(the reference ships 5 such files at its repo root; N ∈ {21, 22, 100}
frames). Each file goes through ``AudioRuntime`` end-to-end on
``--device``; the samples are the ones ``examples/generate_samples.py``
made for the repo's ``examples/sample_outputs/``, which this port never
writes to: its default output folder is ``build/sample_outputs`` at the
root of the checkout.

Usage:
    python -m sspv_tpu_torch.examples.generate_samples [outdir]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUTDIR = os.path.join(REPO, "build", "sample_outputs")
# the five samples, by name, and their frame counts
SAMPLES = {"tone_burst_21f": 21, "noise_22f": 22, "alternating_100f": 100,
           "am_tone_55f": 55, "silence_tone_100f": 100}


def _paced_signals():
    """(name, int16 signal) pairs with varied lengths/content; frame counts
    mirror the reference's committed samples (21/22/100) plus two more."""
    from ..config import Config

    sr = Config.SAMPLE_RATE
    frame, hop = Config.FRAME_SIZE, Config.HOP_SIZE

    def n_samples(n_frames):
        return (n_frames - 1) * hop + frame

    rng = np.random.default_rng(42)
    out = []

    n = n_samples(21)  # tone burst in noise floor
    t = np.arange(n) / sr
    sig = rng.normal(0, 300, n)
    sig[n // 4: 3 * n // 4] += 9000 * np.sin(2 * np.pi * 170 * t[n // 4: 3 * n // 4])
    out.append(("tone_burst_21f", sig.astype(np.int16)))

    n = n_samples(22)  # pure noise (unvoiced)
    out.append(("noise_22f", rng.normal(0, 2500, n).astype(np.int16)))

    n = n_samples(100)  # alternating voiced/unvoiced
    t = np.arange(n) / sr
    seg = (t * 4).astype(int) % 2
    sig = np.where(seg == 0, 8000 * np.sin(2 * np.pi * 140 * t)
                   + 2500 * np.sin(2 * np.pi * 280 * t), rng.normal(0, 2000, n))
    out.append(("alternating_100f", sig.astype(np.int16)))

    n = n_samples(55)  # speech-like AM tone
    t = np.arange(n) / sr
    env = 0.5 * (1 + np.sin(2 * np.pi * 3 * t))
    sig = env * 9000 * np.sin(2 * np.pi * 190 * t) + rng.normal(0, 400, n)
    out.append(("am_tone_55f", sig.astype(np.int16)))

    n = n_samples(100)  # silence -> tone -> silence (hangover visible)
    t = np.arange(n) / sr
    sig = rng.normal(0, 80, n)
    sig[n // 3: n // 2] += 10000 * np.sin(2 * np.pi * 160 * t[n // 3: n // 2])
    out.append(("silence_tone_100f", sig.astype(np.int16)))

    return out


def generate(outdir: str = DEFAULT_OUTDIR, device="cuda") -> list[str]:
    """Writes ``voice_processing_data_<name>.npz`` per sample into
    ``outdir``; returns the paths."""
    from ..config import Config
    from ..ops.pipeline import FeatureConfig, FeaturePipeline
    from ..runtime import AudioRuntime
    from ..utils.device import card_line, resolve_device
    from ._sources import ArraySource

    device = resolve_device(device)
    card = card_line(device)
    os.makedirs(outdir, exist_ok=True)
    # ONE pipeline across all sample runs (the multistream bench's
    # shared-pipeline pattern): its constants upload once
    shared_pipe = FeaturePipeline(FeatureConfig.from_config(Config),
                                  device=device)
    paths = []
    for name, sig in _paced_signals():
        rt = AudioRuntime(audio_source=ArraySource(sig, Config.SAMPLE_RATE),
                          pipeline=shared_pipe)
        rt.auto_stop_on_eof = True
        rt.start()
        t0 = time.time()
        while rt.is_running and time.time() - t0 < 600:
            time.sleep(0.01)
        rt.stop()
        assert rt.last_error is None, rt.last_error
        n = len(rt.processed_data)
        # a timed-out/partial run must not be kept as a sample
        expected = 1 + (len(sig) - Config.FRAME_SIZE) // Config.HOP_SIZE
        assert n == expected, (name, n, expected)
        path = rt.save_data(outdir)
        # name the file by its content, keeping the reference's prefix scheme
        dst = os.path.join(outdir, f"voice_processing_data_{name}.npz")
        os.replace(path, dst)
        print(f"{dst}: {n} frames, device={device} ({card})")
        paths.append(dst)
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sspv_tpu_torch.examples.generate_samples")
    ap.add_argument("outdir", nargs="?", default=DEFAULT_OUTDIR,
                    help="default: build/sample_outputs of the checkout")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    generate(args.outdir, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
