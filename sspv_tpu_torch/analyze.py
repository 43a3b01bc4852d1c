#!/usr/bin/env python3
"""Offline single-file analyzer: the port's copy of ``sspv_tpu/analyze.py``.

Decode a file, run features + VAD + VAD-gated pitch in one call of
``FeaturePipeline.process_signal_pitch_auto`` on the device, print a
summary, and optionally render the five-plot PNG (matplotlib, imported only
for ``--png``) and export the features.

    python -m sspv_tpu_torch.analyze INPUT [--png OUT.png] [--npz OUT.npz]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .config import Config
from .utils.export import export_features_npz, summarize_features


def analyze_file(path: str, png: str | None = None, npz: str | None = None,
                 device="cuda") -> dict:
    from .ops.pipeline import FeatureConfig, FeaturePipeline
    from .runtime.audio_source import FileAudioSource

    src = FileAudioSource(path, sample_rate=Config.SAMPLE_RATE)
    src.open()
    pcm = src.read(1 << 62)
    src.close()

    pipe = FeaturePipeline(FeatureConfig.from_config(Config), device=device)
    # bucketed-length path, fused with the signal-view pitch track: one
    # upload of the int16 signal for features, VAD and VAD-gated F0
    block, _, f0, conf = pipe.process_signal_pitch_auto(pcm)

    # shared summary fields + npz schema with the batch CLI (utils/export.py)
    sl = {k: getattr(block, k).cpu().numpy() for k in
          ("energy", "zcr", "entropy", "vad", "vad_adaptive", "mfcc")}
    sl["f0"], sl["pitch_confidence"] = f0, conf
    summary = summarize_features(path, len(pcm), sl, Config.SAMPLE_RATE)

    if npz:
        export_features_npz(
            npz, sl, Config.SAMPLE_RATE, Config.FRAME_SIZE, Config.HOP_SIZE
        )
        summary["npz"] = npz

    if png:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        vad = sl["vad"]
        fig, axes = plt.subplots(5, 1, figsize=(11, 10))
        fig.suptitle(f"sspv_tpu_torch analysis: {path}")
        axes[0].plot(pcm, lw=0.3, color="#4fc3f7")
        axes[0].set_ylabel("waveform")
        axes[1].plot(sl["energy"], lw=0.8, color="#ffb74d")
        axes[1].set_ylabel("energy")
        axes[2].plot(sl["zcr"], lw=0.8, color="#aed581")
        axes[2].set_ylabel("zcr")
        axes[3].fill_between(np.arange(vad.size), 0, vad, step="mid",
                             color="#e57373", alpha=0.7)
        axes[3].set_ylabel("vad")
        masked = np.where(f0 > 0, f0, np.nan)
        axes[4].plot(masked, ".", ms=2, color="#ba68c8")
        axes[4].set_ylabel("f0 (Hz)")
        axes[4].set_xlabel("frame")
        fig.tight_layout()
        fig.savefig(png, dpi=100)
        plt.close(fig)
        summary["png"] = png

    return summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input", help="audio file to analyze")
    parser.add_argument("--png", help="render plots to this PNG")
    parser.add_argument("--npz", help="export features to this npz")
    parser.add_argument("--device", default="cuda",
                        help="device to run on: cuda (default) or cpu")
    args = parser.parse_args(argv)

    Config.setup_logging()
    # same override layers as the batch CLI: without these, RTP_ knobs
    # would change results between `analyze` and `batch` runs of one file
    yaml_path = os.environ.get("RTP_CONFIG_YAML")
    if yaml_path:
        Config.load_from_yaml(yaml_path)
    Config.load_from_env(prefix="RTP_")
    Config.setup_logging()  # re-apply a LOG_LEVEL override
    summary = analyze_file(args.input, png=args.png, npz=args.npz,
                           device=args.device)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
