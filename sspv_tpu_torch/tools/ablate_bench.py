#!/usr/bin/env python3
"""Stage ablation of the offline view path.

Times parts of features + VAD on the uploaded ``(n+1, hop)`` rows view to
show where the device time goes: the spectrum, the K1 kernel, the VAD,
and the plain PyTorch versions of the view path for contrast:

    python -m sspv_tpu_torch.tools.ablate_bench [seconds] [--device cuda]

(default 3,600 s). Each variant prints one JSON line: the host seconds per
call over 4 calls queued back to back with one readback, the median
CUDA-event time per call (``length_probe``'s method), and the kernel
launches of its warm and timed calls. Every ``full_*``
line carries ``nmse_max``, the largest feature NMSE of the same
configuration against ``utils/synth.oracle_features`` on the first 30 s
(the view path; the gate is 1e-5). Variants:

  full_shipped            process_signal_device: K1 + one full-length VAD
  spectrum_only           the windowed 512-point power spectrum alone,
                          torch.fft.rfft of the frames formed from the rows
                          view beforehand (a yardstick the port never
                          calls; chip_smoke.py's FFT stage of K1)
  features_no_vad         K1 alone (FeaturePipeline._view_features)
  features_plus_vad       K1 + _vad_full_length, called apart
  full_plain_view         the plain view versions on the same device
                          (view_features_plain + the same VAD)
  full_scanblock_<n>      full_shipped with SCAN_BLOCK_FRAMES scoped to n

The original's precision and DFT-layout variants and its view-kernel leg
are not ported; one ``not_ported`` line names each with its reason.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..utils.device import card_line, resolve_device, synchronize
from .length_probe import make_signal, pipelined

REPS = 4
PARITY_SECONDS = 30
SCAN_BLOCKS = (16384, 65536)
NOT_PORTED = {
    "spectrum_pair_only": "the TPU's two-basis DFT layout; the port's "
                          "kernels compute the spectrum by one FFT and do "
                          "not act on dft_layout",
    "full_dft_pair": "the same layout through the whole path",
    "full_highest": "a matmul precision of the TPU's bf16 passes; the "
                    "port's kernels are fp32 whatever precision says",
    "full_default": "the same, at the one-pass precision",
    "full_viewkernel": "the Pallas view kernel's leg: on the card K1 is "
                       "the view path, so full_shipped is this variant",
}


def _plain_features(pipe, rows: torch.Tensor) -> dict:
    from ..ops import view_kernels as vk

    return vk.view_features_plain(rows, **pipe._view_consts)


def shipped(pipe, rows: torch.Tensor):
    """``process_signal_device`` on ``rows``: K1 + one full-length VAD."""
    state0 = pipe.initial_state()
    return lambda: pipe.process_signal_device(rows, state0)[0].vad[-1]


def variants(pipe, rows: torch.Tensor):
    """``{name: a call returning a scalar tensor}`` on ``rows``."""
    n = rows.shape[0] - 1
    state0 = pipe.initial_state()
    c = pipe.cfg
    window = pipe._view_consts["window"]
    frames = torch.cat([rows[:-1], rows[1:]], dim=1)  # formed beforehand

    def spectrum():
        return (torch.fft.rfft(frames * window, n=c.n_fft).abs() ** 2).sum()

    def features():
        return sum(v.sum() for v in pipe._view_features(rows, n).values())

    def features_vad():
        feats = pipe._view_features(rows, n)
        return pipe._vad_full_length(feats, state0, n)[0].vad[-1]

    def plain():
        feats = _plain_features(pipe, rows)
        return pipe._vad_full_length(feats, state0, n)[0].vad[-1]

    return {
        "full_shipped": shipped(pipe, rows),
        "spectrum_only": spectrum,
        "features_no_vad": features,
        "features_plus_vad": features_vad,
        "full_plain_view": plain,
    }


def parity(pipe, sig_np, plain: bool = False) -> dict:
    """The largest feature NMSE against the oracle on the first 30 s."""
    from ..utils.synth import nmse, oracle_features

    sub = sig_np[: PARITY_SECONDS * pipe.cfg.sample_rate]
    want = oracle_features(sub)
    rows = torch.from_numpy(pipe.host_rows_view(sub)).to(pipe.device)
    got = (_plain_features(pipe, rows) if plain else
           pipe.process_signal_device(rows)[0]._asdict())
    worst = max(nmse(got[k].cpu().numpy(), want[k]) for k in want)
    return {"nmse_max": float(f"{worst:.3e}")}


def run(seconds: float, device, signal=None) -> list[dict]:
    """Every variant on ``signal`` (default ``synth_signal(seconds)``),
    then one ``not_ported`` line."""
    from ..ops import LAUNCHES
    from ..ops.pipeline import FeatureConfig, FeaturePipeline

    device = resolve_device(device)
    card = card_line(device)
    sig_np, _ = make_signal(seconds, signal)
    pipe = FeaturePipeline(FeatureConfig(), device=device)
    rows = torch.from_numpy(pipe.host_rows_view(sig_np)).to(device)
    synchronize(device)
    lines = []

    def report(name, fn, extra=None):
        before = dict(LAUNCHES)
        fn()  # warm
        per, ms = pipelined(fn, device, REPS)
        launches = {k: v - before[k] for k, v in LAUNCHES.items()
                    if v != before[k]}
        lines.append({"variant": name, "time_s": round(per, 6),
                      "audio_x_realtime": round(seconds / per, 1),
                      "event_ms_median": ms, **(extra or {}),
                      "launches": launches, "device": str(device),
                      "card": card})

    checks = {"full_shipped": parity(pipe, sig_np),
              "full_plain_view": parity(pipe, sig_np, plain=True)}
    for name, fn in variants(pipe, rows).items():
        report(name, fn, checks.get(name))
    for blk in SCAN_BLOCKS:
        old = FeaturePipeline.SCAN_BLOCK_FRAMES
        FeaturePipeline.SCAN_BLOCK_FRAMES = blk
        try:
            scoped = FeaturePipeline(FeatureConfig(), device=device)
            report(f"full_scanblock_{blk}", shipped(scoped, rows),
                   parity(scoped, sig_np))
        finally:
            FeaturePipeline.SCAN_BLOCK_FRAMES = old
    lines.append({"not_ported": NOT_PORTED, "device": str(device),
                  "card": card})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sspv_tpu_torch.tools.ablate_bench")
    ap.add_argument("seconds", nargs="?", type=float, default=3600.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for line in run(args.seconds, args.device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
