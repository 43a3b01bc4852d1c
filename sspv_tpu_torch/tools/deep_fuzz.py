#!/usr/bin/env python3
"""Deep fuzz: random VAD configurations and random frame geometries of the
port against the NumPy oracle (``tests/oracle.py``).

- VAD: ``streaming_vad`` on random energy/ZCR/entropy vectors under random
  thresholds, hangover and adaptive settings, on ``--device``; decisions
  must equal ``EngineVadOracle``'s exactly.
- Geometry: a ``FeaturePipeline`` of a random frame, hop, ``n_fft``, mel
  filter count, sample rate and window runs ``process_block`` (the frames
  path: K3 on CUDA, on its FFT route where ``n_fft`` is a power of two in
  256..2048 no shorter than the frame and its dense route otherwise, then
  the VAD) on raw frames of random audio; features must be within NMSE
  1e-5 of the oracle's on the windowed frames, the VAD equal to the
  oracle's on those features.

    python -m sspv_tpu_torch.tools.deep_fuzz [n_vad=300] [n_geom=60] [--device cuda]

Exits 1 on any mismatch.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..utils.device import resolve_device

NMSE_GATE = 1e-5


def _oracle():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "tests"))
    import oracle

    return oracle


def _nmse(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / max(np.mean(want ** 2), 1e-12))


def fuzz_vad(n_vad: int, device) -> int:
    """Random VAD configurations; returns the number of mismatches."""
    from ..ops import vad as vad_ops

    oracle = _oracle()
    fails = 0
    for seed in range(n_vad):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(5, 300))
        e = rng.uniform(0, 3e6, n).astype(np.float32)
        z = rng.uniform(0, 0.7, n).astype(np.float32)
        h = rng.uniform(0, 1, n).astype(np.float32)
        e_th = float(rng.uniform(1, 1e6)); z_th = float(rng.uniform(0.01, 0.6))
        h_th = float(rng.uniform(0.1, 1.0))
        on = int(rng.integers(0, 8)); off = int(rng.integers(0, 8))
        alpha = float(rng.uniform(0, 5)); use_ad = bool(rng.integers(0, 2))
        ref = oracle.EngineVadOracle(e_th, z_th, h_th, use_ad, alpha, on, off)
        wv, wa = ref.run_all(e, z, h)
        st = vad_ops.initial_vad_state(hangover_on=on, device=device)
        gv, ga, _ = vad_ops.streaming_vad(
            *(torch.from_numpy(a).to(device) for a in (e, z, h)), st,
            energy_threshold=e_th, zcr_threshold=z_th, entropy_voice_max=h_th,
            use_adaptive=use_ad, adaptive_alpha=alpha, hangover_on=on,
            release_off=off)
        if not (np.array_equal(gv.cpu().numpy(), wv)
                and np.array_equal(ga.cpu().numpy(), wa)):
            print("VAD MISMATCH seed", seed,
                  dict(on=on, off=off, alpha=alpha, use_ad=use_ad))
            fails += 1
    print(f"vad fuzz: {n_vad - fails}/{n_vad} exact", flush=True)
    return fails


def geometry(seed: int):
    """The random geometry of ``seed``: ``(frame, hop, n_fft, mels, sr,
    window)``."""
    rng = np.random.default_rng(1000 + seed)
    frame = int(rng.integers(64, 600)); hop = int(rng.integers(16, frame))
    n_fft = int(2 ** rng.integers(7, 11)); mels = int(rng.integers(10, 48))
    sr = int(rng.choice([8000, 16000, 22050, 44100]))
    wt = str(rng.choice(["hamming", "hanning", "rectangular"]))
    return rng, (frame, hop, n_fft, mels, sr, wt)


def fuzz_geometry(n_geom: int, device) -> int:
    """Random frame geometries through the frames path; returns the number
    of mismatches."""
    from ..ops.pipeline import FeatureConfig, FeaturePipeline
    from ..ops.windows import get_window

    oracle = _oracle()
    fails = 0
    for seed in range(n_geom):
        rng, (frame, hop, n_fft, mels, sr, wt) = geometry(seed)
        sig = rng.normal(0, 3000, sr // 2).astype(np.float32)
        raw = oracle.framing(sig, frame, hop, np.ones(frame, np.float32))[:40]
        if raw.size == 0:
            continue
        cfg = FeatureConfig(sample_rate=sr, frame_size=frame, hop_size=hop,
                            window_type=wt, n_fft=n_fft, entropy_n_fft=n_fft,
                            num_filters=mels, num_ceps=13)
        pipe = FeaturePipeline(cfg, device=device)
        block, _ = pipe.process_block(raw, pipe.initial_state())
        got = {k: getattr(block, k).cpu().numpy()
               for k in ("energy", "zcr", "entropy", "mfcc", "vad",
                         "vad_adaptive")}
        windowed = (raw * get_window(wt, frame)).astype(np.float32)
        want = {
            "energy": oracle.short_time_energy(windowed),
            "zcr": oracle.zero_crossing_rate(windowed),
            "entropy": oracle.spectral_entropy(windowed, n_fft),
            "mfcc": oracle.mfcc(windowed, sr, n_fft=n_fft, num_filters=mels,
                                num_ceps=pipe.cfg.num_ceps, lifter=cfg.lifter),
        }
        worst = max(_nmse(got[k], want[k]) for k in want)
        ref_vad, ref_adp = oracle.EngineVadOracle(
            cfg.energy_threshold, cfg.zcr_threshold, cfg.entropy_voice_max,
            cfg.use_adaptive_vad, cfg.adaptive_alpha, cfg.hangover_on,
            cfg.release_off, cfg.history_len,
        ).run_all(got["energy"], got["zcr"], got["entropy"])
        vad_equal = (np.array_equal(got["vad"], ref_vad)
                     and np.array_equal(got["vad_adaptive"], ref_adp))
        if worst > NMSE_GATE or not vad_equal:
            print("GEOMETRY MISMATCH", seed, dict(
                frame=frame, hop=hop, n_fft=n_fft, mels=mels, sr=sr,
                window=wt, nmse=worst, vad_equal=vad_equal))
            fails += 1
    print(f"geometry fuzz: {n_geom - fails}/{n_geom} within gates", flush=True)
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sspv_tpu_torch.tools.deep_fuzz")
    ap.add_argument("n_vad", nargs="?", type=int, default=300)
    ap.add_argument("n_geom", nargs="?", type=int, default=60)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    fails = fuzz_vad(args.n_vad, device) + fuzz_geometry(args.n_geom, device)
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
