#!/usr/bin/env python3
"""Shared per-file feature summary + npz export: the port's NumPy copy of
``sspv_tpu/utils/export.py``, held equal to it by
``tests/test_torch_batch.py``.

One definition of the summary fields and the npz schema used by BOTH the
``analyze`` CLI and the ``batch`` CLI (batch promises "same fields as
sspv_tpu_torch.analyze"): the schema extends the engine's frozen 8-key
session schema (see ``runtime/engine.py::save_data``) with ``mfcc`` and
optional ``f0``, and its dtypes are part of the compatibility contract —
keeping it in one place is what keeps the two CLIs from desyncing.
"""

from __future__ import annotations

import numpy as np

__all__ = ["summarize_features", "export_features_npz"]


def summarize_features(
    path: str, pcm_len: int, sl: dict, sample_rate: int
) -> dict:
    """One JSON-ready summary line for a file's per-frame feature dict
    (keys: energy/zcr/entropy/vad, optional f0)."""
    vad = sl["vad"]
    f0 = sl.get("f0")
    summary = {
        "file": path,
        "duration_s": round(pcm_len / sample_rate, 3),
        "frames": int(vad.shape[0]),
        "voiced_frames": int(vad.sum()),
        "voiced_pct": round(float(vad.mean()) * 100, 1) if vad.size else 0.0,
        "mean_energy": float(sl["energy"].mean()) if vad.size else 0.0,
        "mean_zcr": round(float(sl["zcr"].mean()), 4) if vad.size else 0.0,
        "mean_entropy": round(float(sl["entropy"].mean()), 3) if vad.size else 0.0,
    }
    if f0 is not None:
        voiced_f0 = f0[f0 > 0]
        summary["median_f0_hz"] = (
            round(float(np.median(voiced_f0)), 1) if voiced_f0.size else None
        )
    return summary


def export_features_npz(
    npz_path: str, sl: dict, sample_rate: int, frame_size: int, hop_size: int
) -> str:
    """Write the shared per-file feature schema; returns ``npz_path``.

    Dtypes mirror the engine's frozen session schema (energies/zcrs f64,
    vads i32, spec_entropy/vads_adaptive f32, i32 scalars) plus mfcc f32
    and, when present, f0 f32.
    """
    extra = {}
    if "f0" in sl:
        extra["f0"] = np.asarray(sl["f0"], np.float32)
    if "pitch_confidence" in sl:
        # additive optional key (readers of the f0-only schema are
        # unaffected): the normalized-ACF peak value the HTTP API already
        # reports alongside f0
        extra["pitch_confidence"] = np.asarray(
            sl["pitch_confidence"], np.float32
        )
    np.savez(
        npz_path,
        energies=np.asarray(sl["energy"], np.float64),
        zcrs=np.asarray(sl["zcr"], np.float64),
        vads=np.asarray(sl["vad"], np.int32),
        spec_entropy=np.asarray(sl["entropy"], np.float32),
        vads_adaptive=np.asarray(sl["vad_adaptive"], np.float32),
        mfcc=np.asarray(sl["mfcc"], np.float32),
        **extra,
        sample_rate=np.int32(sample_rate),
        frame_size=np.int32(frame_size),
        hop_size=np.int32(hop_size),
    )
    return npz_path
