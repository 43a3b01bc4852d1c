#!/usr/bin/env python3
"""`.npz` export round-trip helpers.

The reference only writes its 8-key export (engine.py:385-395) — there is no
load path anywhere in its code. We add one so saved sessions can be reloaded,
validated, and plotted offline.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["SessionData", "load_session", "validate_session"]

_REQUIRED_KEYS = {
    "energies", "zcrs", "vads", "spec_entropy", "vads_adaptive",
    "sample_rate", "frame_size", "hop_size",
}


class SessionData(NamedTuple):
    energies: np.ndarray
    zcrs: np.ndarray
    vads: np.ndarray
    spec_entropy: np.ndarray
    vads_adaptive: np.ndarray
    sample_rate: int
    frame_size: int
    hop_size: int
    # optional keys of the analyze/batch per-file schema (utils/export.py);
    # None for engine save_data / reference files, which predate them
    mfcc: np.ndarray | None = None
    f0: np.ndarray | None = None
    pitch_confidence: np.ndarray | None = None

    @property
    def num_frames(self) -> int:
        return int(self.energies.shape[0])

    @property
    def duration_seconds(self) -> float:
        # a malformed npz (sample_rate=0) must be reportable via
        # validate_session, not crash in a display property
        if self.sample_rate <= 0:
            return 0.0
        return self.num_frames * self.hop_size / float(self.sample_rate)


def load_session(path: str) -> SessionData:
    """Load a `voice_processing_data_*.npz` export (ours or the reference's)."""
    with np.load(path) as data:
        missing = _REQUIRED_KEYS - set(data.files)
        if missing:
            raise ValueError(f"{path}: missing keys {sorted(missing)}")
        return SessionData(
            energies=np.asarray(data["energies"]),
            zcrs=np.asarray(data["zcrs"]),
            vads=np.asarray(data["vads"]),
            spec_entropy=np.asarray(data["spec_entropy"]),
            vads_adaptive=np.asarray(data["vads_adaptive"]),
            sample_rate=int(data["sample_rate"]),
            frame_size=int(data["frame_size"]),
            hop_size=int(data["hop_size"]),
            mfcc=np.asarray(data["mfcc"]) if "mfcc" in data.files else None,
            f0=np.asarray(data["f0"]) if "f0" in data.files else None,
            pitch_confidence=(
                np.asarray(data["pitch_confidence"])
                if "pitch_confidence" in data.files else None
            ),
        )


def validate_session(s: SessionData) -> list[str]:
    """Consistency check; returns a list of problems (empty == valid)."""
    problems = []
    n = s.num_frames
    for name in ("zcrs", "vads", "spec_entropy", "vads_adaptive"):
        arr = getattr(s, name)
        if arr.shape != (n,):
            problems.append(f"{name} shape {arr.shape} != ({n},)")
    if s.sample_rate <= 0:
        problems.append(f"bad sample_rate {s.sample_rate}")
    if s.frame_size <= 0 or s.hop_size <= 0:
        problems.append("bad frame geometry")
    if n and not np.all((s.vads == 0) | (s.vads == 1)):
        problems.append("vads not binary")
    for name in ("f0", "pitch_confidence"):
        arr = getattr(s, name)
        if arr is not None and arr.shape != (n,):
            problems.append(f"{name} shape {arr.shape} != ({n},)")
    if s.mfcc is not None and (s.mfcc.ndim != 2 or s.mfcc.shape[0] != n):
        problems.append(f"mfcc shape {s.mfcc.shape} != ({n}, ceps)")
    return problems
