"""Host int16 -> float32 framing of the streaming engine's frames dispatch.

The NumPy path of ``sspv_tpu/utils/native.py`` ``frame_i16_to_f32``, which
the JAX package uses when its native host library is not built; the port
keeps only this path (the values are the same: an exact int16 -> float32
cast, optionally times the window).
"""

from __future__ import annotations

import numpy as np

__all__ = ["frame_i16_to_f32"]


def frame_i16_to_f32(samples: np.ndarray, frame_size: int, hop: int,
                     window: np.ndarray | None = None) -> np.ndarray:
    """Overlapping int16 -> float32 frames (optionally windowed). Streaming
    semantics: full frames only, no tail padding."""
    samples = np.ascontiguousarray(samples, dtype=np.int16)
    if window is not None and np.shape(window) != (frame_size,):
        raise ValueError(f"window shape {np.shape(window)} != ({frame_size},)")
    n = samples.shape[0]
    if n < frame_size:
        return np.zeros((0, frame_size), dtype=np.float32)
    num = 1 + (n - frame_size) // hop
    idx = np.arange(frame_size)[None, :] + hop * np.arange(num)[:, None]
    out = samples[idx].astype(np.float32)
    if window is not None:
        out *= np.asarray(window, dtype=np.float32)
    return out
