"""The upstream project's VAD-gated F0 track, written out again: per raw
(unwindowed) frame, the linear autocorrelation ``R[l] = sum_n x[n]
x[n+l]`` for lags ``0..lag_max``, normalized by ``max(R[0], 1e-10)``; the
first maximum over the band ``[int(sr/fmax), min(frame-1, int(sr/fmin))]``
gives the lag and the confidence; ``f0 = float32(sr) / float32(lag)`` where
the frame's VAD is on and the confidence reaches ``float32(min_confidence)``,
else 0; the confidence is kept for every frame.

The ACF is the inverse DFT of the power spectrum of the frame zero-padded
to a power of two at least ``frame + lag_max`` points (no wrap-around
below ``lag_max``), as two products: ``P = (x C)^2 + (x S)^2`` and ``R = P
W`` with ``W[k, l] = c_k cos(2 pi k l / N) / N`` (``c_k`` 1 at DC and
Nyquist, else 2). ``precision="control"`` rounds the products' operands to
TF32 (see ``features.Arith``).
"""

from __future__ import annotations

import numpy as np
import torch

from .features import BLOCK_FRAMES, Arith, dft_pair


def lag_band(cfg: dict, fmin: float, fmax: float) -> tuple[int, int]:
    sr, fr = cfg["sample_rate"], cfg["frame_size"]
    lo, hi = max(1, int(sr / fmax)), min(fr - 1, int(sr / fmin))
    if lo > hi:
        raise ValueError(f"empty lag band [{lo}, {hi}]")
    return lo, hi


def pitch(pcm: torch.Tensor, vad: np.ndarray, cfg: dict, band: dict,
          precision: str = "float64",
          block_frames: int = BLOCK_FRAMES) -> dict:
    """``f0`` (float32) and ``confidence`` (float64) numpy arrays of one
    1-D int16 signal, gated on ``vad`` (one decision per frame)."""
    ar = Arith(precision, pcm.device)
    fr, hop, sr = cfg["frame_size"], cfg["hop_size"], cfg["sample_rate"]
    lo, hi = lag_band(cfg, band["fmin"], band["fmax"])
    nfft = 1 << int(np.ceil(np.log2(fr + hi)))
    cos, sin = (ar.const(b) for b in dft_pair(fr, nfft))
    k = np.arange(nfft // 2 + 1)[:, None]
    c = np.where((k == 0) | (k == nfft // 2), 1.0, 2.0)
    inv = ar.const(c * np.cos(2 * np.pi * k * np.arange(hi + 1)[None, :]
                              / nfft) / nfft)
    x = pcm.to(ar.dtype)
    n = len(vad)
    frames = x.unfold(0, fr, hop)[:n]
    lags, confs = [], []
    for s in range(0, n, block_frames):
        xb = frames[s:s + block_frames]
        power = ar.sq(ar.mm(xb, cos)) + ar.sq(ar.mm(xb, sin))
        acf = ar.mm(power, inv)
        r0 = acf[:, 0].clamp_min(1e-10)
        norm = acf[:, lo:hi + 1] / r0[:, None]
        best = torch.argmax(norm, dim=1)
        confs.append(torch.gather(norm, 1, best[:, None])[:, 0])
        lags.append(best + lo)
    if not lags:
        return {"f0": np.zeros(0, np.float32), "confidence": np.zeros(0)}
    lag = torch.cat(lags).cpu().numpy()
    conf = torch.cat(confs).to(torch.float64).cpu().numpy()
    f0 = np.float32(sr) / lag.astype(np.float32)
    on = (np.asarray(vad) > 0) & (conf >= float(np.float32(band["min_confidence"])))
    return {"f0": np.where(on, f0, np.float32(0)).astype(np.float32),
            "confidence": conf}
