"""VAD-gated banded-ACF pitch: over a whole signal, or over raw frames.

Counterpart of ``sspv_tpu/ops/pitch.py``: ``_lag_band`` (:47),
``_band_peak_pick`` (:69), ``pitch_from_frames`` / ``pitch_track_gated`` /
``pitch_track`` as ``acf_impl="dft"`` (:86-240), ``pitch_track_signal``
(:282-452) and ``pitch_track_signal_gated`` (:489).

The ACF is the Wiener-Khinchin GEMM form. On the rows view of the
50%-overlap geometry it runs in the hand-written K2 kernel on a CUDA tensor
(``view_kernels.fused_view_pitch``) and in its plain PyTorch version on a
CPU tensor. On raw frames (every other geometry, the streaming and packed
programs) it is ``time_features.autocorrelation_via_dft``: three matmuls in
tensor ops, as the JAX package leaves them to XLA. The direct sliding-sum
ACF and AMDF (the JAX ``acf_impl="direct"``) are not ported, so the
functions here take no ``acf_impl``.
"""

from __future__ import annotations

import numpy as np
import torch

from .preprocessing import stream_frames
from .time_features import acf_bases, autocorrelation_via_dft
from .view_kernels import band_peak_pick as _band_peak_pick
from .view_kernels import fused_view_pitch

__all__ = [
    "acf_bases",
    "pitch_from_frames",
    "pitch_track",
    "pitch_track_gated",
    "pitch_track_signal",
    "pitch_track_signal_gated",
]


def _lag_band(sample_rate: int, fmin: float, fmax: float,
              frame_size: int) -> tuple[int, int]:
    """Validated ACF lag band for an F0 search in [fmin, fmax]; raises
    ``ValueError`` on an empty band (fmax too low for the frame length)."""
    lag_min = max(1, int(sample_rate / fmax))
    lag_max = min(frame_size - 1, int(sample_rate / fmin))
    if lag_min > lag_max:
        raise ValueError(
            f"empty pitch lag band: fmin={fmin}, fmax={fmax} with "
            f"frame_size={frame_size} at {sample_rate} Hz gives lags "
            f"[{lag_min}, {lag_max}]; need fmax > "
            f"{sample_rate / (frame_size - 1):.1f} Hz"
        )
    return lag_min, lag_max


def pitch_from_frames(frames: torch.Tensor, sample_rate: int = 16000,
                      fmin: float = 50.0, fmax: float = 400.0,
                      bases: tuple | None = None):
    """Per-frame ``(f0, confidence)``, ``(F,)`` float32 each, from the
    strongest normalized-ACF peak of each raw ``(F, frame_size)`` frame in
    the ``[fmin, fmax]`` band. ``bases`` overrides the band's ACF bases."""
    x = frames.to(torch.float32)
    lag_min, lag_max = _lag_band(sample_rate, fmin, fmax, x.shape[-1])
    if x.shape[0] == 0:
        z = x.new_zeros((0,))
        return z, z.clone()
    acf = autocorrelation_via_dft(x, lag_max, bases)
    return _band_peak_pick(acf, lag_min, lag_max, sample_rate)


def pitch_track_gated(frames, vad, min_confidence, *, sample_rate: int = 16000,
                      fmin: float = 50.0, fmax: float = 400.0,
                      bases: tuple | None = None):
    """Frames-path pitch track: F0 where ``vad`` is on and the confidence
    reaches ``min_confidence``, else 0. Returns ``(f0, confidence)``."""
    f0, conf = pitch_from_frames(frames, sample_rate, fmin, fmax, bases)
    vad = torch.as_tensor(vad, device=f0.device)
    gate = (vad > 0) & (conf >= float(np.float32(min_confidence)))
    return torch.where(gate, f0, torch.zeros_like(f0)), conf


def pitch_track(frames, vad, sample_rate: int = 16000, fmin: float = 50.0,
                fmax: float = 400.0, min_confidence: float = 0.3):
    """VAD-gated pitch track of raw frames (:func:`pitch_track_gated`)."""
    return pitch_track_gated(frames, vad, min_confidence,
                             sample_rate=sample_rate, fmin=fmin, fmax=fmax)


def pitch_track_signal(
    signal: torch.Tensor,
    vad,
    frame_size: int = 320,
    hop_size: int = 160,
    sample_rate: int = 16000,
    fmin: float = 50.0,
    fmax: float = 400.0,
    min_confidence: float = 0.3,
    bases: tuple | None = None,
):
    """VAD-gated pitch track of a whole signal on its device: F0 per frame,
    0 where ``vad`` is off or the normalized-ACF peak is below
    ``min_confidence``. Returns ``(f0, confidence)``, ``(n,)`` float32 each.

    ``signal`` is the 1-D samples or the ``(n+1, hop)`` rows view
    (``FeaturePipeline.host_rows_view``); int16 casts to float32 on its
    device. With frame_size == 2*hop_size the ACF runs on the rows view
    (K2 on CUDA), otherwise on the streaming frames (full frames only).
    ``bases`` overrides the ACF bases of the band (the pipeline passes its
    own).
    """
    x = signal if signal.dtype == torch.float32 else signal.to(torch.float32)
    if x.dim() == 2 and (x.shape[1] != hop_size or frame_size != 2 * hop_size):
        x = x.reshape(-1)
    if frame_size != 2 * hop_size:
        return pitch_track_gated(
            stream_frames(x, frame_size, hop_size), vad, min_confidence,
            sample_rate=sample_rate, fmin=fmin, fmax=fmax, bases=bases,
        )
    if x.dim() == 2:
        rows = x
    elif x.shape[0] >= frame_size:
        n = 1 + (x.shape[0] - frame_size) // hop_size
        rows = x[: (n + 1) * hop_size].reshape(n + 1, hop_size)
    else:  # no full frame
        rows = x.new_zeros((1, hop_size))
    if rows.shape[0] < 2:
        z = torch.zeros(0, dtype=torch.float32, device=x.device)
        return z, z.clone()
    lag_min, lag_max = _lag_band(sample_rate, fmin, fmax, frame_size)
    merged, nyq_b, inv_live, inv_nyq = (
        bases if bases is not None else acf_bases(frame_size, lag_max, x.device)
    )
    f0, conf = fused_view_pitch(
        rows, merged=merged, nyq_b=nyq_b, inv_live=inv_live, inv_nyq=inv_nyq,
        lag_min=lag_min, lag_max=lag_max, sample_rate=sample_rate,
    )
    vad = torch.as_tensor(vad, device=x.device)
    gate = (vad > 0) & (conf >= float(np.float32(min_confidence)))
    return torch.where(gate, f0, torch.zeros_like(f0)), conf


def pitch_track_signal_gated(signal, vad, min_confidence, **kwargs):
    """:func:`pitch_track_signal` gated only on ``vad`` inside, with the
    confidence threshold applied outside: the single gate definition the
    pipeline's fused pitch calls share (a threshold of -inf keeps every
    VAD-on frame)."""
    f0, conf = pitch_track_signal(
        signal, vad, min_confidence=float("-inf"), **kwargs
    )
    vad = torch.as_tensor(vad, device=f0.device)
    gate = (vad > 0) & (conf >= float(np.float32(min_confidence)))
    return torch.where(gate, f0, torch.zeros_like(f0)), conf
