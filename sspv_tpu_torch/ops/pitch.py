"""Pitch-period detection: the banded-ACF peak and the AMDF valley of raw
frames, VAD-gated, over frames or over a whole signal.

Counterpart of ``sspv_tpu/ops/pitch.py``: ``_lag_band`` (:47),
``_band_peak_pick`` (:69), ``pitch_from_frames`` (:86),
``pitch_from_frames_amdf`` (:127), ``pitch_track_amdf`` (:188),
``pitch_track_gated`` (:205), ``pitch_track`` (:226), ``pitch_track_signal``
(:282-452) and ``pitch_track_signal_gated`` (:489), with the JAX defaults:
``acf_impl="direct"`` on frames, ``"dft"`` on a signal.

``acf_impl="direct"`` is the sliding-sum ACF
(``time_features.calculate_short_time_autocorrelation``), one slice product
per lag; ``"dft"`` is the Wiener-Khinchin GEMM form
(``time_features.autocorrelation_via_dft``: three matmuls in tensor ops, as
the JAX package leaves them to XLA). The two agree to about 1e-6 relative,
and so pick the same lag except where two lags tie to rounding. On the rows
view of the 50%-overlap geometry the ``"dft"`` form of
``pitch_track_signal`` runs in the hand-written K2 kernel on a CUDA tensor
(``view_kernels.fused_view_pitch``) and in its plain PyTorch version on a
CPU tensor; every other geometry, ``acf_impl="direct"``, the streaming and
the packed programs run on raw frames. The pipeline, the engine and the
mesh programs pass ``acf_impl="dft"``.

The JAX ``precision``, ``use_kernel`` and ``scan_block`` keywords of
``pitch_track_signal`` choose among TPU programs and have no counterpart:
the port is float32, and the device of the signal decides between K2 and
its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from .preprocessing import stream_frames
from .time_features import (
    acf_bases,
    autocorrelation_via_dft,
    calculate_average_magnitude_difference,
    calculate_short_time_autocorrelation,
)
from .view_kernels import band_peak_pick as _band_peak_pick
from .view_kernels import fused_view_pitch

__all__ = [
    "acf_bases",
    "pitch_from_frames",
    "pitch_from_frames_amdf",
    "pitch_track",
    "pitch_track_amdf",
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


def _gate(f0, conf, vad, min_confidence):
    """F0 where ``vad`` is on and the confidence reaches the float32
    ``min_confidence``, else 0: the one gate of every track here."""
    vad = torch.as_tensor(vad, device=f0.device)
    gate = (vad > 0) & (conf >= float(np.float32(min_confidence)))
    return torch.where(gate, f0, torch.zeros_like(f0)), conf


def pitch_from_frames(frames: torch.Tensor, sample_rate: int = 16000,
                      fmin: float = 50.0, fmax: float = 400.0,
                      acf_impl: str = "direct", bases: tuple | None = None):
    """Per-frame ``(f0, confidence)``, ``(F,)`` float32 each, from the
    strongest normalized-ACF peak of each ``(F, frame_size)`` frame in the
    ``[fmin, fmax]`` band. ``acf_impl`` is ``"direct"`` (sliding sums) or
    ``"dft"`` (Wiener-Khinchin matmuls; ``bases`` overrides its bases)."""
    x = frames.to(torch.float32)
    lag_min, lag_max = _lag_band(sample_rate, fmin, fmax, x.shape[-1])
    if x.shape[0] == 0:
        z = x.new_zeros((0,))
        return z, z.clone()
    if acf_impl == "dft":
        acf = autocorrelation_via_dft(x, lag_max, bases)
    else:
        acf = calculate_short_time_autocorrelation(x, lag_max)
    return _band_peak_pick(acf, lag_min, lag_max, sample_rate)


def pitch_from_frames_amdf(frames: torch.Tensor, sample_rate: int = 16000,
                           fmin: float = 50.0, fmax: float = 400.0):
    """Per-frame ``(f0, confidence)`` from the AMDF valley (the ACF peak's
    dual), a second, independent estimator.

    The pick is the EARLIEST valley, not the global minimum (a periodic
    signal has equally deep valleys at every multiple of its period): the
    first lag within 15 % of the valley-depth range marks the first
    valley's shoulder, and the bottom is the minimum within one minimal
    period (``lag_min`` lags) after it. ``confidence`` is the normalized
    valley depth ``(mean - valley) / mean`` over the band, clipped to
    [0, 1]; an all-zero frame gives exactly 0."""
    x = frames.to(torch.float32)
    lag_min, lag_max = _lag_band(sample_rate, fmin, fmax, x.shape[-1])
    if x.shape[0] == 0:
        z = x.new_zeros((0,))
        return z, z.clone()
    # only the search band: columns are lags lag_min..lag_max
    band = calculate_average_magnitude_difference(x, lag_max,
                                                  lag_start=lag_min)
    vmin = band.min(dim=1, keepdim=True).values
    mean_k = band.mean(dim=1, keepdim=True)
    thresh = vmin + 0.15 * (mean_k - vmin).clamp_min(0.0)
    # argmax of 0/1 values: the first lag at or under the threshold
    shoulder = torch.argmax((band <= thresh).to(torch.uint8), dim=1)
    cols = torch.arange(band.shape[1], device=x.device)[None, :]
    in_window = (cols >= shoulder[:, None]) & (cols < shoulder[:, None] + lag_min)
    best = torch.argmin(
        torch.where(in_window, band, torch.full_like(band, float("inf"))),
        dim=1)
    valley = torch.gather(band, 1, best[:, None])[:, 0]
    mean_band = mean_k[:, 0]
    conf = ((mean_band - valley) / mean_band.clamp_min(1e-10)).clamp(0.0, 1.0)
    lags = (best + lag_min).to(torch.float32)
    # a true f32 division: `scalar / tensor` would round twice (reciprocal)
    return torch.full_like(lags, float(sample_rate)) / lags, conf


def pitch_track_amdf(frames, vad, sample_rate: int = 16000, fmin: float = 50.0,
                     fmax: float = 400.0, min_confidence: float = 0.25):
    """VAD-gated AMDF pitch track (F0 = 0 where unvoiced or the valley is
    shallower than ``min_confidence``); AMDF twin of :func:`pitch_track`."""
    f0, conf = pitch_from_frames_amdf(frames, sample_rate, fmin, fmax)
    return _gate(f0, conf, vad, min_confidence)


def pitch_track_gated(frames, vad, min_confidence, *, sample_rate: int = 16000,
                      fmin: float = 50.0, fmax: float = 400.0,
                      acf_impl: str = "direct", bases: tuple | None = None):
    """Frames-path pitch track: F0 where ``vad`` is on and the confidence
    reaches ``min_confidence``, else 0. Returns ``(f0, confidence)``."""
    f0, conf = pitch_from_frames(frames, sample_rate, fmin, fmax, acf_impl,
                                 bases)
    return _gate(f0, conf, vad, min_confidence)


def pitch_track(frames, vad, sample_rate: int = 16000, fmin: float = 50.0,
                fmax: float = 400.0, min_confidence: float = 0.3,
                acf_impl: str = "direct"):
    """VAD-gated pitch track of raw frames (:func:`pitch_track_gated`)."""
    return pitch_track_gated(frames, vad, min_confidence,
                             sample_rate=sample_rate, fmin=fmin, fmax=fmax,
                             acf_impl=acf_impl)


def pitch_track_signal(
    signal: torch.Tensor,
    vad,
    frame_size: int = 320,
    hop_size: int = 160,
    sample_rate: int = 16000,
    fmin: float = 50.0,
    fmax: float = 400.0,
    min_confidence: float = 0.3,
    acf_impl: str = "dft",
    bases: tuple | None = None,
):
    """VAD-gated pitch track of a whole signal on its device: F0 per frame,
    0 where ``vad`` is off or the normalized-ACF peak is below
    ``min_confidence``. Returns ``(f0, confidence)``, ``(n,)`` float32 each.

    ``signal`` is the 1-D samples or the ``(n+1, hop)`` rows view
    (``FeaturePipeline.host_rows_view``); int16 casts to float32 on its
    device. With ``acf_impl="dft"`` and frame_size == 2*hop_size the ACF
    runs on the rows view (K2 on CUDA), otherwise on the streaming frames
    (full frames only). ``bases`` overrides the ``"dft"`` ACF bases of the
    band (the pipeline passes its own).
    """
    x = signal if signal.dtype == torch.float32 else signal.to(torch.float32)
    view = acf_impl == "dft" and frame_size == 2 * hop_size
    if x.dim() == 2 and (x.shape[1] != hop_size or not view):
        x = x.reshape(-1)
    if not view:
        return pitch_track_gated(
            stream_frames(x, frame_size, hop_size), vad, min_confidence,
            sample_rate=sample_rate, fmin=fmin, fmax=fmax, acf_impl=acf_impl,
            bases=bases,
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
    return _gate(f0, conf, vad, min_confidence)


def pitch_track_signal_gated(signal, vad, min_confidence, **kwargs):
    """:func:`pitch_track_signal` gated only on ``vad`` inside, with the
    confidence threshold applied outside: the single gate definition the
    pipeline's fused pitch calls share (a threshold of -inf keeps every
    VAD-on frame)."""
    f0, conf = pitch_track_signal(
        signal, vad, min_confidence=float("-inf"), **kwargs
    )
    return _gate(f0, conf, vad, min_confidence)
