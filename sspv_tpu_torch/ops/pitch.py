"""VAD-gated banded-ACF pitch over a whole signal, on its rows view.

Counterpart of ``sspv_tpu/ops/pitch.py`` for its signal path:
``_lag_band`` (:47), ``_band_peak_pick`` (:69), ``pitch_track_signal`` on the
rows view with ``acf_impl="dft"`` in the 50%-overlap geometry (:282-448) and
``pitch_track_signal_gated`` (:489). The frames path (direct sliding-sum
ACF, AMDF, other geometries) is not ported yet and raises.

The ACF is the Wiener-Khinchin GEMM form; on a CUDA tensor it runs in the
hand-written K2 kernel (``view_kernels.fused_view_pitch``), on a CPU tensor
in its plain PyTorch version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .time_features import _acf_dft_bases_merged
from .view_kernels import band_peak_pick as _band_peak_pick
from .view_kernels import fused_view_pitch

__all__ = [
    "acf_bases",
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


@functools.lru_cache(maxsize=32)
def acf_bases(frame_size: int, lag_max: int, device: torch.device) -> tuple:
    """``(merged, nyq_b, inv_live, inv_nyq)`` of
    ``_acf_dft_bases_merged(frame_size, lag_max)`` as float32 tensors on
    ``device``, uploaded once per band and device."""
    return tuple(
        torch.from_numpy(np.ascontiguousarray(b)).to(device)
        for b in _acf_dft_bases_merged(int(frame_size), int(lag_max))
    )


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
    device. ``bases`` overrides the ACF bases of the band (the pipeline
    passes its own).
    """
    if acf_impl != "dft" or frame_size != 2 * hop_size:
        raise NotImplementedError(
            "only the rows-view pitch path (acf_impl='dft', frame_size == "
            "2*hop_size) is ported; the frames path is not"
        )
    x = signal if signal.dtype == torch.float32 else signal.to(torch.float32)
    if x.dim() == 2 and x.shape[1] != hop_size:
        x = x.reshape(-1)
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
