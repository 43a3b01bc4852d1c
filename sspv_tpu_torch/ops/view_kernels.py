"""The two signal-view kernels: wrappers, plain PyTorch versions and launch
counters.

Counterpart of ``sspv_tpu/ops/pallas_view.py``. Both kernels take the
``(F+1, hop)`` rows view of a signal in the 50%-overlap geometry
(frame_size == 2*hop), where frame i is ``rows[i] || rows[i+1]``:

- ``fused_view_features`` (K1, ``csrc/view_features.cu``): energy, zcr,
  entropy ``(F,)`` and mfcc ``(F, num_ceps)``;
- ``fused_view_pitch`` (K2, ``csrc/view_pitch.cu``): the ungated banded-ACF
  ``(f0, conf)``, ``(F,)`` each.

Each wrapper dispatches on the device of ``rows``: a CUDA tensor launches the
hand-written kernel (or raises), a CPU tensor runs the plain version. There
is no fallback between the two. The plain versions compute the same math as
the JAX package's XLA view path and are what the kernels are held to.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .frequency_features import spectral_tail

__all__ = [
    "LAUNCHES",
    "band_peak_pick",
    "fused_view_features",
    "fused_view_pitch",
    "view_features_plain",
    "view_pitch_plain",
]

# Kernel launches per wrapper since the last reset: each wrapper adds one
# where it launches its kernel and nowhere else, so a caller can show that
# a run went through the kernels.
LAUNCHES = {"view_features": 0, "view_pitch": 0}

# Frames per block of the plain versions: the (F, n_fft) intermediates of
# one block stay bounded (~64 MB) whatever the signal length. Per-frame
# numerics are unchanged by the split (the JAX package's lax.scan over row
# blocks, pipeline.py:867-881).
PLAIN_BLOCK_FRAMES = 32768


def _row_blocks(rows: torch.Tensor, block_frames: int):
    """Row blocks of a rows view with one row of overlap: block j covers
    frames ``[j*b, min((j+1)*b, F))`` (one empty block when F == 0)."""
    f = rows.shape[0] - 1
    for lo in range(0, max(f, 1), block_frames):
        yield rows[lo : min(lo + block_frames, f) + 1]


def _hop_phase(rows, basis):
    """``frames @ basis`` for every frame of a rows view, as two half-frame
    products (the frame matrix is never formed)."""
    hop = rows.shape[1]
    return rows[:-1] @ basis[:hop] + rows[1:] @ basis[hop:]


def _merged_power(m: torch.Tensor, nyq: torch.Tensor) -> torch.Tensor:
    half = m.shape[1] // 2
    live = m[:, :half] * m[:, :half] + m[:, half:] * m[:, half:]
    return torch.cat([live, (nyq * nyq)[:, None]], dim=1)


def view_features_plain(rows, *, w2, wm, wnyq, fb_t, dct, lifter,
                        block_frames: int = PLAIN_BLOCK_FRAMES) -> dict:
    """Plain PyTorch K1: the hop-phase view math of the JAX package
    (``pipeline.py:744-795`` + ``_spectral_tail`` + ``entropy_from_power``)."""
    parts = [
        _view_features_block(rb, w2, wm, wnyq, fb_t, dct, lifter)
        for rb in _row_blocks(rows, block_frames)
    ]
    if len(parts) == 1:
        return parts[0]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _view_features_block(rows, w2, wm, wnyq, fb_t, dct, lifter) -> dict:
    hop = rows.shape[1]
    top, bot = rows[:-1], rows[1:]
    energy = (top * top) @ w2[:hop] + (bot * bot) @ w2[hop:]
    # ZCR on the raw rows (a strictly positive window keeps sign(x*w) ==
    # sign(x)): per-row sign changes shared by the two frames holding the row,
    # plus the change across the row boundary inside each frame.
    signs = torch.sign(rows)
    row_changes = (signs[:, 1:] != signs[:, :-1]).sum(dim=1)
    boundary = signs[1:, 0] != signs[:-1, -1]
    crossings = row_changes[:-1] + row_changes[1:] + boundary
    # times the f32 reciprocal, as the JAX package's compiled programs
    # compute x / frame_size (XLA folds a division by a constant)
    zcr = crossings.to(torch.float32) * float(np.float32(1) / np.float32(2 * hop))
    power = _merged_power(_hop_phase(rows, wm), _hop_phase(rows, wnyq))
    return spectral_tail(energy, zcr, power, fb_t=fb_t, dct=dct, lifter=lifter)


def band_peak_pick(acf, lag_min: int, lag_max: int, sample_rate: int):
    """F0 + confidence from the first maximum of the r0-normalized ACF over
    lags ``[lag_min, lag_max]`` (``sspv_tpu/ops/pitch.py:69``)."""
    r0 = acf[:, 0].clamp_min(1e-10)
    band = acf[:, lag_min : lag_max + 1] / r0[:, None]
    best = torch.argmax(band, dim=1)
    confidence = torch.gather(band, 1, best[:, None])[:, 0]
    lags = (best + lag_min).to(torch.float32)
    # a true f32 division: `scalar / tensor` would round twice (reciprocal)
    return torch.full_like(lags, float(sample_rate)) / lags, confidence


def view_pitch_plain(rows, *, merged, nyq_b, inv_live, inv_nyq, lag_min: int,
                     lag_max: int, sample_rate: int,
                     block_frames: int = PLAIN_BLOCK_FRAMES):
    """Plain PyTorch K2: the hop-phase banded-ACF math of the JAX package
    (``pitch.py:399-414`` + ``_band_peak_pick``)."""
    f0s, confs = [], []
    for rb in _row_blocks(rows, block_frames):
        m = _hop_phase(rb, merged)
        nyq = _hop_phase(rb, nyq_b)
        half = m.shape[1] // 2
        power = m[:, :half] * m[:, :half] + m[:, half:] * m[:, half:]
        acf = power @ inv_live + (nyq * nyq)[:, None] * inv_nyq[None, :]
        f0, conf = band_peak_pick(acf, lag_min, lag_max, sample_rate)
        f0s.append(f0)
        confs.append(conf)
    return torch.cat(f0s), torch.cat(confs)


# -- CUDA launches ------------------------------------------------------------


def _check_rows(rows: torch.Tensor) -> torch.Tensor:
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[0] < 1:
        raise ValueError(
            f"rows must be a (F+1, hop) float32 tensor, got {tuple(rows.shape)} "
            f"{rows.dtype}"
        )
    if rows.shape[1] % 4:
        raise NotImplementedError(
            f"the view kernels need hop % 4 == 0, got hop={rows.shape[1]}"
        )
    rows = rows.contiguous()
    if rows.data_ptr() % 16:  # the kernels read rows as float4
        rows = rows.clone()
    return rows


def _on(device: torch.device, name: str, t: torch.Tensor,
        shape: tuple) -> torch.Tensor:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(
            f"{name} must be float32 {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    return t.contiguous()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def fused_view_features(rows, *, w2, wm, wnyq, fb_t, dct, lifter) -> dict:
    """Per-frame features of a ``(F+1, hop)`` rows view.

    Returns the dict of the JAX ``FeaturePipeline._features_from_rows``:
    energy/zcr/entropy ``(F,)`` and mfcc ``(F, num_ceps)``. ``wm``/``wnyq``
    are the merged windowed-DFT bases, ``w2`` the squared window, ``fb_t``
    the ``(n_fft//2+1, num_filters)`` filterbank, ``dct`` and ``lifter`` the
    cepstral constants, all on the device of ``rows``."""
    if rows.device.type == "cpu":
        return view_features_plain(rows, w2=w2, wm=wm, wnyq=wnyq, fb_t=fb_t,
                                   dct=dct, lifter=lifter)
    if rows.device.type != "cuda":
        raise ValueError(f"no view_features kernel for device {rows.device}")
    rows = _check_rows(rows)
    dev = rows.device
    f, hop = rows.shape[0] - 1, rows.shape[1]
    frame, n_fft = 2 * hop, wm.shape[1]
    if n_fft % 2:
        raise NotImplementedError("the view_features kernel needs an even n_fft")
    n_bins, num_filters = fb_t.shape
    num_ceps = dct.shape[1]
    w2 = _on(dev, "w2", w2, (frame,))
    wm = _on(dev, "wm", wm, (frame, n_fft))
    wnyq = _on(dev, "wnyq", wnyq, (frame,))
    fb_t = _on(dev, "fb_t", fb_t, (n_fft // 2 + 1, num_filters))
    dct = _on(dev, "dct", dct, (num_filters, num_ceps))
    lifter = _on(dev, "lifter", lifter, (num_ceps,))
    energy = torch.empty(f, device=dev)
    zcr = torch.empty(f, device=dev)
    entropy = torch.empty(f, device=dev)
    mfcc = torch.empty((f, num_ceps), device=dev)
    if f:
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.sspv_view_features(
                rows.data_ptr(), f, hop, w2.data_ptr(), wm.data_ptr(),
                wnyq.data_ptr(), n_fft, fb_t.data_ptr(), num_filters,
                dct.data_ptr(), lifter.data_ptr(), num_ceps,
                float(np.float32(np.log(n_bins))), energy.data_ptr(),
                zcr.data_ptr(), entropy.data_ptr(), mfcc.data_ptr(),
                _stream(dev),
            )
        _build.check(err, "view_features")
        LAUNCHES["view_features"] += 1
    return {"energy": energy, "zcr": zcr, "entropy": entropy, "mfcc": mfcc}


def fused_view_pitch(rows, *, merged, nyq_b, inv_live, inv_nyq, lag_min: int,
                     lag_max: int, sample_rate: int):
    """Ungated banded-ACF pitch of a ``(F+1, hop)`` rows view: ``(f0, conf)``
    of shape ``(F,)`` each. The bases come from
    ``time_features._acf_dft_bases_merged``, on the device of ``rows``."""
    if rows.device.type == "cpu":
        return view_pitch_plain(rows, merged=merged, nyq_b=nyq_b,
                                inv_live=inv_live, inv_nyq=inv_nyq,
                                lag_min=lag_min, lag_max=lag_max,
                                sample_rate=sample_rate)
    if rows.device.type != "cuda":
        raise ValueError(f"no view_pitch kernel for device {rows.device}")
    rows = _check_rows(rows)
    dev = rows.device
    f, hop = rows.shape[0] - 1, rows.shape[1]
    frame, nfft = 2 * hop, merged.shape[1]
    half, n_lags = nfft // 2, inv_live.shape[1]
    if nfft % 8 or not 0 <= lag_min <= lag_max < n_lags:
        raise ValueError(f"bad ACF geometry: nfft={nfft}, n_lags={n_lags}, "
                         f"band=[{lag_min}, {lag_max}]")
    merged = _on(dev, "merged", merged, (frame, nfft))
    nyq_b = _on(dev, "nyq_b", nyq_b, (frame,))
    inv_live = _on(dev, "inv_live", inv_live, (half, n_lags))
    inv_nyq = _on(dev, "inv_nyq", inv_nyq, (n_lags,))
    f0 = torch.empty(f, device=dev)
    conf = torch.empty(f, device=dev)
    if f:
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.sspv_view_pitch(
                rows.data_ptr(), f, hop, merged.data_ptr(), nyq_b.data_ptr(),
                nfft, inv_live.data_ptr(), inv_nyq.data_ptr(), n_lags,
                int(lag_min), int(lag_max), float(sample_rate),
                f0.data_ptr(), conf.data_ptr(), _stream(dev),
            )
        _build.check(err, "view_pitch")
        LAUNCHES["view_pitch"] += 1
    return f0, conf
