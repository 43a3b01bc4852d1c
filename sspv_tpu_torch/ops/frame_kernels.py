"""The frames-path kernel: wrapper, plain PyTorch version and launch counter.

Counterpart of ``sspv_tpu/ops/pallas_kernels.py``. The kernel takes raw,
materialized ``(F, frame_size)`` frames (any geometry, any window) and
computes, per frame:

- energy ``sum((x w)^2)`` and the zero-crossing rate of the WINDOWED frame
  ``x w`` (a window with zeros, such as Hann, changes the count);
- the power spectrum from the windowed DFT pair ``x @ wc``, ``x @ ws``;
- mel (clamped at 1e-10) -> log -> ortho DCT -> lifter, and the spectral
  entropy of the same spectrum, or zeros when the entropy spectrum is a
  separate one (``entropy_bases`` set): the wrapper then computes it
  outside the kernel, as the JAX wrapper does.

``fused_features`` dispatches on the device of ``frames``: a CUDA tensor
launches the hand-written kernel K3 (``csrc/frame_features.cu``) for every
F >= 1 (or raises), a CPU tensor runs ``frame_features_plain``. There is no
fallback between the two.

K3 has two kernels, and ``kernel_route`` picks one from the geometry alone:
``"fft"`` where the caller states that ``wc``/``ws`` are the windowed DFT
pair of an ``n_fft``-point transform and ``fft_tables.fft_route_size`` takes
it (a power of two in 256..2048, no shorter than the frame): the spectrum
is a shared-memory real FFT of the windowed frame; ``"dense"`` otherwise
(arbitrary bases, an odd or non-power-of-two ``n_fft``, a frame longer than
``n_fft``): the spectrum is the fp32 product with ``wc``/``ws``. Both count
in ``LAUNCHES["frame_features"]``; ``ROUTES`` says which one ran.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, fft_tables
from ._build import LAUNCHES, ROUTES
from .frequency_features import entropy_from_power, spectral_tail
from .view_kernels import PLAIN_BLOCK_FRAMES, _on, _stream

__all__ = ["LAUNCHES", "ROUTES", "frame_features_plain", "fused_features",
           "kernel_route"]


def _frame_blocks(frames: torch.Tensor, block_frames: int):
    """Row blocks ``[j*b, (j+1)*b)`` (one empty block when F == 0)."""
    for lo in range(0, max(frames.shape[0], 1), block_frames):
        yield frames[lo : lo + block_frames]


def _cat(parts: list) -> dict:
    if len(parts) == 1:
        return parts[0]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def frame_features_plain(frames, *, window, wc, ws, fb_t, dct, lifter,
                         entropy_bases=(None, None), n_fft=None,
                         mel_ranges=None,
                         block_frames: int = PLAIN_BLOCK_FRAMES) -> dict:
    """Plain PyTorch version of :func:`fused_features`: the math of the JAX
    kernel ``_feature_kernel`` (``pallas_kernels.py:43``) with the same pair
    bases, and the separate entropy spectrum of its wrapper. Frames run in
    blocks so the ``(F, n_bins)`` intermediates stay bounded; every frame's
    value is independent of the split. ``n_fft`` and ``mel_ranges`` only
    choose and feed a kernel: the dense products here do not read them."""
    wce, wse = entropy_bases
    out = _cat([
        _frame_features_block(x, window, wc, ws, fb_t, dct, lifter)
        for x in _frame_blocks(frames, block_frames)
    ])
    if wce is not None:
        out["entropy"] = _separate_entropy(frames, wce, wse, block_frames)
    return out


def _frame_features_block(x, window, wc, ws, fb_t, dct, lifter):
    xw = x * window
    energy = (xw * xw).sum(dim=1)
    signs = torch.sign(xw)
    crossings = (signs[:, 1:] != signs[:, :-1]).sum(dim=1)
    # times the f32 reciprocal, as the JAX package's compiled programs
    # compute count / frame_size (XLA folds a division by a constant)
    zcr = crossings.to(torch.float32) * float(
        np.float32(1) / np.float32(x.shape[1])
    )
    return spectral_tail(energy, zcr, _power(x, wc, ws), fb_t=fb_t, dct=dct,
                         lifter=lifter)


def _power(x, wc, ws):
    re = x @ wc
    im = x @ ws
    return re * re + im * im


def _separate_entropy(frames, wce, wse, block_frames: int = PLAIN_BLOCK_FRAMES):
    """Entropy from a separate ``entropy_n_fft`` spectrum, outside the kernel
    (``pallas_kernels.py:237-245``)."""
    return torch.cat([entropy_from_power(_power(x, wce, wse))
                      for x in _frame_blocks(frames, block_frames)])


def kernel_route(frame_size: int, n_bins: int, n_fft: int | None) -> str:
    """Which K3 kernel takes ``(F, frame_size)`` frames: ``"fft"`` or
    ``"dense"``. ``n_fft`` is the transform size the caller vouches for
    (``wc``/``ws`` are its windowed DFT pair), or None for arbitrary bases."""
    if (n_fft is not None and n_bins == n_fft // 2 + 1
            and fft_tables.fft_route_size(frame_size, n_fft) is not None):
        return "fft"
    return "dense"


def _launch(frames, *, window, wc, ws, fb_t, dct, lifter, n_fft, mel_ranges,
            compute_entropy: bool) -> dict:
    if frames.dtype != torch.float32 or frames.dim() != 2:
        raise ValueError(
            f"frames must be a (F, frame_size) float32 tensor, got "
            f"{tuple(frames.shape)} {frames.dtype}"
        )
    frames = frames.contiguous()
    dev = frames.device
    f, frame = frames.shape
    n_bins, num_filters = fb_t.shape
    num_ceps = dct.shape[1]
    route = kernel_route(frame, n_bins, n_fft)
    window = _on(dev, "window", window, (frame,))
    fb_t = _on(dev, "fb_t", fb_t, (n_bins, num_filters))
    dct = _on(dev, "dct", dct, (num_filters, num_ceps))
    lifter = _on(dev, "lifter", lifter, (num_ceps,))
    if route == "fft":
        if mel_ranges is None:
            mel_ranges = torch.from_numpy(
                fft_tables.mel_ranges(fb_t.cpu().numpy())).to(dev)
        mel_ranges = _on(dev, "mel_ranges", mel_ranges, (num_filters, 2),
                         torch.int32)
        spectrum = (fft_tables.device_twiddles(n_fft, dev).data_ptr(), n_fft,
                    fb_t.data_ptr(), mel_ranges.data_ptr())
    else:
        wc = _on(dev, "wc", wc, (frame, n_bins))
        ws = _on(dev, "ws", ws, (frame, n_bins))
        spectrum = (wc.data_ptr(), ws.data_ptr(), n_bins, fb_t.data_ptr())
    energy = torch.empty(f, device=dev)
    zcr = torch.empty(f, device=dev)
    entropy = torch.empty(f, device=dev)
    mfcc = torch.empty((f, num_ceps), device=dev)
    if f:
        lib = _build.library()
        kernel = (lib.sspv_frame_features_fft if route == "fft"
                  else lib.sspv_frame_features)
        with torch.cuda.device(dev):
            err = kernel(
                frames.data_ptr(), f, frame, window.data_ptr(), *spectrum,
                num_filters, dct.data_ptr(), lifter.data_ptr(), num_ceps,
                float(np.float32(np.log(n_bins))), int(compute_entropy),
                energy.data_ptr(), zcr.data_ptr(), entropy.data_ptr(),
                mfcc.data_ptr(), _stream(dev),
            )
        _build.check(err, f"frame_features ({route} route)")
        _build.count("frame_features", "frame_features_" + route)
    return {"energy": energy, "zcr": zcr, "entropy": entropy, "mfcc": mfcc}


def fused_features(frames, *, window, wc, ws, fb_t, dct, lifter,
                   entropy_bases=(None, None), n_fft: int | None = None,
                   mel_ranges=None) -> dict:
    """Per-frame features of raw ``(F, frame_size)`` float32 frames.

    Returns the dict of the JAX ``FeaturePipeline._features``:
    energy/zcr/entropy ``(F,)`` and mfcc ``(F, num_ceps)``. ``wc``/``ws`` are
    the ``(frame_size, n_fft//2+1)`` windowed DFT pair, ``window`` the
    ``(frame_size,)`` analysis window, ``fb_t``/``dct``/``lifter`` the
    cepstral constants, all on the device of ``frames``. ``entropy_bases``
    ``(wc_ent, ws_ent)`` selects a separate entropy spectrum.

    ``n_fft`` states that ``wc``/``ws`` are ``window`` times the cos/sin
    pair of an ``n_fft``-point real transform (``bases.windowed_dft_bases``),
    which lets a CUDA tensor take the FFT kernel (:func:`kernel_route`);
    leave it None for any other bases. ``mel_ranges`` is
    ``fft_tables.mel_ranges(fb_t)`` as an int32 tensor on the device (built
    from ``fb_t`` on each call if left out)."""
    wce, wse = entropy_bases
    kw = dict(window=window, wc=wc, ws=ws, fb_t=fb_t, dct=dct, lifter=lifter)
    if frames.device.type == "cpu":
        return frame_features_plain(frames, entropy_bases=entropy_bases, **kw)
    if frames.device.type != "cuda":
        raise ValueError(f"no frame_features kernel for device {frames.device}")
    out = _launch(frames, compute_entropy=wce is None, n_fft=n_fft,
                  mel_ranges=mel_ranges, **kw)
    if wce is not None:
        out["entropy"] = _separate_entropy(frames, wce, wse)
    return out
