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
``n_fft``): the spectrum is the product with ``wc``/``ws`` on the tensor
cores in 3xTF32 (fp32-accurate), which reads the bases packed by
:func:`pack_dense_bases` and takes every geometry whose blocks of 16 frames
fit a block's shared memory (:func:`dense_plan`; up to about 3,400 bins).
Both count in ``LAUNCHES["frame_features"]``; ``ROUTES`` says which one ran.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, fft_tables
from ._build import LAUNCHES, ROUTES
from .frequency_features import entropy_from_power, spectral_tail
from .view_kernels import PLAIN_BLOCK_FRAMES, _on, _stream
from ..utils.profiling import span

__all__ = ["LAUNCHES", "ROUTES", "dense_plan", "frame_features_plain",
           "fused_features", "kernel_route", "pack_dense_bases",
           "takes_fft_route"]

# The dense kernel's tiling (csrc/frame_features.cu): 8 warps of 4 n8 tiles
# a step (256 columns of the interleaved bases), 16-sample steps of depth,
# blocks of 32 or 16 frames, 8 warps' log-mel rows of up to 256 bands, and
# the shared memory a block may use.
DENSE_STEP_TILES = 32
DENSE_DEPTH = 16
DENSE_BLOCK_FRAMES = (32, 16)
DENSE_MAX_FILTERS = 256
DENSE_SMEM_FLOATS = 232448 // 4 - 8 * DENSE_MAX_FILTERS


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
                         mel_ranges=None, dense_bases=None,
                         block_frames: int = PLAIN_BLOCK_FRAMES) -> dict:
    """Plain PyTorch version of :func:`fused_features`: the math of the JAX
    kernel ``_feature_kernel`` (``pallas_kernels.py:43``) with the same pair
    bases, and the separate entropy spectrum of its wrapper. Frames run in
    blocks so the ``(F, n_bins)`` intermediates stay bounded; every frame's
    value is independent of the split. ``n_fft``, ``mel_ranges`` and
    ``dense_bases`` only choose and feed a kernel: the fp32 products here do
    not read them."""
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


def _round(x: int, m: int) -> int:
    return -(-x // m) * m


def dense_plan(frame_size: int, n_bins: int,
               n_frames: int | None = None) -> tuple[int, int] | None:
    """The dense kernel's ``(block_frames, chunk)`` for this geometry: the
    most frames a block takes (32 or 16; 16 for at most 16 ``n_frames``)
    whose power rows leave room to stage at least 64 samples of each frame
    (or all of a shorter one), and the samples staged at a time (all of
    them where they fit, else a multiple of 32). None if even 16 frames do
    not fit (``sspv_frame_features_dense`` refuses a plan past a block's
    shared memory with the same arithmetic)."""
    full = _round(frame_size, DENSE_DEPTH)
    pstride = _round(n_bins, 4) + (4 if _round(n_bins, 4) % 8 == 0 else 0)
    sizes = DENSE_BLOCK_FRAMES
    if n_frames is not None:
        sizes = [b for b in sizes if b // 2 < n_frames] or [sizes[-1]]
    for bm in sizes:
        # per frame: the power row, 32 lanes' energy sums, the sign changes,
        # and the staged samples' row (a multiple of 16 plus 8)
        cap = DENSE_SMEM_FLOATS // bm - pstride - 33
        chunk = full if full + 8 <= cap else (cap - 8) // 32 * 32
        if chunk >= min(full, 64):
            return bm, chunk
    return None


def takes_fft_route(frame_size: int, n_bins: int, n_fft: int | None) -> bool:
    """Whether K3's FFT kernel takes the geometry (see :func:`kernel_route`)."""
    return (n_fft is not None and n_bins == n_fft // 2 + 1
            and fft_tables.fft_route_size(frame_size, n_fft) is not None)


def kernel_route(frame_size: int, n_bins: int, n_fft: int | None) -> str:
    """Which K3 kernel takes ``(F, frame_size)`` frames: ``"fft"`` or
    ``"dense"``. ``n_fft`` is the transform size the caller vouches for
    (``wc``/``ws`` are its windowed DFT pair), or None for arbitrary bases.
    Raises ``NotImplementedError`` for a geometry neither kernel takes (the
    dense kernel's power rows of 16 frames past a block's shared memory)."""
    if takes_fft_route(frame_size, n_bins, n_fft):
        return "fft"
    if dense_plan(frame_size, n_bins) is None:
        raise NotImplementedError(
            f"no K3 kernel takes frames of {frame_size} samples with "
            f"{n_bins} bins: the dense kernel's power rows of "
            f"{DENSE_BLOCK_FRAMES[-1]} frames do not fit a block's shared "
            f"memory")
    return "dense"


def _tf32(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: to
    nearest with ties away from zero, 10 mantissa bits kept (infinities and
    NaNs pass)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = (((u & 0x7FFFFFFF) + 0x1000) & 0xFFFFE000) | (u & 0x80000000)
    return np.where((u & 0x7F800000) == 0x7F800000, u, r).astype(
        np.uint32).view(np.float32)


def pack_dense_bases(wc, ws) -> torch.Tensor:
    """The dense kernel's operand B from the ``(frame_size, n_bins)`` pair:
    columns interleaved ``(wc_k, ws_k)``, zero-padded to a multiple of 16
    samples and of 256 columns, split into TF32 ``hi = tf32(b)`` and
    ``lo = tf32(b - hi)``, in the mma's fragment order: a float32
    ``(kp / 8, tiles, 32, 4)`` tensor on the device of ``wc`` whose
    ``[kb, tile, 4 g + t]`` is ``(hi, hi, lo, lo)`` of rows ``8 kb + 2t``
    and ``8 kb + 2t + 1`` of column ``8 tile + g`` (the kernel's k = t and
    t + 4 of that 8-sample step), one 16-byte load a lane."""
    dev = wc.device if isinstance(wc, torch.Tensor) else torch.device("cpu")
    host = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                      else np.asarray(a, np.float32))  # noqa: E731
    wc, ws = host(wc), host(ws)
    frame, n_bins = wc.shape
    kp = _round(frame, DENSE_DEPTH)
    tiles = _round(-(-2 * n_bins // 8), DENSE_STEP_TILES)
    b = np.zeros((kp, 8 * tiles), np.float32)
    b[:frame, 0:2 * n_bins:2] = wc
    b[:frame, 1:2 * n_bins:2] = ws
    hi = _tf32(b)
    lo = _tf32(b - hi)
    # row 8 kb + 2t + r, column 8 tile + g -> [kb, tile, g, t, r]
    frag = lambda a: a.reshape(kp // 8, 4, 2, tiles, 8).transpose(
        0, 3, 4, 1, 2)  # noqa: E731
    packed = np.concatenate([frag(hi), frag(lo)], axis=-1)
    return torch.from_numpy(
        np.ascontiguousarray(packed.reshape(kp // 8, tiles, 32, 4))).to(dev)


def _launch(frames, *, window, wc, ws, fb_t, dct, lifter, n_fft, mel_ranges,
            compute_entropy: bool, dense_bases=None) -> dict:
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
    if mel_ranges is None:
        mel_ranges = torch.from_numpy(
            fft_tables.mel_ranges(fb_t.cpu().numpy())).to(dev)
    mel_ranges = _on(dev, "mel_ranges", mel_ranges, (num_filters, 2),
                     torch.int32)
    if route == "dense" and num_filters > DENSE_MAX_FILTERS:
        raise ValueError(f"K3's dense kernel takes at most "
                         f"{DENSE_MAX_FILTERS} mel bands, got {num_filters}")
    if route == "fft":
        spectrum = (fft_tables.device_twiddles(n_fft, dev).data_ptr(), n_fft)
    else:
        if dense_bases is None:
            dense_bases = pack_dense_bases(_on(dev, "wc", wc, (frame, n_bins)),
                                           _on(dev, "ws", ws, (frame, n_bins)))
        tiles = _round(-(-2 * n_bins // 8), DENSE_STEP_TILES)
        dense_bases = _on(dev, "dense_bases", dense_bases,
                          (_round(frame, DENSE_DEPTH) // 8, tiles, 32, 4))
        spectrum = (dense_bases.data_ptr(), n_bins,
                    *dense_plan(frame, n_bins, f))
    energy = torch.empty(f, device=dev)
    zcr = torch.empty(f, device=dev)
    entropy = torch.empty(f, device=dev)
    mfcc = torch.empty((f, num_ceps), device=dev)
    if f:
        lib = _build.library()
        kernel = (lib.sspv_frame_features_fft if route == "fft"
                  else lib.sspv_frame_features_dense)
        with torch.cuda.device(dev):
            err = kernel(
                frames.data_ptr(), f, frame, window.data_ptr(), *spectrum,
                fb_t.data_ptr(), mel_ranges.data_ptr(), num_filters,
                dct.data_ptr(), lifter.data_ptr(), num_ceps,
                float(np.float32(np.log(n_bins))), int(compute_entropy),
                energy.data_ptr(), zcr.data_ptr(), entropy.data_ptr(),
                mfcc.data_ptr(), _stream(dev),
            )
        _build.check(err, f"frame_features ({route} route)")
        _build.count("frame_features", "frame_features_" + route)
    return {"energy": energy, "zcr": zcr, "entropy": entropy, "mfcc": mfcc}


def fused_features(frames, *, window, wc, ws, fb_t, dct, lifter,
                   entropy_bases=(None, None), n_fft: int | None = None,
                   mel_ranges=None, dense_bases=None) -> dict:
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
    ``fft_tables.mel_ranges(fb_t)`` as an int32 tensor on the device, and
    ``dense_bases`` :func:`pack_dense_bases` of ``wc``/``ws`` (each built on
    each call if left out; the dense route reads the packed bases, not
    ``wc``/``ws``)."""
    with span("sspv.k3.frame_features"):
        wce, wse = entropy_bases
        kw = dict(window=window, wc=wc, ws=ws, fb_t=fb_t, dct=dct, lifter=lifter)
        if frames.device.type == "cpu":
            return frame_features_plain(frames, entropy_bases=entropy_bases, **kw)
        if frames.device.type != "cuda":
            raise ValueError(f"no frame_features kernel for device {frames.device}")
        out = _launch(frames, compute_entropy=wce is None, n_fft=n_fft,
                      mel_ranges=mel_ranges, dense_bases=dense_bases, **kw)
        if wce is not None:
            out["entropy"] = _separate_entropy(frames, wce, wse)
        return out
