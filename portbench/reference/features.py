"""Plain per-frame features of 16 kHz int16 PCM: energy, zero-crossing rate,
spectral entropy and MFCC, in float64.

The formulas of the upstream project (``signal_processing`` of
Speech-Signal-Processing-and-Visualization), written out again from their
definitions; nothing here imports the port, ``jax`` or ``sspv_tpu``, and
every table (window, DFT, filterbank, DCT, lifter) is built here.

- Streaming framing: full frames only, frame ``k`` = samples
  ``[k*hop, k*hop + frame)``.
- Symmetric window (denominator N-1): Hamming ``0.54 - 0.46 cos``, Hann
  ``0.5 (1 - cos)``, else rectangular.
- Energy ``sum((x w)^2)``; the zero-crossing rate counts sign changes of
  ``x w`` (``sign`` is -1, 0 or 1, so a step to or from 0 counts), as the
  count times ``float32(1 / frame)`` rounded to float32: the JAX package's
  compiled ``count / frame_size``. The VAD compares ZCR with its trailing
  mean, where equal counts tie exactly; a last-bit difference in how the
  rate is formed moves those ties, so the reference forms it the same way.
- Power spectrum ``|DFT_nfft(x w)|^2`` (the frame zero-padded, or cut, to
  ``n_fft``), as a product with the DFT pair.
- Mel filterbank: HTK mel ``2595 log10(1 + f/700)``, ``num_filters + 2``
  points from 0 to sr/2, band edges ``floor((n_fft + 1) f / sr)``, a
  centre equal to its left edge moved one bin up and a right edge equal to
  the centre moved one bin up, triangles ``(k - l)/(c - l)`` and
  ``(r - k)/(r - c)``.
- MFCC ``(log(max(mel, 1e-10)) @ DCT-II ortho) * (1 + L/2 sin(pi n / L))``.
- Entropy: the power row normalized to sum 1 (0 where the row sums to 0),
  clamped at 1e-12, ``-sum(p ln p) / ln(n_bins)``, from a spectrum of
  ``entropy_n_fft`` points.

``precision="float64"`` is the reference. ``precision="control"`` is the
same arithmetic one step below the configuration's float32 with TF32 off:
every product's operands rounded to TF32 (10 mantissa bits, to nearest,
ties away), float32 sums; the benchmark's own runs never compute it.
"""

from __future__ import annotations

import numpy as np
import torch

PRECISIONS = ("float64", "control")
BLOCK_FRAMES = 65536


def window(cfg: dict) -> np.ndarray:
    n = cfg["frame_size"]
    t = np.arange(n, dtype=np.float64)
    if n == 1:
        return np.ones(1)
    if cfg["window_type"] == "hamming":
        return 0.54 - 0.46 * np.cos(2 * np.pi * t / (n - 1))
    if cfg["window_type"] == "hanning":
        return 0.5 * (1 - np.cos(2 * np.pi * t / (n - 1)))
    return np.ones(n)


def mel_filterbank(cfg: dict) -> np.ndarray:
    """``(num_filters, n_fft // 2 + 1)`` float64 triangles."""
    nf, n_fft, sr = cfg["num_filters"], cfg["n_fft"], cfg["sample_rate"]
    mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)  # noqa: E731
    pts = np.linspace(mel(0.0), mel(sr / 2), nf + 2)
    hz = 700.0 * (10.0 ** (pts / 2595.0) - 1.0)
    edges = np.floor((n_fft + 1) * hz / sr).astype(int)
    fb = np.zeros((nf, n_fft // 2 + 1))
    for i in range(nf):
        left, centre, right = edges[i], edges[i + 1], edges[i + 2]
        if centre == left:
            centre += 1
        if right == centre:
            right += 1
        for k in range(left, min(centre, fb.shape[1])):
            fb[i, k] = (k - left) / (centre - left)
        for k in range(centre, min(right, fb.shape[1])):
            fb[i, k] = (right - k) / (right - centre)
    return fb


def dct_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II as an ``(n_in, n_out)`` matrix."""
    n = np.arange(n_in)[:, None]
    k = np.arange(n_out)[None, :]
    m = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in)) * np.sqrt(2.0 / n_in)
    m[:, 0] = np.sqrt(1.0 / n_in)
    return m


def lifter(num_ceps: int, lift: int) -> np.ndarray:
    if not lift or lift <= 0:
        return np.ones(num_ceps)
    return 1 + (lift / 2) * np.sin(np.pi * np.arange(num_ceps) / lift)


def dft_pair(frame: int, n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """``(frame, n_fft // 2 + 1)`` cos and -sin bases of an ``n_fft``-point
    real DFT; rows past ``n_fft`` are zero (the frame is cut)."""
    used = min(frame, n_fft)
    n = np.arange(used)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = -2 * np.pi * n * k / n_fft
    c = np.zeros((frame, k.shape[1]))
    s = np.zeros((frame, k.shape[1]))
    c[:used], s[:used] = np.cos(ang), np.sin(ang)
    return c, s


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as the tensor cores round their operands."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Arith:
    """The reference's arithmetic at one precision on one device."""

    def __init__(self, precision: str, device):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.precision = precision
        self.device = torch.device(device)
        self.dtype = torch.float64 if precision == "float64" else torch.float32

    def const(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "float64":
            return a @ b
        # exact float32 products of TF32 values; torch's own TF32 switch
        # stays off so that the rounding is this function's on any device
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return tf32(a) @ tf32(b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def sq(self, a: torch.Tensor) -> torch.Tensor:
        a = a if self.precision == "float64" else tf32(a)
        return a * a


def entropy_from_power(power: torch.Tensor) -> torch.Tensor:
    total = power.sum(dim=1, keepdim=True)
    p = torch.where(total > 0, power / total, torch.zeros_like(power))
    p = p.clamp_min(1e-12)
    return -(p * torch.log(p)).sum(dim=1) / np.log(power.shape[1])


def features(pcm: torch.Tensor, cfg: dict, precision: str = "float64",
             block_frames: int = BLOCK_FRAMES) -> dict:
    """Per-frame features of one 1-D int16 signal (a tensor on any device):
    ``energy``, ``zcr``, ``entropy`` ``(n,)`` and ``mfcc`` ``(n,
    num_ceps)``, float64 numpy arrays."""
    ar = Arith(precision, pcm.device)
    fr, hop = cfg["frame_size"], cfg["hop_size"]
    x = pcm.to(ar.dtype)
    n = 0 if x.shape[0] < fr else 1 + (x.shape[0] - fr) // hop
    w = ar.const(window(cfg))
    cos, sin = (ar.const(b) for b in dft_pair(fr, cfg["n_fft"]))
    if cfg["entropy_n_fft"] != cfg["n_fft"]:
        ecos, esin = (ar.const(b) for b in dft_pair(fr, cfg["entropy_n_fft"]))
    fb_t = ar.const(mel_filterbank(cfg).T)
    dct = ar.const(dct_matrix(cfg["num_filters"], cfg["num_ceps"]))
    lift = ar.const(lifter(cfg["num_ceps"], cfg["lifter"]))
    inv_frame = np.float32(1) / np.float32(fr)
    out = {k: [] for k in ("energy", "zcr", "entropy", "mfcc")}
    frames = x.unfold(0, fr, hop)[:n] if n else x.new_zeros((0, fr))
    for lo in range(0, n, block_frames):
        xw = frames[lo:lo + block_frames] * w
        out["energy"].append(ar.sq(xw).sum(dim=1))
        sgn = torch.sign(xw)
        count = (sgn[:, 1:] != sgn[:, :-1]).sum(dim=1)
        out["zcr"].append(count.to(torch.float32) * float(inv_frame))
        power = ar.sq(ar.mm(xw, cos)) + ar.sq(ar.mm(xw, sin))
        mel = ar.mm(power, fb_t).clamp_min(1e-10)
        out["mfcc"].append(ar.mm(torch.log(mel), dct) * lift)
        if cfg["entropy_n_fft"] != cfg["n_fft"]:
            power = ar.sq(ar.mm(xw, ecos)) + ar.sq(ar.mm(xw, esin))
        out["entropy"].append(entropy_from_power(power))
    empty = {"mfcc": np.zeros((0, cfg["num_ceps"]))}
    return {k: (torch.cat(v).to(torch.float64).cpu().numpy() if v
                else empty.get(k, np.zeros(0)))
            for k, v in out.items()}
