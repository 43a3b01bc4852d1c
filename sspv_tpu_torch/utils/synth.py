"""Synthetic speech-like audio and the NumPy/SciPy reference features of it.

The port's copies of ``synth_signal``, ``_oracle_features`` and ``_nmse``
from the JAX package's benchmark script (``bench.py:30``, ``:442`` and
``:421``), so that the port's smoke run and tools depend on nothing outside
the port;
``tests/test_torch_synth.py`` holds them ``np.array_equal`` to the
originals.
"""

from __future__ import annotations

import numpy as np

__all__ = ["nmse", "oracle_features", "synth_signal"]


def synth_signal(seconds: float, sr: int = 16000, seed: int = 0) -> np.ndarray:
    """``seconds`` of float32 audio from ``seed``: a low noise floor with
    alternating 0.5 s segments, one in four voiced (130 Hz and its octave)
    and one in four loud noise."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    sig = rng.normal(0, 40, n)
    seg = ((t * 2).astype(int) % 4)
    voiced = seg == 1
    noise = seg == 2
    sig = np.where(voiced, 6000 * np.sin(2 * np.pi * 130 * t) + 2000 * np.sin(2 * np.pi * 260 * t), sig)
    sig = np.where(noise, rng.normal(0, 2000, n), sig)
    return sig.astype(np.float32)


def nmse(got, want) -> float:
    """Normalized mean squared error of ``got`` against ``want``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12))


def oracle_features(sig: np.ndarray) -> dict:
    """Reference-formula features of the 320/160 Hamming frames of ``sig``
    (NumPy ``rfft``, SciPy DCT): energy, zcr, entropy ``(n,)`` and mfcc
    ``(n, 13)``."""
    from scipy.fftpack import dct as scipy_dct

    frame, hop, sr = 320, 160, 16000
    n = 1 + (len(sig) - frame) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    w = (0.54 - 0.46 * np.cos(2 * np.pi * np.arange(frame) / (frame - 1))).astype(np.float32)
    frames = sig[idx].astype(np.float32) * w
    energy = np.sum(frames**2, axis=1)
    signs = np.sign(frames)
    zcr = np.sum(np.abs(np.diff(signs, axis=1)) > 0, axis=1) / frame

    spec = np.abs(np.fft.rfft(frames, n=512)) ** 2
    m = lambda f: 2595 * np.log10(1 + np.asarray(f, float) / 700.0)
    inv = lambda v: 700 * (10 ** (v / 2595.0) - 1)
    pts = inv(np.linspace(m(0.0), m(sr / 2), 28))
    bins = np.floor(513 * pts / sr).astype(int)
    fb = np.zeros((26, 257), np.float32)
    for i in range(1, 27):
        lo, c, hi = bins[i - 1], bins[i], bins[i + 1]
        if c == lo:
            c += 1
        if hi == c:
            hi += 1
        fb[i - 1, lo:c] = (np.arange(lo, c) - lo) / (c - lo)
        fb[i - 1, c:hi] = (hi - np.arange(c, hi)) / (hi - c)
    mel = np.maximum(spec @ fb.T, 1e-10)
    mfcc = scipy_dct(np.log(mel), type=2, axis=1, norm="ortho")[:, :13]
    lift = 1.0 + 11.0 * np.sin(np.pi * np.arange(13) / 22.0)
    mfcc = mfcc * lift

    s = spec.sum(axis=1, keepdims=True)
    norm = np.divide(spec, s, out=np.zeros_like(spec), where=s > 0)
    norm = np.maximum(norm, 1e-12)
    entropy = -np.sum(norm * np.log(norm), axis=1) / np.log(257)
    return {"energy": energy, "zcr": zcr, "entropy": entropy, "mfcc": mfcc}
