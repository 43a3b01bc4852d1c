"""The least work of the port's per-frame functions, from shapes alone, and
the H100's peaks: the yardstick of the ``*_roofline`` metrics.

Frozen copy of ``sspv_tpu_torch/tools/roofline.py`` (``bound``,
``rfft_ops``, the function part of ``_features_work`` and ``_pitch_work``
and the peak table). Changed from the original:

- only the function's bound is kept; the "design bound" (the kernel's own
  shared-memory traffic, K3's packed bases, K2's power-of-two transform)
  measures an implementation, not the work, and is left out;
- the bytes count the function's inputs and outputs and the configuration's
  constants (window, filterbank, DCT, lifter), and no implementation table
  (the original added the FFT's twiddle table or K3's packed bases);
- the frames function (``frames_features``) starts from the 1-D int16
  signal, not from gathered frames: device framing and K3 are one function,
  so a change that folds the gather into K3 reads the same work;
- a separate entropy spectrum (``entropy_n_fft != n_fft``) adds its FFT
  and entropy (the original's K3 work assumed a shared one).

Nothing here imports the port: the mel filterbank's nonzero count and the
pitch band come from ``portbench.reference``.
"""

from __future__ import annotations

import math

# NVIDIA's data sheet, H100 SXM at its full 700 W: fp32 outside the tensor
# cores (a multiply-add counts 2) and device memory.
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> tuple[float, str]:
    """The least seconds of the work on the card and what bounds it."""
    t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def rfft_ops(n: int) -> float:
    """Operations of one real-input FFT of ``n`` points: half the
    ``5 n log2 n`` of a radix-2 complex FFT."""
    return 2.5 * n * math.log2(n)


def frames_of(samples: int, cfg: dict) -> int:
    """Full frames of a signal of ``samples`` samples (streaming framing)."""
    fr, hop = cfg["frame_size"], cfg["hop_size"]
    return 0 if samples < fr else 1 + (samples - fr) // hop


def _tail_ops(cfg: dict) -> float:
    """Per frame: the spectral tail of one spectrum (power, mel by the
    filterbank's nonzero weights, log, DCT, lifter, entropy), and where the
    entropy has a spectrum of its own, its FFT, power and entropy in place
    of the shared one's entropy."""
    from ..reference.features import mel_filterbank

    bins = cfg["n_fft"] // 2 + 1
    nf, nc = cfg["num_filters"], cfg["num_ceps"]
    nnz = int((mel_filterbank(cfg) != 0).sum())
    entropy = 5 * bins
    tail = 3 * bins + 2 * nnz + nf + 2 * nf * nc + nc + entropy
    if cfg["entropy_n_fft"] != cfg["n_fft"]:
        ebins = cfg["entropy_n_fft"] // 2 + 1
        tail += rfft_ops(cfg["entropy_n_fft"]) + 3 * ebins + 5 * ebins - entropy
    return tail


def _constant_bytes(cfg: dict) -> int:
    bins = cfg["n_fft"] // 2 + 1
    nf, nc = cfg["num_filters"], cfg["num_ceps"]
    return 4 * (cfg["frame_size"] + bins * nf + nf * nc + nc)


def features_work(cfg: dict, frames: int, input_bytes: int) -> tuple:
    """``(ops, bytes)`` of per-frame energy, ZCR, entropy and MFCC of
    ``frames`` frames read from ``input_bytes`` bytes: window, energy, sign
    changes, a real FFT of ``n_fft`` points and the tail; each output
    (energy, zcr, entropy, the cepstra: float32) written once."""
    ops = frames * (rfft_ops(cfg["n_fft"]) + 3 * cfg["frame_size"]
                    + _tail_ops(cfg))
    nbytes = (input_bytes + _constant_bytes(cfg)
              + frames * 4 * (3 + cfg["num_ceps"]))
    return ops, nbytes


def view_features(cfg: dict, call: dict) -> tuple:
    """K1's function: the features of a signal's frames from its float32
    ``(n+1, hop)`` rows view."""
    n = frames_of(call["samples"], cfg)
    return features_work(cfg, n, 4 * (n + 1) * cfg["hop_size"]) if n else (0, 0)


def frames_features(cfg: dict, call: dict) -> tuple:
    """Device framing and K3 as one function: the features of every frame
    of ``rows`` int16 signals of ``samples`` samples each, from the 1-D
    signals (2 bytes a sample)."""
    rows = call.get("rows", 1)
    n = frames_of(call["samples"], cfg)
    if not n:
        return 0, 0
    return features_work(cfg, rows * n, 2 * rows * call["samples"])


def view_pitch(cfg: dict, call: dict, fmin: float = 50.0,
               fmax: float = 400.0) -> tuple:
    """K2's function: ``(f0, confidence)`` of each frame of a signal from
    its float32 rows view: the linear ACF through two real FFTs of the
    least size it needs (frame + lag_max, rounded up to 128), the
    normalization and the band's peak pick; f0 and confidence written."""
    from ..reference.pitch import lag_band

    n = frames_of(call["samples"], cfg)
    if not n:
        return 0, 0
    _, lag_max = lag_band(cfg, fmin, fmax)
    n_lags = lag_max + 1
    nfft = -(-(cfg["frame_size"] + lag_max) // 128) * 128
    ops = n * (2 * rfft_ops(nfft) + 3 * (nfft // 2 + 1) + 3 * n_lags)
    nbytes = 4 * (n + 1) * cfg["hop_size"] + 8 * n
    return ops, nbytes


FUNCTIONS = {"view_features": view_features, "view_pitch": view_pitch,
             "frames_features": frames_features}
