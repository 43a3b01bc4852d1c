"""On-device polyphase resampling with ``scipy.signal.resample_poly``
parity.

Counterpart of ``sspv_tpu/ops/resample.py``. The function is the same:

- the filter IS ``scipy.signal.firwin(2*10*max(up,down)+1, 1/max(up,down),
  window=("kaiser", 5.0))`` (host, once per rate pair), cast to float32 and
  scaled by ``up`` exactly as ``resample_poly`` does for float32 inputs;
- with ``(M, s_lo, n_pre_remove) = _polyphase_kernel(up, down)``, output
  sample ``a*up + r`` is ``sum_t x[a*down + s_lo + t] * M[t, r]`` with the
  signal extended by zeros on both sides, and the result is the
  ``ceil(n_in * up / down)`` samples from ``n_pre_remove`` on: the length
  and the sample alignment of SciPy's.

The formulation is not. The JAX package regroups the sum into
``ceil(W / down)`` shifted ``(block, down) @ (down, up)`` products under
``lax.scan``, a shape made for a systolic array. Here every run of ``up``
output samples is one ``W``-wide window of the zero-extended signal, the
windows start ``down`` samples apart, and all of them meet the ``(W, up)``
weights at once: one strided correlation, computed as
``unfold(W, step=down)`` of the signal and one ``(A, W) @ (W, up)`` product
per block of output rows, in float32 whatever the process's TF32 switches
say. (The same sum as ``F.conv1d`` with ``stride=down`` and ``up`` output
channels was measured beside it on an H100 and is not kept: ``PERF.md``
holds both times.) Lengths run exact: the JAX package pads each
signal to a grid of lengths to bound its compile count, and nothing
compiles per shape here (the ``bucket`` keyword stays for the signature).
``CALLS`` counts the correlations run, as ``_build.LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .fp32 import full_fp32

__all__ = [
    "CALLS",
    "resample_output_len",
    "resample_poly_device",
    "resample_batch_device",
    "resample_to_rate_device",
]

# Strided correlations run by the entry points since import (or since a
# caller set it to 0), whatever the device.
CALLS = {"resample": 0}

# Unfolded elements per block of output rows when ``row_block`` is 0: the
# (rows, W) copy that feeds the product stays at 64 MiB.
_AUTO_BLOCK_ELEMS = 1 << 24


@functools.lru_cache(maxsize=None)
def _polyphase_kernel(up: int, down: int) -> tuple[np.ndarray, int, int]:
    """Banded weight matrix + alignment constants for coprime ``up/down``.

    Returns ``(M, s_lo, n_pre_remove)`` where output sample
    ``m = a*up + r`` (for ``m >= n_pre_remove``) is
    ``sum_t x[a*down + s_lo + t] * M[t, r]`` with zero signal extension.
    ``M`` encodes ``resample_poly``'s pre-padded filter
    ``hp = [zeros(n_pre_pad), h]`` sampled at ``hp[r*down - s*up]``.

    The filter comes from ``scipy.signal.firwin`` itself: exactly the taps
    ``resample_poly`` designs, so the device path cannot drift from the
    host path it claims parity with. Host-side, once per (up, down).
    """
    from scipy.signal import firwin

    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(
        2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0)
    ).astype(np.float32)
    h = h * np.float32(up)  # resample_poly: h *= up, after the f32 cast
    n_pre_pad = down - (half_len % down)
    n_pre_remove = (half_len + n_pre_pad) // down
    hp_len = n_pre_pad + h.shape[0]
    s_lo = -((hp_len - 1) // up)
    s_hi = ((up - 1) * down) // up
    width = s_hi - s_lo + 1

    t_idx = np.arange(width)[:, None]  # (W, 1)
    r_idx = np.arange(up)[None, :]  # (1, up)
    hp_idx = r_idx * down - (s_lo + t_idx) * up  # (W, up)
    valid = (hp_idx >= n_pre_pad) & (hp_idx < hp_len)
    weights = np.zeros((width, up), dtype=np.float32)
    weights[valid] = h[hp_idx[valid] - n_pre_pad]
    return weights, s_lo, n_pre_remove


@functools.lru_cache(maxsize=32)
def _weights_on(up: int, down: int, device: torch.device) -> torch.Tensor:
    """The ``(W, up)`` weights of ``_polyphase_kernel`` on ``device``."""
    return torch.from_numpy(_polyphase_kernel(up, down)[0]).to(device)


def resample_output_len(n_in: int, up: int, down: int) -> int:
    """``resample_poly`` output length: ``ceil(n_in * up / down)`` (after
    gcd reduction)."""
    g = math.gcd(int(up), int(down))
    up, down = int(up) // g, int(down) // g
    return -(-n_in * up // down)


def _reduce_ratio(up: int, down: int) -> tuple[int, int]:
    up, down = int(up), int(down)
    if up <= 0 or down <= 0:
        raise ValueError(f"up/down must be positive, got {up}/{down}")
    g = math.gcd(up, down)
    return up // g, down // g


def _correlate(x: torch.Tensor, up: int, down: int,
               row_block: int = 0) -> torch.Tensor:
    """Resample the rows of a float32 ``(B, L)`` batch (``L > 0``,
    ``up != down``, coprime) on its device: ``(B, ceil(L*up/down))``."""
    weights = _weights_on(up, down, x.device)
    _, s_lo, n_pre_remove = _polyphase_kernel(up, down)
    width = weights.shape[0]
    batch, n_in = x.shape
    n_out = -(-n_in * up // down)
    # output rows of `up` samples covering [0, n_pre_remove + n_out)
    groups = -(-(n_pre_remove + n_out) // up)
    # zero extension: p[i] = x[i + s_lo]; row a reads p[a*down : a*down + W]
    total = (groups - 1) * down + width
    p = torch.nn.functional.pad(x, (-s_lo, max(0, total + s_lo - n_in)))
    CALLS["resample"] += 1
    if row_block <= 0:
        row_block = max(1, _AUTO_BLOCK_ELEMS // (width * batch))
    windows = p[:, :total].unfold(1, width, down)  # (B, groups, W)
    out = x.new_empty((batch, groups, up))
    with full_fp32(x):
        for lo in range(0, groups, row_block):
            out[:, lo : lo + row_block] = (
                windows[:, lo : lo + row_block] @ weights)
    flat = out.reshape(batch, groups * up)
    return flat[:, n_pre_remove : n_pre_remove + n_out]


def _as_f32(signal, device) -> torch.Tensor:
    """``signal`` as a float32 tensor: a tensor stays on its device, anything
    else goes to ``device``."""
    if isinstance(signal, torch.Tensor):
        return signal.to(torch.float32)
    arr = np.ascontiguousarray(signal)
    if not arr.flags.writeable:  # a decoded file's buffer: torch wants its own
        arr = arr.copy()
    return torch.from_numpy(arr).to(device).to(torch.float32)


def resample_poly_device(signal, up: int, down: int, *,
                         precision: str = "highest", row_block: int = 0,
                         device="cuda") -> torch.Tensor:
    """Resample a 1-D signal by ``up/down`` on the device; returns float32.

    Matches ``scipy.signal.resample_poly(signal.astype(float32), up, down)``
    sample for sample (float32 rounding aside). A tensor runs on its own
    device; an array goes to ``device``. ``precision`` is kept for the
    signature: the port is float32 whatever it says. ``row_block`` is the
    number of output rows (of ``up`` samples) per product; 0 sizes it by
    bytes. Each output sample is the same
    dot product whatever the block, so the split changes no bit.
    """
    up, down = _reduce_ratio(up, down)
    x = _as_f32(signal, device)
    if x.dim() != 1:
        raise ValueError(f"expected 1-D signal, got shape {tuple(x.shape)}")
    if x.shape[0] == 0 or up == down:
        return x
    return _correlate(x[None, :], up, down, int(row_block))[0]


def resample_batch_device(signals, up: int, down: int, *,
                          precision: str = "highest", row_block: int = 0,
                          device="cuda") -> torch.Tensor:
    """Resample a ``(B, L)`` batch by ``up/down`` in one device call.

    Rows are zero-extension resampled independently, exactly like per-row
    ``resample_poly_device``. For rows that are zero-padded to a common
    ``L`` from true length ``l``, the first ``resample_output_len(l, up,
    down)`` output samples equal the resample of the unpadded row: zero
    padding and SciPy's constant-zero signal extension coincide.
    """
    up, down = _reduce_ratio(up, down)
    x = _as_f32(signals, device)
    if x.dim() != 2:
        raise ValueError(f"expected (B, L) batch, got shape {tuple(x.shape)}")
    if x.shape[1] == 0 or up == down:
        return x
    return _correlate(x, up, down, int(row_block))


def resample_to_rate_device(arr, src_sr: int, dst_sr: int, *,
                            bucket: bool = True, device="cuda") -> np.ndarray:
    """Drop-in for ``runtime.audio_source._resample_to`` computed on the
    device: int16 in -> resample -> clip [-32768, 32767] -> truncate to
    int16, back on the host.

    ``bucket`` is kept for the signature and changes nothing: the signal
    runs at its exact length. Bit parity with the host path is near-total
    but not guaranteed: both compute in float32, and a sample whose exact
    value sits at an int16 truncation boundary can round across it under a
    different summation order (under 0.1 % of samples, always one LSB).
    """
    arr = np.asarray(arr)
    if int(src_sr) == int(dst_sr):
        return arr.astype(np.int16, copy=False)
    up, down = _reduce_ratio(int(dst_sr), int(src_sr))
    y = resample_poly_device(arr, up, down, device=device)
    return y.clamp_(-32768.0, 32767.0).to(torch.int16).cpu().numpy()
