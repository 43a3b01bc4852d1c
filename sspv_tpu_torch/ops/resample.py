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

The batch programs resample int16 rows with :func:`resample_rows_int16`:
K5 (``csrc/resample.cu``) on a CUDA tensor, :func:`plain_resample_rows_int16`
on a CPU one. That function is the same sum with each row at its own
length, in float64 (an int16 times a float32 tap is exact there), clipped
to [-32768, 32767] and truncated to int16, as ``runtime/audio_source.
_resample_to`` finishes the host path.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import _build
from .fp32 import full_fp32
from ..utils.profiling import span

__all__ = [
    "CALLS",
    "plain_resample_rows_int16",
    "resample_output_len",
    "resample_poly_device",
    "resample_batch_device",
    "resample_rows_int16",
    "resample_to_rate_device",
]

# Strided correlations run by the entry points since import (or since a
# caller set it to 0), whatever the device.
CALLS = {"resample": 0}

# Unfolded elements per block of output rows when ``row_block`` is 0: the
# (rows, W) copy that feeds the product stays at 64 MiB.
_AUTO_BLOCK_ELEMS = 1 << 24


@functools.lru_cache(maxsize=None)
def _filter(up: int, down: int) -> tuple[np.ndarray, int, int]:
    """``(h, n_pre_pad, n_pre_remove)`` of ``resample_poly`` for coprime
    ``up/down``: the float32 taps and the alignment.

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
    return h, n_pre_pad, (half_len + n_pre_pad) // down


@functools.lru_cache(maxsize=None)
def _polyphase_kernel(up: int, down: int) -> tuple[np.ndarray, int, int]:
    """Banded weight matrix + alignment constants for coprime ``up/down``.

    Returns ``(M, s_lo, n_pre_remove)`` where output sample
    ``m = a*up + r`` (for ``m >= n_pre_remove``) is
    ``sum_t x[a*down + s_lo + t] * M[t, r]`` with zero signal extension.
    ``M`` encodes ``resample_poly``'s pre-padded filter
    ``hp = [zeros(n_pre_pad), h]`` (:func:`_filter`) sampled at
    ``hp[r*down - s*up]``.
    """
    h, n_pre_pad, n_pre_remove = _filter(up, down)
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


@functools.lru_cache(maxsize=32)
def _taps_on(up: int, down: int, device: torch.device) -> torch.Tensor:
    """The float32 taps of :func:`_filter` on ``device`` (K5 reads them)."""
    return torch.from_numpy(_filter(up, down)[0]).to(device)


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
    """Resample the rows of a float32 (or float64) ``(B, L)`` batch
    (``L > 0``, ``up != down``, coprime) on its device, in its dtype:
    ``(B, ceil(L*up/down))``."""
    weights = _weights_on(up, down, x.device).to(x.dtype)
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


def _row_lengths(lengths, b: int, n_in: int, device) -> torch.Tensor:
    """Each row's valid samples as a ``(b,)`` int32 tensor on ``device``:
    a tensor there stays as it is (the kernel clamps it to [0, n_in]); a host
    sequence is checked and uploaded."""
    if isinstance(lengths, torch.Tensor) and lengths.device == device:
        if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
            raise ValueError(f"lengths must be int32 ({b},) on {device}, got "
                             f"{lengths.dtype} {tuple(lengths.shape)}")
        return lengths.contiguous()
    lens = np.asarray(lengths.cpu() if isinstance(lengths, torch.Tensor)
                      else lengths, np.int64)
    if lens.shape != (b,) or (lens < 0).any() or (lens > n_in).any():
        raise ValueError(f"lengths must be {b} counts in [0, {n_in}], got "
                         f"{lens.tolist()}")
    return torch.from_numpy(lens.astype(np.int32)).to(device)


def plain_resample_rows_int16(x: torch.Tensor, lengths, up: int,
                              down: int) -> torch.Tensor:
    """K5's plain version: the rows of an int16 ``(B, L)`` tensor, row ``b``
    zero from ``lengths[b]`` on, resampled by the coprime ``up/down`` on
    their device (:func:`_correlate` in float64), clipped, truncated to
    int16 and zero past each row's own output length
    ``resample_output_len(lengths[b], up, down)``."""
    b, n_in = x.shape
    n_out = resample_output_len(n_in, up, down)
    lens = _row_lengths(lengths, b, n_in, x.device).to(torch.int64)
    if n_in == 0:
        return x.new_zeros((b, 0))
    pos = torch.arange(n_in, device=x.device)
    xf = torch.where(pos < lens[:, None], x, 0).to(torch.float64)
    y = _correlate(xf, up, down).clamp_(-32768.0, 32767.0).to(torch.int16)
    own = -(-lens * up // down)
    return y.masked_fill_(torch.arange(n_out, device=x.device) >= own[:, None], 0)


def resample_rows_int16(x: torch.Tensor, lengths, up: int,
                        down: int) -> torch.Tensor:
    """Resample int16 ``(B, L)`` rows, row ``b`` valid below ``lengths[b]``
    (a host sequence, or an int32 ``(B,)`` tensor on the rows' device), by
    ``up/down``: int16 ``(B, resample_output_len(L, up, down))``, each row
    zero past its own output length. K5 on a CUDA tensor (one launch), the
    plain version on a CPU one; ``up == down`` raises (nothing to do)."""
    with span("sspv.k5.resample"):
        up, down = _reduce_ratio(up, down)
        if up == down:
            raise ValueError("up == down: the rows are at the rate asked for")
        if x.dtype != torch.int16 or x.dim() != 2:
            raise ValueError(f"x must be (B, L) int16, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device.type == "cpu":
            return plain_resample_rows_int16(x, lengths, up, down)
        if x.device.type != "cuda":
            raise ValueError(f"no resample kernel for device {x.device}")
        dev = x.device
        b, n_in = x.shape
        lens = _row_lengths(lengths, b, n_in, dev)
        n_out = resample_output_len(n_in, up, down)
        y = torch.empty((b, n_out), dtype=torch.int16, device=dev)
        if b == 0 or n_in == 0:
            return y
        x = x.contiguous()
        taps = _taps_on(up, down, dev)
        _, n_pre_pad, n_pre_remove = _filter(up, down)
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.sspv_resample_rows(
                x.data_ptr(), lens.data_ptr(), b, n_in, n_out, taps.data_ptr(),
                taps.shape[0], up, down, n_pre_pad, n_pre_remove, y.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "resample")
        _build.count("resample")
        return y
