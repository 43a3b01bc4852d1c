"""The streaming composite VAD of the runtime engine, as parallel prefix
computations in PyTorch.

Counterpart of ``sspv_tpu/ops/vad.py:124-530``. Semantics per frame t
(reference engine.py:253-288):

1. ``vad_initial = (E>T_E) & ((Z<T_Z) | (H<T_H))``;
2. ``vad_adaptive``: thresholds blended from the mean of the previous
   ``history_len`` frames with the clamped alpha, then ``(E>th_e) & (Z<th_z)``;
3. with ``use_adaptive``: ``vad_initial |= vad_adaptive`` (or ``&=`` in the
   opt-in "and" composite mode);
4. hangover/release smoothing, which depends only on the distance to the
   last initially-voiced frame: a cummax of voiced indices gives it for all
   frames at once.

Plain tensor ops on the device of the inputs; no step of it is a kernel in
the JAX package either.

The decisions are taken in float64, the precision of the reference engine
(its features go through Python floats and ``np.mean``): the window sums, the
means, the blended thresholds and the comparisons. A window of at most 256
float32 values sums in float64 exactly (when its values lie within a factor
2**21 of each other) or far below float32 resolution, so the port's
decisions equal the sequential engine oracle even where a feature ties its
threshold to float32 rounding, as repeated zero-crossing counts do. The JAX
package decides in float32 (the TPU has no float64); the two agree except at
such ties.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "VadState",
    "hangover_smooth",
    "initial_vad_state",
    "streaming_vad",
    "vad_state_from_numpy",
    "vad_state_to_numpy",
]

_NEG_LARGE = -(2**30)


class VadState(NamedTuple):
    """Carry state threaded between blocks of frames.

    ``energy_buf``/``zcr_buf``: the last ``history_len`` per-frame features
    (float32), zero-padded at the front while ``count < history_len``.
    ``count``: number of valid history entries (int32 scalar).
    ``last_voiced``: index of the most recent initially-voiced frame relative
    to the next block's first frame (int32 scalar, <= -1; the initial value
    ``-(ON+1)`` reproduces the automaton's cold start).
    """

    energy_buf: torch.Tensor
    zcr_buf: torch.Tensor
    count: torch.Tensor
    last_voiced: torch.Tensor


def initial_vad_state(history_len: int = 256, hangover_on: int = 3, *,
                      device) -> VadState:
    return VadState(
        energy_buf=torch.zeros(history_len, dtype=torch.float32, device=device),
        zcr_buf=torch.zeros(history_len, dtype=torch.float32, device=device),
        count=torch.tensor(0, dtype=torch.int32, device=device),
        last_voiced=torch.tensor(-(int(hangover_on) + 1), dtype=torch.int32,
                                 device=device),
    )


def vad_state_from_numpy(state, *, device) -> VadState:
    """A ``VadState`` from four array-likes ``(energy_buf, zcr_buf, count,
    last_voiced)``, e.g. the JAX package's ``VadState`` (each field goes
    through ``np.asarray``)."""
    e, z, c, lv = (np.asarray(x) for x in state)
    return VadState(
        energy_buf=torch.tensor(e, dtype=torch.float32, device=device),
        zcr_buf=torch.tensor(z, dtype=torch.float32, device=device),
        count=torch.tensor(int(c), dtype=torch.int32, device=device),
        last_voiced=torch.tensor(int(lv), dtype=torch.int32, device=device),
    )


def vad_state_to_numpy(state: VadState) -> tuple:
    """``(energy_buf f32, zcr_buf f32, count int32, last_voiced int32)`` as
    NumPy arrays: the fields of the JAX package's ``VadState``."""
    return (
        state.energy_buf.cpu().numpy(),
        state.zcr_buf.cpu().numpy(),
        np.int32(state.count.item()),
        np.int32(state.last_voiced.item()),
    )


def _blocked_trailing_sums(ext: torch.Tensor, f: int, history_len: int):
    """Sliding-window sums ``sums[..., t] = ext[..., t:t+H].sum()`` via
    two-level block cumsums (requires ``f % history_len == 0``).

    The window at frame ``t = q*H + r`` is a suffix of block ``q`` plus a
    prefix of block ``q+1``. Both cumsums are DIRECT sums (the suffix one is
    flip -> cumsum -> flip): a subtractive form (``total - prefix``) cancels
    catastrophically when a quiet window follows loud audio inside one block
    and flips threshold decisions (``sspv_tpu/ops/vad.py:206-213``).
    """
    h = history_len
    nb = f // h
    b = ext.reshape(*ext.shape[:-1], nb + 1, h)
    incl = torch.cumsum(b, dim=-1)
    pre = torch.nn.functional.pad(incl[..., :-1], (1, 0))  # sum(b[i, :r])
    suf = torch.flip(torch.cumsum(torch.flip(b, (-1,)), dim=-1), (-1,))
    return (suf[..., :nb, :] + pre[..., 1:, :]).reshape(*ext.shape[:-1], f)


def _window_sums(ext: torch.Tensor, f: int, history_len: int, impl: str):
    if impl == "blocked" and f and f % history_len == 0:
        return _blocked_trailing_sums(ext, f, history_len)
    # Direct window sums: no convolution, which on CUDA would go through
    # cuDNN (in TF32 by default for float32).
    return ext.unfold(-1, history_len, 1)[..., :f, :].sum(dim=-1)


def _trailing_means_pair(v1, v2, buf1, buf2, count, history_len: int,
                         impl: str = "conv"):
    """Per-frame float64 means of the previous <= history_len values of two
    float32 feature streams sharing one count (frames with an empty history
    get the current value itself). Returns
    ``((means1, means2), (new_buf1, new_buf2))``, the buffers in float32."""
    f = v1.shape[0]
    ext = torch.cat([torch.stack([buf1, buf2]), torch.stack([v1, v2])], dim=1)
    ext64 = ext.to(torch.float64)  # (2, H + f)
    sums = _window_sums(ext64, f, history_len, impl)
    idx = torch.arange(f, dtype=torch.int32, device=v1.device)
    counts = (count + idx).clamp_max(history_len)
    means = torch.where(counts > 0,
                        sums / counts.clamp_min(1).to(torch.float64),
                        ext64[:, history_len:])
    new_bufs = ext[:, ext.shape[1] - history_len:]
    return (means[0], means[1]), (new_bufs[0], new_bufs[1])


def _cummax(seeds: torch.Tensor) -> torch.Tensor:
    """Inclusive cummax of a 1-D int32 vector. One ``torch.cummax`` serves
    both the flat and the blocked form of the JAX package: max is exact, so
    every evaluation order gives the same result."""
    return torch.cummax(seeds, dim=0).values


def hangover_smooth(vad_initial, last_voiced, hangover_on: int,
                    release_off: int):
    """Hangover/release smoothing: with ``d`` the distance to the last
    initially-voiced frame, the output is 1 iff ``d < ON + max(OFF, 1)``.
    Returns ``(vad int32, new_last_voiced)``."""
    f = vad_initial.shape[0]
    on = max(int(hangover_on), 0)
    off = max(int(release_off), 0)
    idx = torch.arange(f, dtype=torch.int32, device=vad_initial.device)
    seeds = torch.where(vad_initial, idx, torch.full_like(idx, _NEG_LARGE))
    last = torch.maximum(_cummax(seeds), last_voiced)
    vad = ((idx - last) < on + max(off, 1)).to(torch.int32)
    new_last_voiced = last[-1] - f if f else last_voiced
    return vad, new_last_voiced


def streaming_vad(
    energy: torch.Tensor,
    zcr: torch.Tensor,
    entropy: torch.Tensor,
    state: VadState,
    *,
    energy_threshold: float,
    zcr_threshold: float,
    entropy_voice_max: float,
    use_adaptive: bool,
    adaptive_alpha: float,
    min_energy_threshold: float = 1e-6,
    max_zcr_threshold: float = 0.5,
    hangover_on: int = 3,
    release_off: int = 2,
    history_len: int = 256,
    valid: torch.Tensor | None = None,
    trailing_impl: str = "conv",
    adaptive_margin: float = 1.0,
    composite_mode: str = "or",
):
    """The engine's per-frame composite VAD over a block of frames.

    ``valid`` (optional bool mask) marks padded tail frames: they produce
    outputs but do not advance the state. Returns
    ``(vad int32, vad_adaptive int32, new_state)``.
    """
    f = energy.shape[0]
    if valid is not None:
        # masked frames must not pollute the history sums or the cummax
        e_in = torch.where(valid, energy, torch.zeros_like(energy))
        z_in = torch.where(valid, zcr, torch.zeros_like(zcr))
    else:
        e_in, z_in = energy, zcr

    (e_mean, z_mean), (new_e_buf, new_z_buf) = _trailing_means_pair(
        e_in, z_in, state.energy_buf, state.zcr_buf, state.count,
        history_len, trailing_impl,
    )
    e, z, h = (v.to(torch.float64) for v in (energy, zcr, entropy))
    a = max(0.0, min(float(adaptive_alpha), 0.99))
    th_e = (a * e_mean + (1 - a) * e).clamp_min(min_energy_threshold)
    th_z = (a * z_mean + (1 - a) * z).clamp_max(max_zcr_threshold)
    if float(adaptive_margin) != 1.0:  # opt-in, not reference semantics
        th_e = th_e * float(adaptive_margin)
    vad_adaptive = (e > th_e) & (z < th_z)

    vad_initial = (e > energy_threshold) & (
        (z < zcr_threshold) | (h < entropy_voice_max)
    )
    if use_adaptive:
        if composite_mode == "and":  # opt-in, not reference semantics
            vad_initial = vad_initial & vad_adaptive
        else:
            vad_initial = vad_initial | vad_adaptive
    if valid is not None:
        vad_initial = vad_initial & valid

    vad, new_last = hangover_smooth(
        vad_initial, state.last_voiced, hangover_on, release_off
    )

    if valid is not None:
        n_valid = valid.sum(dtype=torch.int32)
        # Only valid frames enter the history: the padding is a contiguous
        # tail of zeros, so the window ending before it is the new buffer.
        ext_len = history_len + f
        start = ext_len - history_len - (f - n_valid)
        pick = start + torch.arange(history_len, device=e.device)
        new_e_buf = torch.cat([state.energy_buf, e_in])[pick]
        new_z_buf = torch.cat([state.zcr_buf, z_in])[pick]
        new_count = (state.count + n_valid).clamp_max(history_len)
        # last_voiced relative to the next block's start, index n_valid
        idx = torch.arange(f, dtype=torch.int32, device=e.device)
        seeds = torch.where(vad_initial, idx, torch.full_like(idx, _NEG_LARGE))
        last_any = state.last_voiced
        if f:
            last_any = torch.maximum(seeds.max(), last_any)
        new_last = last_any - n_valid
    else:
        new_count = (state.count + f).clamp_max(history_len)

    new_state = VadState(new_e_buf, new_z_buf, new_count, new_last)
    return vad, vad_adaptive.to(torch.int32), new_state
