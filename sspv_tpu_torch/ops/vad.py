"""Voice-activity detection in PyTorch: the fixed and the adaptive frame
masks, and the streaming composite VAD of the runtime engine as parallel
prefix computations.

Counterpart of ``sspv_tpu/ops/vad.py``. ``voice_activity_detection`` (:68)
is the fixed dual-threshold mask ``(E > T_E) & (Z < T_Z)``;
``adaptive_voice_activity_detection`` (:80) blends one threshold pair from
the means of a history and of the current batch, in float32 like its JAX
counterpart. ``hangover_smooth_scan`` (:367) is the engine's sequential
automaton, kept as the oracle of ``hangover_smooth``.

The streaming VAD (:124-530), semantics per frame t (reference
engine.py:253-288):

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

The thresholds are those of the reference engine, whose history goes
through Python floats and ``np.mean``: the window sums, the means and the
blend are float64. A window of at most 256 float32 values sums in float64
exactly (when its values lie within a factor 2**21 of each other) or far
below float32 resolution, so a repeated zero-crossing count that ties its
trailing mean stays a tie (a float32 mean flips it). The adaptive gate then
compares the float32 feature with its threshold rounded to float32, as the
reference does (NumPy compares a float32 array with a Python float in
float32, ``tests/oracle.py`` ``adaptive_vad``) and as the JAX package does
(everything in float32). The fixed gates compare in float64, as the
reference's Python floats do.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "VadState",
    "adaptive_voice_activity_detection",
    "hangover_smooth",
    "hangover_smooth_scan",
    "initial_packed_state",
    "initial_states",
    "initial_vad_state",
    "pack_state",
    "stack_states",
    "streaming_vad",
    "unpack_state",
    "unstack_states",
    "vad_state_from_numpy",
    "vad_state_to_numpy",
    "voice_activity_detection",
]

_NEG_LARGE = -(2**30)


def voice_activity_detection(energy: torch.Tensor, zcr: torch.Tensor,
                             energy_threshold: float,
                             zcr_threshold: float) -> torch.Tensor:
    """Fixed dual-threshold VAD mask (True == voice; voiced frames have a
    LOW zero-crossing rate). The thresholds compare as float32."""
    e = energy.to(torch.float32)
    z = zcr.to(torch.float32)
    return (e > float(np.float32(energy_threshold))) & (
        z < float(np.float32(zcr_threshold)))


def adaptive_voice_activity_detection(
    energy: torch.Tensor,
    zcr: torch.Tensor,
    energy_history,
    zcr_history,
    alpha: float = 0.8,
    min_energy_threshold: float = 1e-6,
    max_zcr_threshold: float = 0.5,
) -> torch.Tensor:
    """Adaptive VAD over a batch: one threshold pair from blended means.

    ``energy_history``/``zcr_history`` are 1-D sequences of past per-frame
    values (empty or None falls back to the current batch mean). Everything
    is float32 on the device of ``energy``, as in the JAX function: a frame
    exactly at its threshold may flip with the order of the mean's sum (the
    streaming VAD below decides in float64 instead)."""
    e = energy.to(torch.float32)
    z = zcr.to(torch.float32)

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=e.device)

    cur_e = e.mean() if e.numel() else scalar(0.0)
    cur_z = z.mean() if z.numel() else scalar(0.0)

    def hist_mean(hist, cur):
        if hist is None:
            return cur
        h = torch.as_tensor(hist, dtype=torch.float32, device=e.device)
        return h.mean() if h.numel() else cur

    hist_e = hist_mean(energy_history, cur_e)
    hist_z = hist_mean(zcr_history, cur_z)
    a = scalar(max(0.0, min(float(alpha), 0.99)))
    e_th = torch.maximum(scalar(min_energy_threshold),
                         a * hist_e + (1 - a) * cur_e)
    z_th = torch.minimum(scalar(max_zcr_threshold),
                         a * hist_z + (1 - a) * cur_z)
    return (e > e_th) & (z < z_th)


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


def initial_states(batch: int, history_len: int = 256, hangover_on: int = 3,
                   *, device) -> VadState:
    """The initial state of ``batch`` rows: every field with a leading
    ``(batch,)`` axis (``BatchPipeline.initial_states``,
    ``sspv_tpu/parallel/mesh.py:153``)."""
    s = initial_vad_state(history_len, hangover_on, device=device)
    return VadState(*(x.expand((batch,) + x.shape).clone() for x in s))


def stack_states(states) -> VadState:
    """One batched ``VadState`` (leading row axis) from per-row states."""
    return VadState(*(torch.stack(fields) for fields in zip(*states)))


def unstack_states(state: VadState) -> list[VadState]:
    """The per-row states of a batched ``VadState``."""
    return [VadState(*fields) for fields in zip(*(x.unbind(0) for x in state))]


def vad_state_from_numpy(state, *, device) -> VadState:
    """A ``VadState`` from four array-likes ``(energy_buf, zcr_buf, count,
    last_voiced)``, e.g. the JAX package's ``VadState`` (each field goes
    through ``np.asarray``); batched states (a leading row axis on every
    field) carry over as they are."""
    e, z, c, lv = (np.asarray(x) for x in state)
    return VadState(
        energy_buf=torch.tensor(e, dtype=torch.float32, device=device),
        zcr_buf=torch.tensor(z, dtype=torch.float32, device=device),
        count=torch.tensor(c.astype(np.int32), device=device),
        last_voiced=torch.tensor(lv.astype(np.int32), device=device),
    )


def vad_state_to_numpy(state: VadState) -> tuple:
    """``(energy_buf f32, zcr_buf f32, count int32, last_voiced int32)`` as
    NumPy arrays: the fields of the JAX package's ``VadState`` (the two
    scalars as ``np.int32``, or ``(B,)`` arrays for a batched state)."""
    def ints(t):
        a = t.cpu().numpy().astype(np.int32)
        return np.int32(a) if a.ndim == 0 else a

    return (
        state.energy_buf.cpu().numpy(),
        state.zcr_buf.cpu().numpy(),
        ints(state.count),
        ints(state.last_voiced),
    )


def pack_state(state: VadState) -> torch.Tensor:
    """Flatten a ``VadState`` into ONE float32 vector ``(2*history_len + 2,)``
    (``sspv_tpu/ops/vad.py:150``): the two buffers, then count and
    last_voiced bit-viewed (never value-cast) as float32, so every int32
    round-trips exactly; many of them (-4, say) are NaN bit patterns. The
    layout is byte-identical to the JAX package's, and everything moves as
    int32 so no float operation ever touches those bits."""
    scalars = torch.stack([state.count.to(torch.int32).reshape(()),
                           state.last_voiced.to(torch.int32).reshape(())])
    return torch.cat([
        state.energy_buf.to(torch.float32).view(torch.int32),
        state.zcr_buf.to(torch.float32).view(torch.int32),
        scalars,
    ]).view(torch.float32)


def unpack_state(packed: torch.Tensor, history_len: int) -> VadState:
    """Inverse of :func:`pack_state`."""
    bits = packed.contiguous().view(torch.int32)
    return VadState(
        energy_buf=bits[:history_len].view(torch.float32),
        zcr_buf=bits[history_len : 2 * history_len].view(torch.float32),
        count=bits[-2],
        last_voiced=bits[-1],
    )


def initial_packed_state(history_len: int = 256,
                         hangover_on: int = 3) -> np.ndarray:
    """Host-side packed initial state (``sspv_tpu/ops/vad.py:185``)."""
    out = np.zeros((2 * history_len + 2,), dtype=np.float32)
    scalars = np.array([0, -(int(hangover_on) + 1)], dtype=np.int32)
    out[-2:] = scalars.view(np.float32)
    return out


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


def hangover_smooth_scan(vad_initial, hold0, silence_run0, hangover_on: int,
                         release_off: int):
    """Exact transliteration of the engine's sequential automaton
    (engine.py:275-288), the oracle of :func:`hangover_smooth`. It is on no
    main path: the loop runs over a host copy of the decisions, and the
    outputs return on the device of ``vad_initial``. Returns
    ``(vad int32, (hold, silence_run))``, the carries as int32 scalars."""
    on, off = int(hangover_on), int(release_off)
    hold, run = int(hold0), int(silence_run0)
    out = []
    for v in vad_initial.cpu().tolist():
        if v:
            hold, run, o = max(hold, on), 0, 1
        elif hold > 0:
            hold, run, o = hold - 1, 0, 1
        else:
            run += 1
            hold, o = 0, 0 if run >= off else 1
        out.append(o)
    dev = vad_initial.device

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    return i32(out).reshape(len(out)), (i32(hold), i32(run))


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
    # the reference's comparison: float32 feature, threshold rounded to it
    vad_adaptive = ((energy.to(torch.float32) > th_e.to(torch.float32))
                    & (zcr.to(torch.float32) < th_z.to(torch.float32)))

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
