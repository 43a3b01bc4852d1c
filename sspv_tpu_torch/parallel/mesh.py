"""Batches of signals and long signals over several devices.

Counterpart of ``sspv_tpu/parallel/mesh.py``. The JAX package shards its
programs over a device mesh and lets XLA's partitioner place the work; here
one process drives the devices of a small :class:`Mesh` itself, with no
``torch.distributed`` and no peer access (results gather to the mesh's first
device with ``.to``):

- ``process_batch``, ``process_batch_masked`` and
  ``process_batch_masked_pitch`` split the rows of a ``(B, L)`` batch over
  the mesh's "data" axis; each group of rows runs on the first device of its
  "data" row. A device frames its rows on the device (int16 casts there),
  runs ONE K3 launch over all of its rows' frames, then ONE VAD call over
  all of its rows, each with its own state and length (K4, batched over the
  rows as the JAX package ``vmap``s the VAD). The pitch program runs one K2
  launch over the rows views of all the device's rows. The corpus's batch
  program (``_exact_batch``) runs only each row's own frames through them.
- ``process_batch_masked(_pitch)`` and ``_exact_batch`` take int16 rows at
  another ``source_rate``: each device then resamples its rows on the card
  (K5, ``ops/resample.resample_rows_int16``, each row at its own length)
  before it frames them, and the rows' lengths become the resampled ones.
- ``process_long`` and ``process_long_pitch`` split one signal's frames over
  every device of the flattened mesh. On the shard route
  (``_long_kernel_feats`` / ``_long_kernel_pitch``) each device runs K1 / K2
  on a contiguous block of frames plus one seam row; one VAD in the blocked
  order then runs on the first device.

A mesh may name one device more than once (``Mesh([cuda0] * 4)``): its shards
then run one after another on that card, which is how one card (or the CPU)
exercises 4 and 8 shards. Per-frame kernel math does not depend on how the
frames are split, so every program's features equal the single-device
``FeaturePipeline``'s bit for bit on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import vad as vad_ops
from ..ops.pipeline import FeatureBlock, FeatureConfig, FeaturePipeline
from ..ops.pitch import _lag_band, pitch_from_frames, pitch_track_signal_gated
from ..ops.resample import (_reduce_ratio, resample_output_len,
                            resample_rows_int16)
from ..ops.view_kernels import fused_view_pitch
from ..utils.profiling import span

__all__ = ["BatchPipeline", "Mesh", "make_mesh"]


class Mesh:
    """A ``(dp, seq)`` array of ``torch.device`` with the axis names
    ``("data", "seq")``. A 1-D list of devices is one "data" row. Devices
    may repeat."""

    def __init__(self, devices, axis_names=("data", "seq")):
        flat = [torch.device(d) for d in np.ravel(np.asarray(devices, object))]
        shape = np.shape(devices)
        if len(shape) == 1:
            shape = (1, len(flat))
        if len(shape) != 2 or not flat:
            raise ValueError(f"a mesh is a non-empty 2-D array of devices, "
                             f"got shape {np.shape(devices)}")
        self.devices = np.empty(len(flat), object)
        self.devices[:] = flat
        self.devices = self.devices.reshape(shape)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              device="cuda") -> Mesh:
    """A ("data", "seq") mesh over ``n_devices`` distinct cards ``cuda:0..``
    (default: every card; raises if there are fewer), or with
    ``device="cpu"`` over ``n_devices`` (default 1) logical CPU devices.

    ``dp`` fixes the data-parallel extent; by default it is the largest
    power of two with ``dp * dp * 2 <= n`` dividing ``n`` (the JAX
    package's split); the rest is the "seq" axis."""
    kind = torch.device(device).type
    if kind == "cuda":
        have = torch.cuda.device_count()
        if not have:
            raise RuntimeError("make_mesh: no CUDA device (device='cpu' "
                               "builds a mesh of CPU devices)")
        n = n_devices or have
        if n < 1 or n > have:
            raise RuntimeError(f"make_mesh: {n} CUDA devices asked for, "
                               f"{have} present")
        devices = [torch.device("cuda", i) for i in range(n)]
    elif kind == "cpu":
        n = n_devices or 1
        devices = [torch.device("cpu")] * n
    else:
        raise ValueError(f"make_mesh: no mesh of {device!r} devices")
    if dp is None:
        dp = 1
        while n % (dp * 2) == 0 and dp * 2 * dp <= n:
            dp *= 2
    if n % dp:
        raise ValueError(f"dp={dp} does not divide {n} devices")
    return Mesh(np.array(devices, object).reshape(dp, n // dp))


def _as_transfer_dtype(signals):
    """int16 stays int16 for the upload (cast to float32 on the device,
    exactly); anything else becomes float32 on the host. A tensor stays
    where it is (int16 or float32)."""
    if isinstance(signals, torch.Tensor):
        return signals if signals.dtype in (torch.int16, torch.float32) \
            else signals.to(torch.float32)
    arr = np.asarray(signals)
    return arr if arr.dtype == np.int16 else arr.astype(np.float32, copy=False)


def _on(state: vad_ops.VadState, device) -> vad_ops.VadState:
    return vad_ops.VadState(*(t.to(device) for t in state))


class BatchPipeline:
    """Batches and long signals over a :class:`Mesh`, one
    ``FeaturePipeline`` (with its constants) per distinct device.

    ``long_kernel`` selects ``process_long``'s shard route (K1/K2 per
    device). It runs where the geometry allows: frame = 2·hop, a strictly
    positive window, no separate entropy spectrum (the JAX package's gate),
    and an ``n_fft`` K1's FFT serves with the bases this configuration
    builds (the port's kernel; the gate follows a later
    ``load_constants``). ``None`` takes it wherever that gate passes,
    ``False`` takes the single-device view path. Unlike the JAX package it
    does NOT gate on ``precision``: the port's kernels are fp32 whatever
    ``precision`` says.

    On the card the shard route is bit-identical to the single-device
    kernel call at every shard count. On the CPU (the plain versions) it is
    so while every shard holds at least 2 frames: a 1-row matrix product
    takes a matrix-vector path there, whose rounding differs, so with
    ``n <= d`` (and ``n > 1``) entropy, mfcc and confidence agree only to
    rounding.
    """

    def __init__(self, mesh: Mesh, cfg: FeatureConfig | None = None,
                 long_kernel: bool | None = None):
        self.mesh = mesh
        self._pipes: dict[torch.device, FeaturePipeline] = {}
        for dev in mesh.devices.flat:
            if dev not in self._pipes:
                self._pipes[dev] = FeaturePipeline(cfg, device=dev)
        self.pipe = self._pipes[mesh.devices.flat[0]]
        self._long_kernel_wanted = long_kernel is None or bool(long_kernel)

    @property
    def _long_kernel(self) -> bool:
        """Whether ``process_long`` takes the shard route: asked for (or
        left to the gate) and K1 takes the geometry with the constants the
        pipelines hold now."""
        return self._long_kernel_wanted and self.pipe._view_kernel_ok

    def load_constants(self, consts: dict) -> None:
        """``FeaturePipeline.load_constants`` on every device's pipeline."""
        for pipe in self._pipes.values():
            pipe.load_constants(consts)

    def initial_states(self, batch: int) -> vad_ops.VadState:
        c = self.pipe.cfg
        return vad_ops.initial_states(batch, c.history_len, c.hangover_on,
                                      device=self.pipe.device)

    # -- (B, L) batches -----------------------------------------------------

    def process_batch(self, signals, states: vad_ops.VadState | None = None):
        """A ``(B, L)`` batch of equal-length signals, rows over "data".
        Returns ``(FeatureBlock, VadState)`` with a leading ``(B,)`` axis,
        on the mesh's first device."""
        with span("sspv.mesh.process_batch"):
            block, states, _ = self._rows(signals, None, states, None)
            return block, states

    def process_batch_masked(self, signals, lengths,
                             states: vad_ops.VadState | None = None, *,
                             source_rate: int | None = None):
        """A ``(B, L)`` zero-padded batch of unequal-length signals:
        ``lengths[i]`` is row i's true sample count. Frames past a row's
        true length are masked out of its VAD state (a row shorter than a
        frame keeps its state).

        ``source_rate``: the rows' rate, where it is not the
        configuration's. The int16 rows are then resampled on the card
        first, each at its own length (K5), and the result is this call's
        on the resampled rows, ``(B, resample_output_len(L, up, down))``
        with lengths ``resample_output_len(lengths[i], up, down)``."""
        with span("sspv.mesh.process_batch_masked"):
            block, states, _ = self._rows(signals, lengths, states, None,
                                          ratio=self._ratio(source_rate))
            return block, states

    def process_batch_masked_pitch(self, signals, lengths,
                                   states: vad_ops.VadState | None = None,
                                   fmin: float = 50.0, fmax: float = 400.0,
                                   min_confidence: float = 0.3, *,
                                   source_rate: int | None = None):
        """:meth:`process_batch_masked` plus the VAD-gated pitch track:
        ``(block, states, f0, conf)`` with ``f0``/``conf`` of shape
        ``(B, frames)``. The gate is the shared one
        (``pitch_track_signal_gated``: ungated track, then
        ``(vad > 0) & (conf >= min_confidence)``) on the VAD masked to each
        row's true frames, as the two-call construction gates it."""
        with span("sspv.mesh.process_batch_masked_pitch"):
            ratio = self._ratio(source_rate)
            block, states, (f0, conf) = self._rows(
                signals, lengths, states, (fmin, fmax), ratio=ratio
            )
            return (block, states, *self._gated_pitch(
                block, self._out_lengths(lengths, ratio), f0, conf,
                min_confidence))

    def _ratio(self, source_rate) -> tuple[int, int] | None:
        """``(up, down)`` from ``source_rate`` to the configuration's rate,
        or None where there is nothing to resample."""
        sr = self.pipe.cfg.sample_rate
        if source_rate is None or int(source_rate) == sr:
            return None
        return _reduce_ratio(sr, int(source_rate))

    @staticmethod
    def _out_lengths(lengths, ratio):
        """``lengths`` at the configuration's rate: each row's
        ``resample_output_len`` (``lengths`` itself without a ratio)."""
        if ratio is None or lengths is None:
            return lengths
        up, down = ratio
        return -(-np.asarray(lengths, np.int64) * up // down)

    def _gated_pitch(self, block, lengths, f0, conf, min_confidence: float):
        """The batch programs' pitch gate: ``(vad > 0) & (conf >=
        min_confidence)``, and frames past each row's true length off.
        Returns ``(f0, conf)``."""
        with span("sspv.mesh.gate"):
            mc = float(np.float32(min_confidence))
            gate = (block.vad > 0) & (conf >= mc)
            if lengths is not None:
                gate &= self._valid(lengths, block.vad.shape[1],
                                    block.vad.device)
            return torch.where(gate, f0, torch.zeros_like(f0)), conf

    def _exact_batch(self, signals, lengths, route_frames: int,
                     band: tuple | None = None, min_confidence: float = 0.3, *,
                     source_rate: int | None = None):
        """The corpus's batch program: :meth:`process_batch_masked` (and
        with ``band = (fmin, fmax)`` :meth:`process_batch_masked_pitch`) of
        a ``(B, L)`` zero-padded batch from initial states, where only each
        row's own frames reach the kernels: K3 on them alone, K2 on each
        row's own rows view, and K4 on each row's length, in the VAD order
        of ``route_frames`` frames (the bucket the JAX package's batch has).
        Returns ``(block, f0, conf)`` (``f0``/``conf`` None without a band);
        past a row's true frames the features, f0 and conf are 0. With
        ``source_rate`` the rows are resampled first, as in
        :meth:`process_batch_masked`; ``route_frames`` counts frames at the
        configuration's rate."""
        with span("sspv.mesh.exact_batch"):
            ratio = self._ratio(source_rate)
            block, _, pitch = self._rows(signals, lengths, None, band,
                                         route_frames, exact=True, ratio=ratio)
            if band is None:
                return block, None, None
            return (block, *self._gated_pitch(
                block, self._out_lengths(lengths, ratio), *pitch,
                min_confidence))

    def _true_n(self, lengths) -> np.ndarray:
        c = self.pipe.cfg
        lens = np.asarray(lengths, np.int64)
        return np.where(lens >= c.frame_size,
                        1 + (lens - c.frame_size) // c.hop_size, 0)

    def _valid(self, lengths, f: int, device) -> torch.Tensor:
        true_n = torch.as_tensor(self._true_n(lengths), device=device)
        return torch.arange(f, device=device)[None, :] < true_n[:, None]

    def _rows(self, signals, lengths, states, band, route_frames=None,
              exact: bool = False, ratio: tuple[int, int] | None = None):
        """The batch programs' body: rows over "data", one K3 launch per
        device over its rows' frames, one VAD call per device over its rows
        (each row with its own state and length: the ``vmap``ped
        ``_masked_row`` of the JAX package; the window sums in the order of
        ``route_frames`` frames, default the batch's), and with ``band =
        (fmin, fmax)`` the ungated pitch of every row. ``exact``: only each
        row's true frames run through K3 and K2 (``_exact_batch``).
        ``ratio``: ``(up, down)`` (``_ratio``), the int16 rows resampled by it
        on each device first, ``lengths`` their lengths before it. Returns
        ``(block, states, (f0, conf) or None)`` on the mesh's first
        device."""
        sig = _as_transfer_dtype(signals)
        if sig.ndim != 2:
            raise ValueError(f"signals must be (B, L), got {tuple(sig.shape)}")
        b, length = int(sig.shape[0]), int(sig.shape[1])
        src_lengths = None
        if ratio is not None:
            if str(sig.dtype) not in ("int16", "torch.int16"):
                raise ValueError(f"rows at a source rate must be int16, got "
                                 f"{sig.dtype}")
            src_lengths = np.full(b, length, np.int64) if lengths is None \
                else np.asarray(lengths, np.int64)
            if src_lengths.shape != (b,) or (src_lengths < 0).any() \
                    or (src_lengths > length).any():
                raise ValueError(f"lengths must be {b} counts in [0, "
                                 f"{length}], got {src_lengths.tolist()}")
            lengths = self._out_lengths(src_lengths, ratio)
            length = resample_output_len(length, *ratio)
        dp = self.mesh.devices.shape[0]
        if b % dp:
            raise ValueError(f"batch {b} is not a multiple of the mesh's "
                             f"data axis ({dp})")
        c = self.pipe.cfg
        f = 1 + (length - c.frame_size) // c.hop_size \
            if length >= c.frame_size else 0
        true_n = None if lengths is None else self._true_n(lengths)
        all_states = self.initial_states(b) if states is None else states
        dev0, per = self.pipe.device, b // dp
        blocks, new_states, pitch = [], [], []
        for i in range(dp):
            pipe = self._pipes[self.mesh.devices[i, 0]]
            rows = slice(i * per, (i + 1) * per)
            own = None  # with exact: each row's frame count
            n = None  # each row's frame count on the device, K4's lengths
            with span("sspv.mesh.rows.frame"):
                x = pipe._upload(sig[rows])
                if ratio is not None:
                    with span("sspv.mesh.resample"):
                        # K4's frame counts and K5's source lengths in one
                        # pageable upload, made while the stream is empty: it
                        # syncs the stream, and after K3 it would wait for K3
                        counts = torch.from_numpy(np.concatenate(
                            [true_n[rows], src_lengths[rows]]).astype(
                                np.int32)).to(pipe.device)
                        n = counts[:per]
                        x = resample_rows_int16(x, counts[per:], *ratio)
                x = x.to(torch.float32)
                if exact and f:
                    own = [int(n) for n in true_n[rows]]
                    windows = x.unfold(1, c.frame_size, c.hop_size)
                    frames = torch.cat([windows[r, :n]
                                        for r, n in enumerate(own)])
                elif f:
                    frames = (x.unfold(1, c.frame_size, c.hop_size)
                              .reshape(-1, c.frame_size))
                else:
                    frames = x.new_zeros((0, c.frame_size))
            feats = pipe._features(frames)  # one K3 launch for all rows
            feats = {k: self._per_row(v, per, f, own)
                     for k, v in feats.items()}
            if true_n is not None and n is None:
                n = torch.from_numpy(true_n[rows].astype(np.int32)).to(
                    pipe.device)
            # one VAD call over all rows (K4 on CUDA), each with its state
            block, st = pipe._vad_stage(
                feats, _on(vad_ops.VadState(*(t[rows] for t in all_states)),
                           pipe.device), None, lengths=n,
                route_frames=route_frames)
            blocks.append(FeatureBlock(*(t.to(dev0) for t in block)))
            new_states.append(_on(st, dev0))
            if band is not None:
                pitch.append(tuple(t.to(dev0) for t in self._rows_pitch(
                    pipe, x, frames, f, *band, own=own)))
        with span("sspv.mesh.rows.collect"):
            block = FeatureBlock(*(torch.cat(ts) for ts in zip(*blocks)))
            new = vad_ops.VadState(*(torch.cat(ts) for ts in zip(*new_states)))
            out_pitch = None
            if band is not None:
                out_pitch = tuple(torch.cat(ts) for ts in zip(*pitch))
        return block, new, out_pitch

    @staticmethod
    def _per_row(v: torch.Tensor, per: int, f: int, own) -> torch.Tensor:
        """Per-frame values of the batch's rows as ``(per, f, ...)``:
        ``v`` holds every frame of every row, or with ``own`` (each row's
        frame count) only those, one row after another; the rest are 0."""
        with span("sspv.mesh.rows.per_row"):
            if own is None:
                return v.reshape((per, f) + v.shape[1:])
            out = v.new_zeros((per, f) + v.shape[1:])
            for r, part in enumerate(v.split(own)):
                out[r, : part.shape[0]] = part
            return out

    @classmethod
    def _rows_pitch(cls, pipe, x, frames, f: int, fmin: float, fmax: float,
                    own=None):
        """Ungated ``(f0, conf)``, ``(rows, f)`` each, of the rows of ``x``:
        one K2 launch over the concatenated rows views where K2 takes the
        geometry (row b's frame ``f``, which straddles rows b and b+1, is
        dropped), else the frames pitch of ``frames``. With ``own`` (each
        row's true frame count) ``frames`` holds only each row's own frames,
        and K2 runs only each row's own ``n + 1`` rows."""
        c = pipe.cfg
        per = x.shape[0]
        kw = pipe._pitch_kwargs(fmin, fmax)
        if f == 0 or c.frame_size != 2 * c.hop_size:
            f0, conf = pitch_from_frames(frames, c.sample_rate, fmin, fmax,
                                         acf_impl="dft", bases=kw["bases"])
            return cls._per_row(f0, per, f, own), cls._per_row(conf, per, f, own)
        hop = c.hop_size
        lag_min, lag_max = _lag_band(c.sample_rate, fmin, fmax, c.frame_size)
        merged, nyq_b, inv_live, inv_nyq = kw["bases"]
        k2 = dict(merged=merged, nyq_b=nyq_b, inv_live=inv_live,
                  inv_nyq=inv_nyq, lag_min=lag_min, lag_max=lag_max,
                  sample_rate=c.sample_rate)
        xr = x[:, : (f + 1) * hop].reshape(per, f + 1, hop)
        if own is None:
            out = fused_view_pitch(xr.reshape(per * (f + 1), hop), **k2)
            return tuple(torch.nn.functional.pad(t, (0, 1))
                         .reshape(per, f + 1)[:, :f] for t in out)
        # each row with frames: its n + 1 rows, one after another; the frame
        # at each row's end straddles two rows and is dropped
        if not any(own):  # only empty rows on this device
            z = x.new_zeros((per, f))
            return z, z.clone()
        out = fused_view_pitch(
            torch.cat([xr[r, : n + 1] for r, n in enumerate(own) if n]), **k2)
        starts = np.cumsum([0] + [n + 1 for n in own if n])
        return tuple(cls._per_row(torch.cat(
            [t[s : s + n] for s, n in zip(starts, (n for n in own if n))]),
            per, f, own) for t in out)

    # -- one long signal ----------------------------------------------------

    def _shards(self, rows: torch.Tensor, n: int):
        """The shard route's split of a ``(n+1, hop)`` rows view (a tensor
        on the first device): per device of the flattened mesh, ``(device,
        (fpb+1, hop) float32 rows on it)``, a contiguous block of ``fpb``
        frames plus its seam row (the next block's first row), with zero
        rows past the signal."""
        with span("sspv.mesh.shard"):
            devices = list(self.mesh.devices.flat)
            fpb = -(-n // len(devices))
            out = []
            for i, dev in enumerate(devices):
                t = rows[i * fpb : (i + 1) * fpb + 1].to(dev).to(torch.float32)
                if t.shape[0] < fpb + 1:
                    t = torch.nn.functional.pad(
                        t, (0, 0, 0, fpb + 1 - t.shape[0]))
                out.append((dev, t))
            return out

    def _gather(self, parts, n: int) -> torch.Tensor:
        with span("sspv.mesh.gather"):
            return torch.cat([t.to(self.pipe.device) for t in parts])[:n]

    def _long_kernel_feats(self, rows: torch.Tensor, n: int) -> dict:
        """K1 per device on its block of frames plus seam row
        (``mesh.py:304``); the features gathered to the first device and
        sliced to the true ``n`` frames."""
        parts = [self._pipes[dev]._features_from_rows(t)
                 for dev, t in self._shards(rows, n)]
        return {k: self._gather([p[k] for p in parts], n) for k in parts[0]}

    def _long_kernel_pitch(self, rows: torch.Tensor, n: int, fmin: float,
                           fmax: float):
        """K2 per device with the same decomposition (``mesh.py:367``):
        the ungated ``(f0, conf)``, ``(n,)`` each, on the first device."""
        c = self.pipe.cfg
        lag_min, lag_max = _lag_band(c.sample_rate, fmin, fmax, c.frame_size)
        parts = []
        for dev, t in self._shards(rows, n):
            merged, nyq_b, inv_live, inv_nyq = self._pipes[dev]._acf_bases(lag_max)
            parts.append(fused_view_pitch(
                t, merged=merged, nyq_b=nyq_b, inv_live=inv_live,
                inv_nyq=inv_nyq, lag_min=lag_min, lag_max=lag_max,
                sample_rate=c.sample_rate,
            ))
        return tuple(self._gather(ts, n) for ts in zip(*parts))

    def _long(self, signal, state):
        """Upload, route and features + VAD of :meth:`process_long`.
        Returns ``(block, state, x, rows, n)``: ``rows`` is the uploaded
        rows view on the shard route, else None."""
        p = self.pipe
        c = p.cfg
        sig = _as_transfer_dtype(signal)
        state = p.initial_state() if state is None else _on(state, p.device)
        length = int(sig.shape[0])
        n = 1 + (length - c.frame_size) // c.hop_size \
            if length >= c.frame_size else 0
        x = p._upload(sig)
        rows = None
        if p._view_geometry and n and self._long_kernel:
            rows = x[: (n + 1) * c.hop_size].reshape(n + 1, c.hop_size)
            feats = self._long_kernel_feats(rows, n)
        elif p._view_geometry and n:
            feats = p._view_features(x.to(torch.float32), n)
        else:
            feats = p._features(p._device_stream_frames(x))
        block, state = p._vad_full_length(feats, state, n)
        return block, state, x, rows, n

    def process_long(self, signal, state: vad_ops.VadState | None = None):
        """Features + VAD of one long signal (1-D host array or tensor;
        int16 stays int16 for the upload) with its frames over the whole
        mesh. Routes: the shard route (``long_kernel``), else the
        single-device view path, else (off the view geometry) device
        framing and K3; each then runs the padded blocked VAD
        (``_vad_full_length``) on the first device."""
        with span("sspv.mesh.process_long"):
            block, state, *_ = self._long(signal, state)
            return block, state

    def process_long_pitch(self, signal,
                           state: vad_ops.VadState | None = None,
                           fmin: float = 50.0, fmax: float = 400.0,
                           min_confidence: float = 0.3):
        """:meth:`process_long` plus the VAD-gated pitch track:
        ``(block, state, f0, conf)``. On the shard route the pitch runs K2
        per device on the same shards; otherwise it is the single-device
        ``pitch_track_signal_gated``. One gate either way:
        ``(vad > 0) & (conf >= min_confidence)``."""
        with span("sspv.mesh.process_long_pitch"):
            p = self.pipe
            block, state, x, rows, n = self._long(signal, state)
            if rows is None:
                f0, conf = pitch_track_signal_gated(
                    x, block.vad, min_confidence, **p._pitch_kwargs(fmin, fmax))
                return block, state, f0, conf
            f0u, conf = self._long_kernel_pitch(rows, n, fmin, fmax)
            with span("sspv.mesh.gate"):
                gate = (block.vad > 0) & (conf >= float(np.float32(
                    min_confidence)))
                f0 = torch.where(gate, f0u, torch.zeros_like(f0u))
            return block, state, f0, conf
