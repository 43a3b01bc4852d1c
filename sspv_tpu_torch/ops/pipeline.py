"""The frame -> features -> VAD -> pitch pipeline, in PyTorch.

Counterpart of ``sspv_tpu/ops/pipeline.py``. Two routes compute the same
per-frame features:

- the **signal view** (frame_size == 2*hop and a strictly positive window,
  the routing of the JAX package): the host forms the ``(n+1, hop)`` rows
  view of a signal (a free reshape) and ``fused_view_features`` (kernel K1
  on CUDA) computes every frame from it without forming the frame matrix;
- the **frames path** (every other geometry, and every entry point that
  takes raw frames: ``features``, ``process_block``, ``process_signal``,
  ``stream``, the packed block programs): ``fused_features`` (kernel K3 on
  CUDA) on materialized ``(F, frame_size)`` frames.

After either, ``fused_streaming_vad`` (kernel K4 on CUDA, the plain
``vad.streaming_vad`` on the CPU) runs the composite VAD once over the
call's frames (in the JAX package ``streaming_vad`` is no Pallas kernel but
XLA's fusion inside the jitted program; K4 takes its place).

Every entry point runs a signal or block at its own length. The JAX
package pads them to length buckets (``SIGNAL_BUCKET_SECONDS``,
``TPU_STREAM_BUCKETS``) and signals past ``SCAN_BLOCK_FRAMES`` frames to a
multiple of ``history_len``, to bound its compiles; PyTorch compiles
nothing, so the port pads nothing. What the padding decided besides the
shape stays: the order of the VAD's float64 window sums (blocked where the
padded frame count is a multiple of ``history_len``, else direct), which
each call computes on the host from the padded count it replaces
(``route_frames``) and hands to the VAD with each row's length.
``pitch_track_signal`` (kernel K2 on the rows view, or the Wiener-Khinchin
matmuls on frames) gives the F0 track, gated on the VAD.

On a CPU device the kernels' plain PyTorch versions run instead. K1 takes
any hop, but computes its spectrum by an FFT: it needs an ``n_fft`` that is
a power of two in 256..2048 no shorter than the frame, the bases this
configuration builds and a shared entropy spectrum. A view geometry without
them (the JAX package serves it with its XLA view path) takes the view
routes with K3 on the frames formed from the signal on the device. K2 takes
every view geometry.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from . import bases, fft_tables
from . import vad as vad_ops
from .frame_kernels import (dense_plan, fused_features, pack_dense_bases,
                            takes_fft_route)
from .pitch import _lag_band, acf_bases, pitch_track_gated, pitch_track_signal_gated
from .preprocessing import frame_signal, stream_frames
from .vad_kernels import fused_streaming_vad
from .view_kernels import fused_view_features
from .windows import get_window
from ..utils.framing import frame_i16_to_f32

__all__ = ["FeatureBlock", "FeatureConfig", "FeaturePipeline"]


class FeatureConfig(NamedTuple):
    """Static configuration of one pipeline: the fields and defaults of the
    JAX package's ``FeatureConfig``.

    ``use_pallas``, ``precision``, ``dft_layout``, ``view_layout`` and
    ``view_kernel`` choose TPU layouts and matmul passes there; the port
    keeps them for a like-for-like config but does not act on them: its
    kernels are fp32 whatever ``precision`` says, and on CUDA the kernels
    always run.
    """

    sample_rate: int = 16000
    frame_size: int = 320
    hop_size: int = 160
    window_type: str = "hamming"
    n_fft: int = 512
    entropy_n_fft: int = 512
    num_filters: int = 26
    num_ceps: int = 13
    lifter: int = 22
    energy_threshold: float = 1000.0
    zcr_threshold: float = 0.3
    entropy_voice_max: float = 0.65
    use_adaptive_vad: bool = True
    adaptive_alpha: float = 3.0  # clamped to 0.99 by the VAD
    adaptive_margin: float = 1.0  # opt-in; 1.0 is the reference semantics
    composite_mode: str = "or"  # opt-in "and"; "or" is the reference
    hangover_on: int = 3
    release_off: int = 2
    history_len: int = 256
    use_pallas: bool = True
    precision: str = "high"
    dft_layout: str = "merged"
    # "blocked" (two-level cumsums; direct window sums when the length is
    # not a multiple of history_len) or "conv" (direct window sums)
    vad_trailing_impl: str = "blocked"
    view_layout: str = "hop_phase"
    view_kernel: bool = True

    @classmethod
    def from_config(cls, config=None) -> "FeatureConfig":
        """The pipeline configuration of a ``Config`` class (default: the
        port's ``sspv_tpu_torch.config.Config``), as
        ``sspv_tpu/ops/pipeline.py:128-174`` reads it."""
        from ..config import Config

        c = config or Config
        return cls(
            sample_rate=int(c.SAMPLE_RATE),
            frame_size=int(c.FRAME_SIZE),
            hop_size=int(c.HOP_SIZE),
            window_type=str(c.WINDOW_TYPE),
            n_fft=int(c.MFCC_N_FFT),
            entropy_n_fft=int(c.SPECTRAL_ENTROPY_N_FFT),
            num_filters=int(c.MEL_FILTERS),
            num_ceps=int(c.NUM_MFCC),
            lifter=int(c.MFCC_LIFTER),
            energy_threshold=float(c.ENERGY_THRESHOLD),
            zcr_threshold=float(c.ZCR_THRESHOLD),
            entropy_voice_max=float(c.SPECTRAL_ENTROPY_VOICE_MAX),
            use_adaptive_vad=bool(c.USE_ADAPTIVE_VAD),
            adaptive_alpha=float(c.ADAPTIVE_VAD_ENERGY_K),
            adaptive_margin=float(
                getattr(c, "VAD_ADAPTIVE_ENERGY_MARGIN", 1.0) or 1.0
            ),
            composite_mode=str(
                getattr(c, "VAD_COMPOSITE_MODE", "or") or "or"
            ).lower(),
            hangover_on=int(c.VAD_HANGOVER_ON),
            release_off=int(c.VAD_RELEASE_OFF),
            history_len=int(getattr(c, "VAD_HISTORY_LEN", 256)),
            use_pallas=bool(getattr(c, "TPU_USE_PALLAS", True)),
            precision=str(
                getattr(c, "TPU_MATMUL_PRECISION", "highest") or "highest"
            ).lower(),
            dft_layout=str(
                getattr(c, "TPU_DFT_LAYOUT", "merged") or "merged"
            ).lower(),
            vad_trailing_impl=str(
                getattr(c, "TPU_VAD_TRAILING_IMPL", "blocked") or "blocked"
            ).lower(),
            view_layout=str(
                getattr(c, "TPU_VIEW_LAYOUT", "hop_phase") or "hop_phase"
            ).lower(),
            view_kernel=bool(getattr(c, "TPU_VIEW_KERNEL", True)),
        )


class FeatureBlock(NamedTuple):
    """Per-frame outputs of one processed block (tensors on the device, or
    host arrays after :meth:`FeaturePipeline.split_packed_block`)."""

    energy: torch.Tensor  # (F,) f32
    zcr: torch.Tensor  # (F,) f32
    entropy: torch.Tensor  # (F,) f32
    mfcc: torch.Tensor  # (F, num_ceps) f32
    vad: torch.Tensor  # (F,) i32 smoothed composite decision
    vad_adaptive: torch.Tensor  # (F,) i32


# Keys of constants() / load_constants(): the feature bases, named after the
# JAX pipeline's attributes without the underscore (``wm``/``wnyq`` exist
# for an even n_fft, ``wc_ent``/``ws_ent`` for a separate entropy spectrum),
# and the ACF bases of the default pitch band
# (time_features._acf_dft_bases_merged).
FEATURE_CONSTANTS = ("window", "wc", "ws", "wm", "wnyq", "fb_t", "dct",
                     "lifter", "wc_ent", "ws_ent")
ACF_CONSTANTS = ("acf_merged", "acf_nyq", "acf_inv_live", "acf_inv_nyq")


def _view_unsupported(cfg: FeatureConfig, standard_bases: bool) -> str | None:
    """Why the view features kernel cannot take this view geometry, or
    None. ``standard_bases``: the loaded window and merged DFT bases are
    the ones ``cfg`` builds (the kernel computes their spectrum by an FFT)."""
    if fft_tables.fft_route_size(cfg.frame_size, cfg.n_fft) is None:
        return (f"n_fft {cfg.n_fft} is not a power of two in "
                f"{fft_tables.FFT_SIZES[0]}..{fft_tables.FFT_SIZES[-1]} no "
                f"shorter than the frame ({cfg.frame_size})")
    if cfg.entropy_n_fft != cfg.n_fft:
        return f"entropy_n_fft {cfg.entropy_n_fft} != n_fft {cfg.n_fft}"
    if not standard_bases:
        return "the loaded window/wm/wnyq are not this configuration's"
    return None


class FeaturePipeline:
    """Configured frame -> feature -> VAD -> pitch pipeline on one device,
    the card unless the caller asks for another (``device="cpu"``)."""

    # Frames past which the JAX package runs the VAD over the gate vectors
    # padded to a multiple of history_len: such a call takes the blocked
    # order of the window sums here too (_vad_route).
    SCAN_BLOCK_FRAMES = 32768
    # The JAX package's length buckets (seconds) of the *_auto entry points.
    # The port runs every signal at its own length; a signal's bucket sets
    # only the order of its VAD's window sums (_auto_frames). Serve caps a
    # request at the largest and warms up at their sizes.
    SIGNAL_BUCKET_SECONDS = (2, 8, 32, 128, 512, 2048)
    # Column layout of the packed feature block (frozen; split_packed_block
    # is the inverse): 0 energy, 1 zcr, 2 entropy, 3 vad, 4 vad_adaptive,
    # 5: mfcc (num_ceps); the pitch programs append f0 and confidence.
    PACKED_PREFIX_COLS = 5

    def __init__(self, cfg: FeatureConfig | None = None, *, device="cuda"):
        self.device = torch.device(device)
        self.cfg = cfg or FeatureConfig()
        if self.cfg.num_ceps > self.cfg.num_filters:
            # a length-N DCT-II has exactly N coefficients
            self.cfg = self.cfg._replace(num_ceps=self.cfg.num_filters)
        c = self.cfg
        window = get_window(c.window_type, c.frame_size)
        # the JAX package's routing: the view path serves frame == 2*hop
        # with a strictly positive window (sign(x*w) == sign(x)), the
        # frames path everything else
        self._view_geometry = (c.frame_size == 2 * c.hop_size
                               and bool(np.all(window > 0)))
        consts = {"window": window}
        consts["wc"], consts["ws"] = bases.windowed_dft_bases(
            c.frame_size, c.n_fft, c.window_type
        )
        if c.n_fft % 2 == 0:
            consts["wm"], consts["wnyq"] = bases.merged_windowed_dft_bases(
                c.frame_size, c.n_fft, c.window_type
            )
        if c.entropy_n_fft != c.n_fft:
            consts["wc_ent"], consts["ws_ent"] = bases.windowed_dft_bases(
                c.frame_size, c.entropy_n_fft, c.window_type
            )
        consts["fb_t"] = bases.mel_filterbank_np(
            c.num_filters, c.n_fft, c.sample_rate
        ).T.copy()
        consts["dct"] = bases.dct_ortho_matrix(c.num_filters, c.num_ceps)
        consts["lifter"] = bases.lifter_vector(c.num_ceps, c.lifter)
        self._wm = self._wnyq = self._wc_ent = self._ws_ent = None
        # host copies of what chooses and feeds the kernels' FFT routes
        self._host_consts = dict.fromkeys(("window", "wc", "ws", "wm", "wnyq",
                                           "fb_t"))
        self._acf: dict[int, tuple] = {}
        self._acf_lock = threading.Lock()
        self.load_constants(consts)

    # -- constants ----------------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    def load_constants(self, consts: dict) -> None:
        """Take bases from a dict of arrays (keys ``FEATURE_CONSTANTS`` and,
        optionally, ``ACF_CONSTANTS``), e.g. the JAX pipeline's ``_window``,
        ``_wc``, ... and ``_acf_dft_bases_merged``; missing keys and ``None``
        values keep their value."""
        for k in FEATURE_CONSTANTS:
            if consts.get(k) is not None:
                setattr(self, "_" + k, self._tensor(consts[k]))
                if k in self._host_consts:
                    self._host_consts[k] = np.asarray(consts[k], np.float32)
        if all(k in consts for k in ACF_CONSTANTS):
            acf = tuple(self._tensor(consts[k]) for k in ACF_CONSTANTS)
            self._acf[acf[2].shape[1] - 1] = acf
        c = self.cfg
        mel_ranges = torch.from_numpy(fft_tables.mel_ranges(
            self._host_consts["fb_t"])).to(self.device)
        wc, ws = bases.windowed_dft_bases(c.frame_size, c.n_fft, c.window_type)
        n_fft = c.n_fft if self._loaded_equal(wc=wc, ws=ws) else None
        # K3's dense route reads the loaded wc/ws packed (3xTF32 halves, in
        # fragment order); built here once for each set of bases it serves,
        # from their host copies
        frame, n_bins = self._wc.shape
        dense_bases = None
        if (not takes_fft_route(frame, n_bins, n_fft)
                and dense_plan(frame, n_bins) is not None):
            dense_bases = pack_dense_bases(
                self._host_consts["wc"], self._host_consts["ws"]).to(self.device)
        self._frame_consts = dict(
            window=self._window, wc=self._wc, ws=self._ws, fb_t=self._fb_t,
            dct=self._dct, lifter=self._lifter,
            entropy_bases=(self._wc_ent, self._ws_ent),
            n_fft=n_fft, mel_ranges=mel_ranges, dense_bases=dense_bases,
        )
        self._view_consts = None
        # K1 takes the view geometry only without _view_unsupported's gaps
        self._view_kernel_ok = False
        if self._wm is not None and c.n_fft % 2 == 0:
            wm, wnyq = bases.merged_windowed_dft_bases(
                c.frame_size, c.n_fft, c.window_type)
            standard = self._loaded_equal(wm=wm, wnyq=wnyq)
            self._view_consts = dict(
                w2=self._window * self._window, wm=self._wm, wnyq=self._wnyq,
                fb_t=self._fb_t, dct=self._dct, lifter=self._lifter,
                window=self._window, n_fft=c.n_fft if standard else None,
                mel_ranges=mel_ranges,
            )
            self._view_kernel_ok = (self._view_geometry and
                                    _view_unsupported(c, standard) is None)

    def _loaded_equal(self, **want) -> bool:
        """Whether the loaded window and the named loaded bases are the ones
        this configuration builds, bit for bit (a kernel may then compute
        the same spectrum by an FFT of ``cfg.n_fft`` points)."""
        c = self.cfg
        want["window"] = get_window(c.window_type, c.frame_size)
        return all(np.array_equal(self._host_consts[k],
                                  np.asarray(v, np.float32))
                   for k, v in want.items())

    def constants(self) -> dict:
        """The pipeline's bases as NumPy arrays, with the ACF bases of the
        default 50-400 Hz pitch band."""
        out = {k: getattr(self, "_" + k).cpu().numpy()
               for k in FEATURE_CONSTANTS if getattr(self, "_" + k) is not None}
        acf = self._acf_bases(self._lag_max(50.0, 400.0))
        out.update((k, t.cpu().numpy()) for k, t in zip(ACF_CONSTANTS, acf))
        return out

    def _lag_max(self, fmin: float, fmax: float) -> int:
        c = self.cfg
        return _lag_band(c.sample_rate, fmin, fmax, c.frame_size)[1]

    def _acf_bases(self, lag_max: int) -> tuple:
        with self._acf_lock:  # request threads of a server share the cache
            if lag_max not in self._acf:
                self._acf[lag_max] = acf_bases(self.cfg.frame_size, lag_max,
                                               self.device)
            return self._acf[lag_max]

    # -- host side ----------------------------------------------------------

    def initial_state(self) -> vad_ops.VadState:
        c = self.cfg
        return vad_ops.initial_vad_state(
            c.history_len, c.hangover_on, device=self.device
        )

    def initial_packed_state(self) -> np.ndarray:
        return vad_ops.initial_packed_state(
            self.cfg.history_len, self.cfg.hangover_on
        )

    def supports_samples_dispatch(self) -> bool:
        """Whether the engine may ship raw samples (the view routes frame
        them on the device) instead of frames: the view geometry, as in the
        JAX package."""
        return self._view_geometry

    def host_rows_view(self, sig: np.ndarray) -> np.ndarray | None:
        """``(n+1, hop)`` rows view of a 1-D host signal, a free reshape of
        its first ``(n+1)*hop`` samples, in the view geometry; ``None``
        otherwise or without a full frame."""
        c = self.cfg
        if not self._view_geometry or sig.ndim != 1 or len(sig) < c.frame_size:
            return None
        n = 1 + (len(sig) - c.frame_size) // c.hop_size
        return sig[: (n + 1) * c.hop_size].reshape(n + 1, c.hop_size)

    def stream_frames(self, samples) -> np.ndarray:
        """Streaming framing on the host: only full frames, no tail padding
        (engine.py:240-242 semantics). Returns raw float32 frames."""
        c = self.cfg
        samples = np.asarray(samples)
        if samples.dtype == np.int16:
            return frame_i16_to_f32(samples, c.frame_size, c.hop_size)
        n = len(samples)
        if n < c.frame_size:
            return np.zeros((0, c.frame_size), dtype=np.float32)
        f = 1 + (n - c.frame_size) // c.hop_size
        idx = (np.arange(c.frame_size)[None, :]
               + np.arange(f)[:, None] * c.hop_size)
        return samples.astype(np.float32)[idx]

    @staticmethod
    def _host_signal(signal) -> np.ndarray:
        """int16 stays int16 (half the upload bytes); anything else float32."""
        if isinstance(signal, torch.Tensor):
            signal = signal.cpu().numpy()
        sig = np.asarray(signal)
        return sig if sig.dtype == np.int16 else sig.astype(np.float32, copy=False)

    def _upload(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:  # e.g. a view of a JAX array
            a = a.copy()
        return torch.from_numpy(a).to(self.device)

    def _frames_on_device(self, frames) -> torch.Tensor:
        return self._upload(frames).to(torch.float32)

    def _auto_frames(self, n_samples: int) -> int:
        """The frames the JAX package's *_auto call of ``n_samples``
        samples runs: those of the smallest ``SIGNAL_BUCKET_SECONDS``
        bucket that holds the signal, or beyond the largest, of the next
        multiple of it (``sspv_tpu/ops/pipeline.py:1052-1090``). The port
        runs the signal's own frames and takes this count's VAD order."""
        c = self.cfg
        sr = c.sample_rate
        target = next((s * sr for s in self.SIGNAL_BUCKET_SECONDS
                       if n_samples <= s * sr), None)
        if target is None:
            quantum = self.SIGNAL_BUCKET_SECONDS[-1] * sr
            target = -(-n_samples // quantum) * quantum
        return 1 + (target - c.frame_size) // c.hop_size

    def _vad_route(self, n: int) -> int:
        """The frame count whose window-sum order the VAD of an ``n``-frame
        signal call takes: ``n`` up to ``SCAN_BLOCK_FRAMES``, past it ``n``
        rounded up to a multiple of ``history_len`` (the JAX package pads
        the gate vectors of such a call to one: the blocked order)."""
        if n <= self.SCAN_BLOCK_FRAMES:
            return n
        h = self.cfg.history_len
        return -(-n // h) * h

    # -- device side --------------------------------------------------------

    def _features(self, frames: torch.Tensor) -> dict:
        """Per-frame features of raw ``(F, frame_size)`` frames (K3 on
        CUDA, for every F >= 1)."""
        return fused_features(frames.to(torch.float32), **self._frame_consts)

    def _features_from_rows(self, rows: torch.Tensor) -> dict:
        """Per-frame features of a ``(F+1, hop)`` rows view (K1 on CUDA)."""
        return fused_view_features(rows, **self._view_consts)

    def _view_features(self, x: torch.Tensor, n: int) -> dict:
        """Features of the first ``n`` frames of a view-geometry signal
        (float32 1-D samples or the ``(n+1, hop)`` rows view, on the
        device): K1 on the rows view, or in a view geometry K1 does not take
        (``_view_unsupported``), K3 on the frames formed on the device."""
        hop = self.cfg.hop_size
        if self._view_kernel_ok:
            rows = x if x.dim() == 2 else x[: (n + 1) * hop].reshape(n + 1, hop)
            return self._features_from_rows(rows)
        flat = x.reshape(-1)[: (n + 1) * hop]
        return self._features(self._device_stream_frames(flat))

    def _device_stream_frames(self, signal: torch.Tensor) -> torch.Tensor:
        return stream_frames(signal, self.cfg.frame_size, self.cfg.hop_size)

    def _vad_kwargs(self) -> dict:
        """The configuration's keywords of ``streaming_vad``."""
        c = self.cfg
        return dict(
            energy_threshold=c.energy_threshold,
            zcr_threshold=c.zcr_threshold,
            entropy_voice_max=c.entropy_voice_max,
            use_adaptive=c.use_adaptive_vad,
            adaptive_alpha=c.adaptive_alpha,
            adaptive_margin=c.adaptive_margin,
            composite_mode=c.composite_mode,
            hangover_on=c.hangover_on,
            release_off=c.release_off,
            history_len=c.history_len,
            trailing_impl=c.vad_trailing_impl,
        )

    def _vad_core(self, energy, zcr, entropy, state, valid, lengths=None,
                  route_frames=None):
        """The composite VAD (K4 on CUDA) of ``(f,)`` or ``(B, f)``
        features with the matching state and a mask, or each row's length
        (an int or a ``(B,)`` int32 tensor on the device), in the window-sum
        order of ``route_frames`` frames (default ``f``)."""
        return fused_streaming_vad(energy, zcr, entropy, state, valid=valid,
                                   lengths=lengths, route_frames=route_frames,
                                   **self._vad_kwargs())

    def _vad_stage(self, feats: dict, state, valid, lengths=None,
                   route_frames=None):
        """The composite VAD over computed features (see
        :meth:`_vad_core`)."""
        vad, vad_adaptive, new_state = self._vad_core(
            feats["energy"], feats["zcr"], feats["entropy"], state, valid,
            lengths, route_frames,
        )
        return FeatureBlock(vad=vad, vad_adaptive=vad_adaptive, **feats), new_state

    def _vad_full_length(self, feats: dict, state, n: int, true_n=None):
        """The VAD of a signal call past ``SCAN_BLOCK_FRAMES``: one pass
        over its ``n`` frames (the first ``true_n`` valid) in the blocked
        order of ``n`` padded to a multiple of history_len, where the JAX
        package pads the gate vectors; nothing is padded here."""
        return self._vad_stage(feats, state, None, lengths=true_n,
                               route_frames=-(-n // self.cfg.history_len)
                               * self.cfg.history_len)

    def _empty_block(self) -> FeatureBlock:
        z = torch.zeros(0, dtype=torch.float32, device=self.device)
        zi = torch.zeros(0, dtype=torch.int32, device=self.device)
        return FeatureBlock(
            energy=z, zcr=z, entropy=z,
            mfcc=torch.zeros((0, self.cfg.num_ceps), device=self.device),
            vad=zi, vad_adaptive=zi,
        )

    def _process_block_impl(self, frames: torch.Tensor, state, valid,
                            lengths=None, route_frames=None):
        return self._vad_stage(self._features(frames), state, valid, lengths,
                               route_frames)

    def _process_signal_view_impl(self, signal: torch.Tensor, state, n: int,
                                  true_n: int | None = None,
                                  route_frames: int | None = None):
        """Features + VAD of the first ``n`` frames of ``signal`` (1-D
        samples or the ``(n+1, hop)`` rows view, on the device). ``true_n``
        marks the real frame count of a caller's padded signal: frames
        beyond it are masked out of the VAD state. ``route_frames``: the
        frame count of the padded call this one replaces (default ``n``),
        whose VAD order it takes (:meth:`_vad_route`)."""
        x = signal.to(torch.float32)
        feats = self._view_features(x, n)
        return self._vad_stage(
            feats, state, None, lengths=true_n,
            route_frames=self._vad_route(n if route_frames is None
                                         else route_frames))

    def _process_signal_impl(self, signal: torch.Tensor, state):
        """``sspv_tpu/ops/pipeline.py:942-994``: the view path for a rows
        view or a view-geometry signal, else device framing and the frames
        path (exact-length VAD up to ``SCAN_BLOCK_FRAMES`` frames, else K3
        over all frames and one full-length VAD)."""
        c = self.cfg
        if signal.dim() == 2:
            if not self._view_geometry or signal.shape[1] != c.hop_size:
                raise ValueError(f"a rows view must be (n+1, {c.hop_size}) "
                                 f"in the view geometry, got "
                                 f"{tuple(signal.shape)}")
            return self._process_signal_view_impl(
                signal, state, signal.shape[0] - 1
            )
        if self._view_geometry and signal.shape[0] >= c.frame_size:
            n = 1 + (signal.shape[0] - c.frame_size) // c.hop_size
            return self._process_signal_view_impl(signal, state, n)
        frames = self._device_stream_frames(signal)
        f = frames.shape[0]
        if f == 0:
            return self._empty_block(), state
        return self._process_block_impl(frames, state, None,
                                        route_frames=self._vad_route(f))

    # -- public API: frames ---------------------------------------------------

    def features(self, frames_raw) -> dict:
        """Per-frame features of raw ``(F, frame_size)`` frames."""
        return self._features(self._frames_on_device(frames_raw))

    def process_block(self, frames_raw, state, valid=None):
        """One streaming block of raw frames with carried VAD state.
        ``valid`` may mark a padded tail (bucketed shapes); None means all
        frames valid. Returns ``(FeatureBlock, VadState)``."""
        if valid is not None:
            valid = torch.as_tensor(valid, device=self.device)
        return self._process_block_impl(
            self._frames_on_device(frames_raw), state, valid
        )

    def process_signal(self, signal, state=None, pad_tail: bool = False):
        """Offline batch path: frame a whole 1-D signal and process it as
        one block. ``pad_tail=True`` uses the batch framing contract
        (zero-padded tail); False matches the streaming engine (drop tail)."""
        c = self.cfg
        sig = np.asarray(signal)
        if pad_tail:
            frames = frame_signal(self._upload(sig.astype(np.float32)),
                                  c.frame_size, c.hop_size)
        else:
            frames = self.stream_frames(sig)
        if state is None:
            state = self.initial_state()
        if int(frames.shape[0]) == 0:
            return self._empty_block(), state
        return self.process_block(frames, state)

    # -- public API: whole signals ------------------------------------------

    def process_signal_device(self, signal, state=None):
        """Features + VAD of a whole signal on the device. ``signal`` is a
        host array (uploaded as its rows view in the view geometry, else
        1-D; int16 stays int16 and casts on the device) or a tensor of
        samples or rows (moved to the pipeline's device). Returns
        ``(FeatureBlock, VadState)``."""
        if state is None:
            state = self.initial_state()
        if isinstance(signal, torch.Tensor):
            sig = signal.to(self.device)
            if sig.dtype not in (torch.int16, torch.float32):
                sig = sig.to(torch.float32)
        else:
            host = self._host_signal(signal)
            rows = self.host_rows_view(host)
            sig = self._upload(host if rows is None else rows)
        return self._process_signal_impl(sig, state)

    def process_signal_auto(self, signal, state=None):
        """Like :meth:`process_signal_device`, for a host signal: the JAX
        package's bucketed call, run at the signal's own length with the
        VAD order of its bucket (:meth:`_auto_frames`), so its block and
        state are the bucketed call's. Frames geometries run
        :meth:`process_signal_device`, as in the JAX package."""
        sig = self._host_signal(signal)
        if state is None:
            state = self.initial_state()
        c = self.cfg
        if not self._view_geometry or len(sig) < c.frame_size:
            return self.process_signal_device(sig, state)
        rows = self.host_rows_view(sig)
        return self._process_signal_view_impl(
            self._upload(rows), state, rows.shape[0] - 1,
            route_frames=self._auto_frames(len(sig)))

    def _pitch_kwargs(self, fmin: float, fmax: float) -> dict:
        c = self.cfg
        return dict(
            frame_size=c.frame_size, hop_size=c.hop_size,
            sample_rate=c.sample_rate, fmin=fmin, fmax=fmax,
            acf_impl="dft",
            bases=self._acf_bases(self._lag_max(fmin, fmax)),
        )

    def process_signal_pitch_auto(self, signal, state=None, fmin: float = 50.0,
                                  fmax: float = 400.0,
                                  min_confidence: float = 0.3):
        """Features + VAD + VAD-gated pitch of a host signal at its own
        length, with the same outputs as :meth:`process_signal_auto`
        followed by :meth:`pitch_signal_auto` (which frames geometries and
        sub-frame inputs run). Returns ``(block, state, f0, conf)`` with
        ``f0``/``conf`` host arrays of the block's length."""
        sig = self._host_signal(signal)
        if state is None:
            state = self.initial_state()
        c = self.cfg
        if not self._view_geometry or len(sig) < c.frame_size:
            block, new_state = self.process_signal_auto(sig, state)
            f0, conf = self.pitch_signal_auto(
                sig, block.vad, fmin=fmin, fmax=fmax,
                min_confidence=min_confidence,
            )
            return block, new_state, f0, conf
        host_rows = self.host_rows_view(sig)
        rows = self._upload(host_rows)
        block, new_state = self._process_signal_view_impl(
            rows, state, host_rows.shape[0] - 1,
            route_frames=self._auto_frames(len(sig)))
        f0, conf = pitch_track_signal_gated(
            rows, block.vad, min_confidence, **self._pitch_kwargs(fmin, fmax)
        )
        return block, new_state, f0.cpu().numpy(), conf.cpu().numpy()

    def pitch_signal_auto(self, signal, vad, fmin: float = 50.0,
                          fmax: float = 400.0, min_confidence: float = 0.3):
        """VAD-gated pitch track of a host signal, the first ``len(vad)``
        frames of the JAX package's bucketed call: pitch is frame-local, so
        only those frames run. A ``vad`` one frame longer than the signal's
        frames (ceil-framed) reads that frame's missing samples as zeros, as
        the bucket's padding did; past the bucket's frames (a signal that
        fills it) f0 and conf are 0. Returns host ``(f0, conf)`` of
        ``len(vad)``."""
        c = self.cfg
        sig = self._host_signal(signal)
        vad = vad.cpu().numpy() if isinstance(vad, torch.Tensor) else np.asarray(vad)
        n = int(vad.shape[0])
        if len(sig) < c.frame_size or n == 0:
            z = np.zeros((0,), np.float32)
            return z, z
        m = min(n, self._auto_frames(len(sig)))
        need = (m - 1) * c.hop_size + c.frame_size  # samples of m frames
        sig = sig[:need] if len(sig) >= need else np.pad(
            sig, (0, need - len(sig)))
        rows = self.host_rows_view(sig)
        f0, conf = pitch_track_signal_gated(
            self._upload(sig if rows is None else rows),
            vad[:m].astype(np.int32), min_confidence,
            **self._pitch_kwargs(fmin, fmax),
        )
        f0, conf = f0.cpu().numpy(), conf.cpu().numpy()
        if n > m:
            f0 = np.pad(f0, (0, n - m))
            conf = np.pad(conf, (0, n - m))
        return f0, conf

    # -- streaming ----------------------------------------------------------

    def stream(self, chunks, state=None, buckets: tuple[int, ...] | None = None):
        """Generator over an iterable of 1-D sample chunks (any dtype):
        carries the overlap tail and VadState across chunks and yields a
        ``FeatureBlock`` per chunk that completed >= 1 frame. Blocks larger
        than the top of ``buckets`` (default ``Config.TPU_STREAM_BUCKETS``)
        are split there; each block runs at its own frame count with the
        VAD order of its bucket, the shape the JAX package pads it to."""
        def dispatch(part, st, bucket):
            block, new_state = self._process_block_impl(
                self._frames_on_device(part), st, None, route_frames=bucket)
            return new_state, (block,)

        for (block,) in self._stream_core(chunks, state, buckets, dispatch):
            yield block

    def stream_pitch(self, chunks, state=None,
                     buckets: tuple[int, ...] | None = None,
                     fmin: float = 50.0, fmax: float = 400.0,
                     min_confidence: float = 0.3):
        """:meth:`stream` plus a VAD-gated F0 track: yields
        ``(FeatureBlock, f0, conf)`` per block (``f0``/``conf`` host
        arrays). The blocks equal :meth:`stream`'s (one shared
        ``_stream_core``)."""
        def dispatch(part, st, bucket):
            frames = self._frames_on_device(part)
            block, new_state = self._process_block_impl(
                frames, st, None, route_frames=bucket)
            f0, conf = self._gated_frames_pitch(frames, block.vad,
                                                min_confidence, fmin, fmax)
            return new_state, (block, f0.cpu().numpy(), conf.cpu().numpy())

        yield from self._stream_core(chunks, state, buckets, dispatch)

    def _stream_core(self, chunks, state, buckets, dispatch):
        """Carry/framing/splitting loop shared by :meth:`stream` and
        :meth:`stream_pitch` (``pipeline.py:1387-1423``, which pads each
        block to its bucket). ``dispatch(part, state, bucket) -> (new_state,
        outputs)``, ``bucket`` the smallest of ``buckets`` that holds the
        block; yields ``outputs``."""
        c = self.cfg
        if buckets is None:
            from ..config import Config, parse_buckets

            buckets = parse_buckets(
                getattr(Config, "TPU_STREAM_BUCKETS", (32, 256, 2048))
            )
        if state is None:
            state = self.initial_state()
        carry = np.zeros((0,), dtype=np.float32)
        top = buckets[-1]
        for chunk in chunks:
            chunk = np.asarray(chunk)
            carry = np.concatenate([carry, chunk.astype(np.float32)])
            frames = self.stream_frames(carry)
            n = frames.shape[0]
            if n == 0:
                continue
            carry = carry[n * c.hop_size :]
            for lo in range(0, n, top):
                part = frames[lo : lo + top]
                bucket = next(b for b in buckets if part.shape[0] <= b)
                state, outputs = dispatch(part, state, bucket)
                yield outputs

    # -- packed programs (the engine's dispatches) --------------------------

    def _pack_block(self, block: FeatureBlock) -> torch.Tensor:
        """One ``(F, PACKED_PREFIX_COLS + num_ceps)`` f32 matrix, the single
        packer of every packed program (vad values 0/1 cast exactly)."""
        return torch.cat([
            block.energy[:, None], block.zcr[:, None], block.entropy[:, None],
            block.vad.to(torch.float32)[:, None],
            block.vad_adaptive.to(torch.float32)[:, None],
            block.mfcc,
        ], dim=1)

    def _pack_block_pitch(self, block: FeatureBlock, f0, conf) -> torch.Tensor:
        return torch.cat([self._pack_block(block), f0[:, None], conf[:, None]],
                         dim=1)

    def _gated_frames_pitch(self, frames, gate_vad, min_conf: float,
                            fmin: float = 50.0, fmax: float = 400.0):
        """The frames-path Wiener-Khinchin pitch track with the confidence
        gate: the pitch tail of the packed pitch programs (50-400 Hz,
        ``pipeline.py:568``) and of :meth:`stream_pitch`."""
        return pitch_track_gated(
            frames, gate_vad, min_conf, sample_rate=self.cfg.sample_rate,
            fmin=fmin, fmax=fmax, acf_impl="dft",
        )

    @staticmethod
    def _gate_to(vad: torch.Tensor, n: int) -> torch.Tensor:
        """``vad`` with the frames from ``n`` on (a caller's padding) off:
        the VAD that gates a padded block's pitch."""
        if n >= vad.shape[0]:
            return vad
        idx = torch.arange(vad.shape[0], device=vad.device)
        return torch.where(idx < n, vad, torch.zeros_like(vad))

    def _packed_block_core(self, frames_raw, packed_state, n_valid: int,
                           route_frames: int | None):
        state = vad_ops.unpack_state(self._upload(packed_state),
                                     self.cfg.history_len)
        frames = self._frames_on_device(frames_raw)
        n = int(n_valid)
        block, new_state = self._process_block_impl(
            frames, state, None, lengths=n if n < frames.shape[0] else None,
            route_frames=route_frames)
        return block, new_state, frames, n

    def process_block_packed(self, frames_raw, packed_state, n_valid: int,
                             route_frames: int | None = None):
        """A streaming block with single-buffer I/O: raw frames and the
        packed state in, one ``(F, 5 + num_ceps)`` block and the new packed
        state out (both on the device). Equal to :meth:`process_block` with
        the first ``n_valid`` frames valid; split with
        :meth:`split_packed_block`. ``route_frames``: the frame count of
        the JAX package's call this one stands for (the engine's bucket of
        an unpadded block), whose VAD order it takes; default ``F``."""
        block, new_state, _, _ = self._packed_block_core(
            frames_raw, packed_state, n_valid, route_frames
        )
        return self._pack_block(block), vad_ops.pack_state(new_state)

    def process_block_packed_pitch(self, frames_raw, packed_state,
                                   n_valid: int, min_confidence: float,
                                   route_frames: int | None = None):
        """:meth:`process_block_packed` plus the VAD-gated F0 track: one
        ``(F, 7 + num_ceps)`` block (f0 and confidence appended)."""
        block, new_state, frames, n = self._packed_block_core(
            frames_raw, packed_state, n_valid, route_frames
        )
        f0, conf = self._gated_frames_pitch(frames, self._gate_to(block.vad, n),
                                            min_confidence)
        return (self._pack_block_pitch(block, f0, conf),
                vad_ops.pack_state(new_state))

    def _packed_signal_core(self, samples, packed_state, true_len: int,
                            route_frames: int | None):
        c = self.cfg
        state = vad_ops.unpack_state(self._upload(packed_state), c.history_len)
        if isinstance(samples, torch.Tensor):
            x = samples.to(self.device, torch.int16)
        else:
            x = self._upload(np.asarray(samples, dtype=np.int16))
        x = x.to(torch.float32)
        n = 1 + (x.shape[0] - c.frame_size) // c.hop_size
        true_len = int(true_len)
        true_n = (1 + (true_len - c.frame_size) // c.hop_size
                  if true_len >= c.frame_size else 0)
        block, new_state = self._process_signal_view_impl(
            x, state, n, true_n=true_n if true_n < n else None,
            route_frames=route_frames,
        )
        return block, new_state, x, true_n

    def process_signal_packed(self, samples, packed_state, true_len: int,
                              route_frames: int | None = None):
        """Raw int16 SAMPLES in (the engine's default dispatch), framed on
        the device through the view path (K1 on CUDA); frames beyond
        ``true_len`` samples (a caller's padding) are masked out of the
        carried state. ``route_frames`` as in :meth:`process_block_packed`.
        Needs :meth:`supports_samples_dispatch`; a view geometry K1 does
        not take runs K3 on the frames formed on the device."""
        block, new_state, *_ = self._packed_signal_core(
            samples, packed_state, true_len, route_frames
        )
        return self._pack_block(block), vad_ops.pack_state(new_state)

    def process_signal_packed_pitch(self, samples, packed_state,
                                    true_len: int, min_confidence: float,
                                    route_frames: int | None = None):
        """:meth:`process_signal_packed` plus the VAD-gated F0 track, on the
        frame matrix formed on the device from the same samples."""
        block, new_state, x, true_n = self._packed_signal_core(
            samples, packed_state, true_len, route_frames
        )
        frames = self._device_stream_frames(x)
        f0, conf = self._gated_frames_pitch(
            frames, self._gate_to(block.vad, true_n), min_confidence)
        return (self._pack_block_pitch(block, f0, conf),
                vad_ops.pack_state(new_state))

    @staticmethod
    def _host_rows(packed, n: int) -> np.ndarray:
        if isinstance(packed, torch.Tensor):
            packed = packed.cpu().numpy()
        return np.asarray(packed)[:n]

    def split_packed_block(self, packed_host, n: int) -> FeatureBlock:
        """Host-side split of a fetched packed block (first ``n`` rows)."""
        p = self._host_rows(packed_host, n)
        return FeatureBlock(
            energy=p[:, 0], zcr=p[:, 1], entropy=p[:, 2],
            vad=p[:, 3].astype(np.int32), vad_adaptive=p[:, 4].astype(np.int32),
            mfcc=p[:, self.PACKED_PREFIX_COLS :],
        )

    def split_packed_block_pitch(self, packed_host, n: int):
        """Host-side split of a pitch-enabled packed block: the FeatureBlock
        plus the two appended columns ``(f0, confidence)``."""
        p = self._host_rows(packed_host, n)
        return self.split_packed_block(p[:, :-2], n), p[:, -2], p[:, -1]
