"""The offline signal path: rows view -> fused features -> composite VAD ->
VAD-gated pitch, in PyTorch.

Counterpart of ``sspv_tpu/ops/pipeline.py`` for its signal-view path. For a
signal in the 50%-overlap geometry (frame_size == 2*hop) the host forms the
``(n+1, hop)`` rows view (a free reshape), uploads it to the pipeline's
device (int16 stays int16 and casts on the device), and then:

- ``fused_view_features`` (kernel K1 on CUDA) computes energy, zcr, entropy
  and mfcc of every frame in one sweep;
- ``streaming_vad`` (tensor ops) runs the composite VAD: exact-length for
  ``n <= SCAN_BLOCK_FRAMES``, else once over the gate vectors padded to a
  multiple of ``history_len`` under a ``valid`` mask, exactly the branches of
  the JAX package;
- ``pitch_track_signal`` (kernel K2 on CUDA) gives the ungated F0 track,
  gated on the VAD.

On a CPU device the kernels' plain PyTorch versions run instead. Other
geometries (frame_size != 2*hop, hop not a multiple of 4, odd n_fft, a
separate entropy spectrum, a window with zeros) need the frames path and
raise ``NotImplementedError`` on every device: it is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import bases
from . import vad as vad_ops
from .pitch import _lag_band, acf_bases, pitch_track_signal_gated
from .view_kernels import fused_view_features
from .windows import get_window

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


class FeatureBlock(NamedTuple):
    """Per-frame outputs of one processed signal (tensors on the device)."""

    energy: torch.Tensor  # (F,) f32
    zcr: torch.Tensor  # (F,) f32
    entropy: torch.Tensor  # (F,) f32
    mfcc: torch.Tensor  # (F, num_ceps) f32
    vad: torch.Tensor  # (F,) i32 smoothed composite decision
    vad_adaptive: torch.Tensor  # (F,) i32


# Keys of constants() / load_constants(): the feature bases, named after the
# JAX pipeline's attributes without the underscore, and the ACF bases of the
# default pitch band (time_features._acf_dft_bases_merged).
FEATURE_CONSTANTS = ("window", "wm", "wnyq", "fb_t", "dct", "lifter")
ACF_CONSTANTS = ("acf_merged", "acf_nyq", "acf_inv_live", "acf_inv_nyq")


def _unsupported(cfg: FeatureConfig, window: np.ndarray) -> str | None:
    """Why the view kernels cannot take this geometry, or None."""
    if cfg.frame_size != 2 * cfg.hop_size:
        return f"frame_size {cfg.frame_size} != 2 * hop_size {cfg.hop_size}"
    if cfg.hop_size % 4:
        return f"hop_size {cfg.hop_size} is not a multiple of 4"
    if cfg.n_fft % 2:
        return f"odd n_fft {cfg.n_fft}"
    if cfg.entropy_n_fft != cfg.n_fft:
        return f"entropy_n_fft {cfg.entropy_n_fft} != n_fft {cfg.n_fft}"
    if not np.all(window > 0):
        return f"window {cfg.window_type!r} is not strictly positive"
    return None


class FeaturePipeline:
    """Configured frame -> feature -> VAD -> pitch pipeline on one device."""

    # Frames up to which the VAD runs at exact length; longer signals run it
    # once over the gate vectors padded to a multiple of history_len.
    SCAN_BLOCK_FRAMES = 32768
    # Length buckets (seconds) of the *_auto entry points: inputs zero-pad up
    # to one and the padded frames are masked out of the VAD state.
    SIGNAL_BUCKET_SECONDS = (2, 8, 32, 128, 512, 2048)

    def __init__(self, cfg: FeatureConfig | None = None, *, device):
        self.device = torch.device(device)
        self.cfg = cfg or FeatureConfig()
        if self.cfg.num_ceps > self.cfg.num_filters:
            # a length-N DCT-II has exactly N coefficients
            self.cfg = self.cfg._replace(num_ceps=self.cfg.num_filters)
        c = self.cfg
        window = get_window(c.window_type, c.frame_size)
        why = _unsupported(c, window)
        if why is not None:
            raise NotImplementedError(
                f"{why}: only the signal-view geometry is ported; the frames "
                "path (sspv_tpu/ops/pallas_kernels.py) is not yet"
            )
        wm, wnyq = bases.merged_windowed_dft_bases(
            c.frame_size, c.n_fft, c.window_type
        )
        self._acf: dict[int, tuple] = {}
        self.load_constants({
            "window": window,
            "wm": wm,
            "wnyq": wnyq,
            "fb_t": bases.mel_filterbank_np(
                c.num_filters, c.n_fft, c.sample_rate
            ).T.copy(),
            "dct": bases.dct_ortho_matrix(c.num_filters, c.num_ceps),
            "lifter": bases.lifter_vector(c.num_ceps, c.lifter),
        })

    # -- constants ----------------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    def load_constants(self, consts: dict) -> None:
        """Take bases from a dict of arrays (keys ``FEATURE_CONSTANTS`` and,
        optionally, ``ACF_CONSTANTS``), e.g. the JAX pipeline's ``_window``,
        ``_wm``, ... and ``_acf_dft_bases_merged``; missing keys keep their
        value."""
        for k in FEATURE_CONSTANTS:
            if k in consts:
                setattr(self, "_" + k, self._tensor(consts[k]))
        if all(k in consts for k in ACF_CONSTANTS):
            acf = tuple(self._tensor(consts[k]) for k in ACF_CONSTANTS)
            self._acf[acf[2].shape[1] - 1] = acf
        self._view_consts = dict(
            w2=self._window * self._window, wm=self._wm, wnyq=self._wnyq,
            fb_t=self._fb_t, dct=self._dct, lifter=self._lifter,
        )

    def constants(self) -> dict:
        """The pipeline's bases as NumPy arrays, with the ACF bases of the
        default 50-400 Hz pitch band."""
        out = {k: getattr(self, "_" + k).cpu().numpy() for k in FEATURE_CONSTANTS}
        acf = self._acf_bases(self._lag_max(50.0, 400.0))
        out.update((k, t.cpu().numpy()) for k, t in zip(ACF_CONSTANTS, acf))
        return out

    def _lag_max(self, fmin: float, fmax: float) -> int:
        c = self.cfg
        return _lag_band(c.sample_rate, fmin, fmax, c.frame_size)[1]

    def _acf_bases(self, lag_max: int) -> tuple:
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

    def host_rows_view(self, sig: np.ndarray) -> np.ndarray | None:
        """``(n+1, hop)`` rows view of a 1-D host signal, a free reshape of
        its first ``(n+1)*hop`` samples; ``None`` without a full frame."""
        c = self.cfg
        if sig.ndim != 1 or len(sig) < c.frame_size:
            return None
        n = 1 + (len(sig) - c.frame_size) // c.hop_size
        return sig[: (n + 1) * c.hop_size].reshape(n + 1, c.hop_size)

    @staticmethod
    def _host_signal(signal) -> np.ndarray:
        """int16 stays int16 (half the upload bytes); anything else float32."""
        if isinstance(signal, torch.Tensor):
            signal = signal.cpu().numpy()
        sig = np.asarray(signal)
        return sig if sig.dtype == np.int16 else sig.astype(np.float32, copy=False)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _bucket_length(self, n_samples: int) -> int:
        """Padded length of the *_auto entry points: the smallest bucket
        that holds the signal, or beyond the largest, the next multiple of
        it."""
        sr = self.cfg.sample_rate
        for s in self.SIGNAL_BUCKET_SECONDS:
            if n_samples <= s * sr:
                return s * sr
        quantum = self.SIGNAL_BUCKET_SECONDS[-1] * sr
        return -(-n_samples // quantum) * quantum

    # -- device side --------------------------------------------------------

    def _features_from_rows(self, rows: torch.Tensor) -> dict:
        """Per-frame features of a ``(F+1, hop)`` rows view (K1 on CUDA)."""
        return fused_view_features(rows, **self._view_consts)

    def _vad_core(self, energy, zcr, entropy, state, valid):
        c = self.cfg
        return vad_ops.streaming_vad(
            energy, zcr, entropy, state,
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
            valid=valid,
            trailing_impl=c.vad_trailing_impl,
        )

    def _vad_stage(self, feats: dict, state, valid):
        """Exact-length composite VAD over computed features."""
        vad, vad_adaptive, new_state = self._vad_core(
            feats["energy"], feats["zcr"], feats["entropy"], state, valid
        )
        return FeatureBlock(vad=vad, vad_adaptive=vad_adaptive, **feats), new_state

    def _vad_full_length(self, feats: dict, state, n: int, true_n=None):
        """One VAD pass over e/z/h padded to a multiple of history_len
        (blocked trailing sums), padded frames masked, decisions sliced
        back. mfcc is not padded: the VAD never reads it."""
        h = self.cfg.history_len
        f_pad = -(-n // h) * h
        e, z, ent = feats["energy"], feats["zcr"], feats["entropy"]
        if f_pad != n:
            e, z, ent = (
                torch.nn.functional.pad(v, (0, f_pad - n)) for v in (e, z, ent)
            )
        valid = None
        if f_pad != n or true_n is not None:
            limit = n if true_n is None else true_n
            valid = torch.arange(f_pad, device=e.device) < limit
        vad, vad_adaptive, new_state = self._vad_core(e, z, ent, state, valid)
        block = FeatureBlock(vad=vad[:n], vad_adaptive=vad_adaptive[:n], **feats)
        return block, new_state

    def _empty_block(self) -> FeatureBlock:
        z = torch.zeros(0, dtype=torch.float32, device=self.device)
        zi = torch.zeros(0, dtype=torch.int32, device=self.device)
        return FeatureBlock(
            energy=z, zcr=z, entropy=z,
            mfcc=torch.zeros((0, self.cfg.num_ceps), device=self.device),
            vad=zi, vad_adaptive=zi,
        )

    def _process_signal_view_impl(self, signal: torch.Tensor, state, n: int,
                                  true_n: int | None = None):
        """Features + VAD of the first ``n`` frames of ``signal`` (1-D
        samples or the ``(n+1, hop)`` rows view, on the device). ``true_n``
        marks the real frame count of a signal padded to a bucket: frames
        beyond it are masked out of the VAD state."""
        hop = self.cfg.hop_size
        x = signal.to(torch.float32)
        rows = x if x.dim() == 2 else x[: (n + 1) * hop].reshape(n + 1, hop)
        feats = self._features_from_rows(rows)
        if n <= self.SCAN_BLOCK_FRAMES:
            valid = None
            if true_n is not None:
                valid = torch.arange(n, device=x.device) < true_n
            return self._vad_stage(feats, state, valid)
        return self._vad_full_length(feats, state, n, true_n)

    def _process_signal_impl(self, signal: torch.Tensor, state):
        c = self.cfg
        if signal.dim() == 2:
            if signal.shape[1] != c.hop_size:
                raise ValueError(f"rows view must be (n+1, {c.hop_size}), "
                                 f"got {tuple(signal.shape)}")
            return self._process_signal_view_impl(
                signal, state, signal.shape[0] - 1
            )
        if signal.shape[0] < c.frame_size:
            return self._empty_block(), state
        n = 1 + (signal.shape[0] - c.frame_size) // c.hop_size
        return self._process_signal_view_impl(signal, state, n)

    def _process_signal_masked_impl(self, padded: torch.Tensor, state,
                                    true_n: int):
        c = self.cfg
        if padded.dim() == 2:
            n = padded.shape[0] - 1
        else:
            n = 1 + (padded.shape[0] - c.frame_size) // c.hop_size
        return self._process_signal_view_impl(padded, state, n, true_n=true_n)

    # -- public API ---------------------------------------------------------

    def process_signal_device(self, signal, state=None):
        """Features + VAD of a whole signal on the device. ``signal`` is a
        host array (uploaded as its rows view; int16 stays int16 and casts
        on the device) or a tensor of samples or rows (moved to the
        pipeline's device). Returns ``(FeatureBlock, VadState)``."""
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
        """Like :meth:`process_signal_device`, for a host signal padded to a
        ``SIGNAL_BUCKET_SECONDS`` bucket with the padded frames masked out
        of the VAD state; the block is sliced back to the true length."""
        sig = self._host_signal(signal)
        if state is None:
            state = self.initial_state()
        c = self.cfg
        if len(sig) < c.frame_size:
            return self.process_signal_device(sig, state)
        true_n = 1 + (len(sig) - c.frame_size) // c.hop_size
        sig = np.pad(sig, (0, self._bucket_length(len(sig)) - len(sig)))
        block, new_state = self._process_signal_masked_impl(
            self._upload(self.host_rows_view(sig)), state, true_n
        )
        return FeatureBlock(*(x[:true_n] for x in block)), new_state

    def _pitch_kwargs(self, fmin: float, fmax: float) -> dict:
        c = self.cfg
        return dict(
            frame_size=c.frame_size, hop_size=c.hop_size,
            sample_rate=c.sample_rate, fmin=fmin, fmax=fmax,
            bases=self._acf_bases(self._lag_max(fmin, fmax)),
        )

    def process_signal_pitch_auto(self, signal, state=None, fmin: float = 50.0,
                                  fmax: float = 400.0,
                                  min_confidence: float = 0.3):
        """Features + VAD + VAD-gated pitch of a host signal, bucketed like
        :meth:`process_signal_auto`, with the same outputs as it followed by
        :meth:`pitch_signal_auto`. Returns ``(block, state, f0, conf)`` with
        ``f0``/``conf`` host arrays of the block's length."""
        sig = self._host_signal(signal)
        if state is None:
            state = self.initial_state()
        c = self.cfg
        if len(sig) < c.frame_size:
            block, new_state = self.process_signal_auto(sig, state)
            f0, conf = self.pitch_signal_auto(
                sig, block.vad, fmin=fmin, fmax=fmax,
                min_confidence=min_confidence,
            )
            return block, new_state, f0, conf
        true_n = 1 + (len(sig) - c.frame_size) // c.hop_size
        sig = np.pad(sig, (0, self._bucket_length(len(sig)) - len(sig)))
        padded = self._upload(self.host_rows_view(sig))
        block, new_state = self._process_signal_masked_impl(
            padded, state, true_n
        )
        # hangover can spill decisions past true_n into the padded tail:
        # gate pitch on the real frames only, as the two-call path does
        frame_idx = torch.arange(block.vad.shape[0], device=self.device)
        gate_vad = torch.where(frame_idx < true_n, block.vad,
                               torch.zeros_like(block.vad))
        f0, conf = pitch_track_signal_gated(
            padded, gate_vad, min_confidence, **self._pitch_kwargs(fmin, fmax)
        )
        block = FeatureBlock(*(x[:true_n] for x in block))
        return (block, new_state, f0[:true_n].cpu().numpy(),
                conf[:true_n].cpu().numpy())

    def pitch_signal_auto(self, signal, vad, fmin: float = 50.0,
                          fmax: float = 400.0, min_confidence: float = 0.3):
        """VAD-gated pitch track of a host signal, padded to a bucket (pad
        frames are gated off, so the slice is exact). Returns host
        ``(f0, conf)`` of ``len(vad)``."""
        c = self.cfg
        sig = self._host_signal(signal)
        vad = vad.cpu().numpy() if isinstance(vad, torch.Tensor) else np.asarray(vad)
        n = int(vad.shape[0])
        if len(sig) < c.frame_size or n == 0:
            z = np.zeros((0,), np.float32)
            return z, z
        psig = np.pad(sig, (0, self._bucket_length(len(sig)) - len(sig)))
        n_pad = 1 + (len(psig) - c.frame_size) // c.hop_size
        # vad may hold one frame more than the bucketed signal (a ceil-framed
        # vad on a signal that fills its bucket): the missing frames stay 0
        pvad = np.zeros((n_pad,), np.int32)
        m = min(n, n_pad)
        pvad[:m] = vad[:m]
        f0, conf = pitch_track_signal_gated(
            self._upload(self.host_rows_view(psig)), pvad, min_confidence,
            **self._pitch_kwargs(fmin, fmax),
        )
        f0 = f0.cpu().numpy()[:n]
        conf = conf.cpu().numpy()[:n]
        if n > f0.shape[0]:
            f0 = np.pad(f0, (0, n - f0.shape[0]))
            conf = np.pad(conf, (0, n - conf.shape[0]))
        return f0, conf
