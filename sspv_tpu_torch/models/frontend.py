"""Configured, composable speech-frontend transforms as ``nn.Module``s.

Counterpart of ``sspv_tpu/models/frontend.py``. Every transform captures its
configuration and its host-built constants (registered as buffers on
``device``, ``"cuda"`` by default) at construction and exposes

- ``forward(frames)``: batched frames -> features, and
- ``from_signal(signal)``: 1-D audio -> features (framing included).

Inputs may be tensors or arrays; they move to the module's device. The
DFT, mel and DCT products are plain float32 matmuls (full float32 whatever
the process's TF32 switches say), as they are ``jnp.matmul`` at
``Precision.HIGHEST`` outside any Pallas kernel in the JAX package: these
modules are an independent second implementation beside the fused kernels
of ``FeaturePipeline``, not a route to them. The zero-crossing rate divides
the count by the frame length (a true float32 division, as the eager JAX
transforms compute it), one ulp from the pipeline's multiply by the
reciprocal for some counts.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops import bases
from ..ops.frequency_features import entropy_from_power
from ..ops.pitch import _lag_band, pitch_from_frames, pitch_from_frames_amdf
from ..ops.fp32 import full_fp32
from ..ops.preprocessing import frame_signal
from ..ops.time_features import zero_crossing_rate
from ..ops.windows import get_window

__all__ = [
    "FrameTransform",
    "Spectrogram",
    "MelSpectrogram",
    "MFCC",
    "SpectralEntropy",
    "VADModel",
    "SpeechFrontend",
    "Pitch",
]


def _energy_zcr(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Short-time energy and zero-crossing rate of windowed frames: the one
    definition shared by VADModel and SpeechFrontend (no /2 on the
    sign-change count, divided by the frame length)."""
    return (x * x).sum(dim=-1), zero_crossing_rate(x)


class FrameTransform(nn.Module):
    """Base: framing geometry + window shared by all transforms."""

    def __init__(
        self,
        sample_rate: int = 16000,
        frame_size: int = 320,
        hop_size: int = 160,
        window_type: str = "hamming",
        device="cuda",
    ):
        super().__init__()
        self.sample_rate = int(sample_rate)
        self.frame_size = int(frame_size)
        self.hop_size = int(hop_size)
        self.window_type = str(window_type)
        self._device = torch.device(device)
        self._constant("window", get_window(window_type, frame_size))

    def _constant(self, name: str, array: np.ndarray) -> None:
        self.register_buffer(
            name,
            torch.from_numpy(np.ascontiguousarray(array)).to(self._device),
            persistent=False,
        )

    def _f32(self, x) -> torch.Tensor:
        """``x`` (tensor or array) as float32 on the module's device."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device=self.window.device, dtype=torch.float32)

    def frames_of(self, signal) -> torch.Tensor:
        """Window-applied frames of a 1-D signal (zero-padded tail)."""
        raw = frame_signal(self._f32(signal), self.frame_size, self.hop_size)
        return raw * self.window

    def from_signal(self, signal):
        return self(self.frames_of(signal))

    def forward(self, frames):  # pragma: no cover - abstract
        raise NotImplementedError


class Spectrogram(FrameTransform):
    """Windowed power spectrogram via the DFT-matmul pair."""

    def __init__(self, n_fft: int = 512, **kw):
        super().__init__(**kw)
        self.n_fft = int(n_fft)
        # window NOT folded in: forward receives already-windowed frames
        cos_b, sin_b = bases.dft_bases(self.frame_size, self.n_fft)
        self._constant("_cos", cos_b)
        self._constant("_sin", sin_b)

    def _power_of(self, frames) -> torch.Tensor:
        x = self._f32(frames)
        with full_fp32(x):
            re = x @ self._cos
            im = x @ self._sin
        return re * re + im * im

    def forward(self, frames) -> torch.Tensor:
        return self._power_of(frames)


class MelSpectrogram(Spectrogram):
    """Log-mel energies: power spectrogram -> mel filterbank -> log."""

    def __init__(self, num_filters: int = 26, fmin: float = 0.0,
                 fmax: float | None = None, log: bool = True, **kw):
        super().__init__(**kw)
        self.num_filters = int(num_filters)
        self.log = bool(log)
        self._constant("_fb_t", bases.mel_filterbank_np(
            num_filters, self.n_fft, self.sample_rate, fmin, fmax).T)

    def _mel_of(self, power) -> torch.Tensor:
        """Clamped mel energies of a power spectrogram (pre-log)."""
        with full_fp32(power):
            return (power @ self._fb_t).clamp_min(1e-10)

    def forward(self, frames) -> torch.Tensor:
        mel = self._mel_of(self._power_of(frames))
        return torch.log(mel) if self.log else mel


class MFCC(MelSpectrogram):
    """MFCCs: log-mel -> orthonormal DCT-II -> optional lifter."""

    def __init__(self, num_ceps: int = 13, lifter: int | None = 22, **kw):
        super().__init__(log=True, **kw)
        self.num_ceps = int(num_ceps)
        self._constant("_dct", bases.dct_ortho_matrix(self.num_filters, num_ceps))
        self._constant("_lifter", bases.lifter_vector(num_ceps, lifter))

    def _mfcc_of(self, log_mel) -> torch.Tensor:
        """Liftered DCT of log-mel energies."""
        with full_fp32(log_mel):
            return (log_mel @ self._dct) * self._lifter

    def forward(self, frames) -> torch.Tensor:
        return self._mfcc_of(super().forward(frames))


class SpectralEntropy(Spectrogram):
    """Normalized Shannon entropy of the power spectrum, in [0, 1]."""

    def forward(self, frames) -> torch.Tensor:
        return entropy_from_power(self._power_of(frames))


class VADModel(FrameTransform):
    """Fixed dual-threshold VAD over energy/ZCR of windowed frames."""

    def __init__(self, energy_threshold: float = 1000.0,
                 zcr_threshold: float = 0.3, **kw):
        super().__init__(**kw)
        self.energy_threshold = float(energy_threshold)
        self.zcr_threshold = float(zcr_threshold)

    def forward(self, frames) -> torch.Tensor:
        energy, zcr = _energy_zcr(self._f32(frames))
        return (energy > self.energy_threshold) & (zcr < self.zcr_threshold)


class SpeechFrontend(FrameTransform):
    """The full bundle: one call returning a feature dict, sharing a single
    spectrum across MFCC and entropy (what the fused pipeline computes)."""

    def __init__(self, n_fft: int = 512, num_filters: int = 26,
                 num_ceps: int = 13, lifter: int | None = 22, **kw):
        super().__init__(**kw)
        self._mfcc = MFCC(
            n_fft=n_fft, num_filters=num_filters, num_ceps=num_ceps,
            lifter=lifter, sample_rate=self.sample_rate,
            frame_size=self.frame_size, hop_size=self.hop_size,
            window_type=self.window_type, device=self._device,
        )

    def forward(self, frames) -> dict:
        x = self._f32(frames)
        energy, zcr = _energy_zcr(x)
        # one spectrum shared by MFCC and entropy, with the mel/DCT/lifter
        # math delegated to the MFCC transform so the numerics have exactly
        # one definition
        power = self._mfcc._power_of(x)
        mfcc = self._mfcc._mfcc_of(torch.log(self._mfcc._mel_of(power)))
        return {
            "energy": energy,
            "zcr": zcr,
            "mfcc": mfcc,
            "entropy": entropy_from_power(power),
        }


class Pitch(FrameTransform):
    """Configured F0 estimator over frames: ``method="acf"`` (normalized-ACF
    peak, the direct sliding sums) or ``"amdf"`` (earliest-valley AMDF
    dual; independent cross-check estimator).

    Pitch operates on RAW frames (the pipeline's pitch path frames the
    signal without a window), so ``frames_of`` here does NOT apply the
    analysis window, unlike the spectral transforms.
    """

    def __init__(self, fmin: float = 50.0, fmax: float = 400.0,
                 method: str = "acf", **kw):
        super().__init__(**kw)
        if method not in ("acf", "amdf"):
            raise ValueError(f"unknown pitch method {method!r}")
        self.fmin = float(fmin)
        self.fmax = float(fmax)
        self.method = method
        # validate the lag band at construction, not first call
        _lag_band(self.sample_rate, self.fmin, self.fmax, self.frame_size)

    def frames_of(self, signal) -> torch.Tensor:
        return frame_signal(self._f32(signal), self.frame_size, self.hop_size)

    def forward(self, frames) -> tuple[torch.Tensor, torch.Tensor]:
        x = self._f32(frames)
        if self.method == "amdf":
            return pitch_from_frames_amdf(x, self.sample_rate, self.fmin,
                                          self.fmax)
        return pitch_from_frames(x, self.sample_rate, self.fmin, self.fmax)
