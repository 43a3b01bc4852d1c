"""``SignalProcessing`` aggregate facade (compatibility surface).

Counterpart of ``sspv_tpu/signal_processing/__init__.py``: a thin host-side
shim with the historical static-method API, including its scalar/1-D/2-D
polymorphism quirks:

- 1-D input to energy/zcr/entropy returns a Python float; 2-D returns arrays;
- single-frame autocorrelation returns a **length ``max_lag``** (not
  ``max_lag+1``) vector normalized so ``acf[0] == 1.0``;
- ``compute_mfcc`` accepts legacy kwargs (``n_filters``, ``lifter``,
  ``pre_emphasis``) and applies liftering here, not in the core op;
- ``adaptive_voice_activity_detection`` accepts and maps legacy kwargs
  (``energy_k``/``zcr_k`` become ``alpha`` when given).

The polymorphism is settled on the host in NumPy; only the batched 2-D work
goes to the device, through the ops in ``sspv_tpu_torch.ops``, and comes
back as NumPy. Inputs and outputs are NumPy types, as the historical API
promises, so the signatures carry no ``device``: the device is the class
attribute ``SignalProcessing.device`` (``"cuda"`` by default, read at each
call; without a card the batched calls raise, and a caller who wants the
CPU sets ``SignalProcessing.device = "cpu"``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import ops
from ..config import Config as _Config
from ..ops import bases as _bases
from ..ops.windows import (
    hamming_window,
    hanning_window,
    rectangular_window,
)


def _to_dev(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(SignalProcessing.device)


def _to_np(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


class SignalProcessing:
    """Aggregate static-method facade with the historical API."""

    # where the batched work runs; read at each call
    device = "cuda"

    # -- windows -------------------------------------------------------------
    @staticmethod
    def hamming_window(length: int) -> np.ndarray:
        return hamming_window(length)

    @staticmethod
    def hanning_window(length: int) -> np.ndarray:
        return hanning_window(length)

    @staticmethod
    def rectangular_window(length: int) -> np.ndarray:
        return rectangular_window(length)

    # -- preprocessing -------------------------------------------------------
    @staticmethod
    def preemphasis(signal: np.ndarray, alpha: float = 0.97) -> np.ndarray:
        x = np.asarray(signal, dtype=np.float32)
        if x.size == 0:
            return x
        return np.append(x[0], x[1:] - np.float32(alpha) * x[:-1]).astype(np.float32)

    @staticmethod
    def framing(
        signal: np.ndarray, frame_size: int, hop_size: int, window_type: str = "hamming"
    ) -> np.ndarray:
        x = np.asarray(signal, dtype=np.float32)
        return _to_np(ops.framing(_to_dev(x), frame_size, hop_size, window_type))

    # -- time-domain features ------------------------------------------------
    @staticmethod
    def calculate_short_time_energy(frames_or_frame: np.ndarray):
        arr = np.asarray(frames_or_frame, dtype=np.float32)
        if arr.ndim == 1:
            return float(np.sum(arr**2))
        return _to_np(ops.calculate_short_time_energy(_to_dev(arr)))

    @staticmethod
    def calculate_zero_crossing_rate(frames_or_frame: np.ndarray):
        arr = np.asarray(frames_or_frame, dtype=np.float32)
        if arr.ndim == 1:
            signs = np.sign(arr)
            crossings = np.sum(np.abs(np.diff(signs)) > 0)
            return float(crossings) / arr.size if arr.size else 0.0
        return _to_np(ops.calculate_zero_crossing_rate(_to_dev(arr)))

    @staticmethod
    def calculate_short_time_autocorrelation(frames: np.ndarray, max_lag: int):
        arr = np.atleast_2d(np.asarray(frames, dtype=np.float32))
        acf = _to_np(ops.calculate_short_time_autocorrelation(_to_dev(arr), max_lag))
        if arr.shape[0] == 1:
            vec = acf[0, :max_lag].astype(np.float32)
            if vec.size and vec[0] != 0:
                vec = (vec / vec[0]).astype(np.float32)
            return vec
        return acf

    @staticmethod
    def calculate_average_magnitude_difference(frames: np.ndarray, max_lag: int):
        arr = np.atleast_2d(np.asarray(frames, dtype=np.float32))
        return _to_np(ops.calculate_average_magnitude_difference(_to_dev(arr), max_lag))

    # -- frequency-domain features -------------------------------------------
    @staticmethod
    def mel_filterbank(
        n_filters: int,
        n_fft: int,
        sample_rate: int,
        fmin: float = 0.0,
        fmax: float | None = None,
    ) -> np.ndarray:
        return _bases.mel_filterbank_np(n_filters, n_fft, sample_rate, fmin, fmax)

    @staticmethod
    def compute_mfcc(
        frame_or_frames: np.ndarray,
        sample_rate: int,
        n_fft: int = 512,
        n_filters: int = 26,
        num_ceps: int = 13,
        lifter: int | None = None,
        pre_emphasis: float | None = None,
        fmin: float = 0.0,
        fmax: float | None = None,
    ):
        frames = np.atleast_2d(np.asarray(frame_or_frames, dtype=np.float32))
        if pre_emphasis is not None and pre_emphasis > 0:
            frames = np.vstack(
                [SignalProcessing.preemphasis(fr, alpha=pre_emphasis) for fr in frames]
            )
        mfcc = _to_np(
            ops.compute_mfcc(
                _to_dev(frames),
                sample_rate=sample_rate,
                n_fft=n_fft,
                num_filters=n_filters,
                num_ceps=num_ceps,
                fmin=fmin,
                fmax=fmax,
            )
        )
        if lifter is not None and lifter > 0:
            # lifter over the actual output width: the DCT yields at most
            # n_filters coefficients (the reference would raise a broadcast
            # error when num_ceps > n_filters with a lifter; we lifter the
            # truncated width instead)
            mfcc = mfcc * _bases.lifter_vector(mfcc.shape[1], lifter)
        return mfcc[0] if np.asarray(frame_or_frames).ndim == 1 else mfcc

    @staticmethod
    def calculate_spectral_entropy(frame_or_frames: np.ndarray, n_fft: int = 512):
        frames = np.atleast_2d(np.asarray(frame_or_frames, dtype=np.float32))
        entropy = _to_np(ops.calculate_spectral_entropy(_to_dev(frames), n_fft=n_fft))
        return (
            float(entropy[0])
            if np.asarray(frame_or_frames).ndim == 1
            else entropy
        )

    # -- voice-activity detection --------------------------------------------
    @staticmethod
    def voice_activity_detection(
        energy,
        zcr,
        energy_threshold: float | None = None,
        zcr_threshold: float | None = None,
    ):
        if energy_threshold is None:
            energy_threshold = _Config.ENERGY_THRESHOLD
        if zcr_threshold is None:
            zcr_threshold = _Config.ZCR_THRESHOLD
        energy_arr = np.atleast_1d(np.asarray(energy, dtype=np.float32))
        zcr_arr = np.atleast_1d(np.asarray(zcr, dtype=np.float32))
        result = _to_np(
            ops.voice_activity_detection(
                _to_dev(energy_arr),
                _to_dev(zcr_arr),
                float(energy_threshold or 0.0),
                float(zcr_threshold or 0.0),
            )
        )
        if np.asarray(energy).ndim == 0 and np.asarray(zcr).ndim == 0:
            return int(bool(result[0]))
        return result.astype(bool)

    @staticmethod
    def adaptive_voice_activity_detection(
        energy,
        zcr,
        energy_history,
        zcr_history,
        **kwargs,
    ):
        # Legacy kwarg mapping (reference __init__.py:223-238): energy_k /
        # zcr_k double as alpha when no explicit alpha is given; the value is
        # clamped to [0, 0.99] downstream.
        alpha = kwargs.get("alpha")
        if alpha is None:
            for k in ("energy_k", "zcr_k"):
                if k in kwargs and kwargs[k] is not None:
                    try:
                        alpha = float(kwargs[k])
                    except (TypeError, ValueError):
                        alpha = 0.8
                    break
        if alpha is None:
            alpha = 0.8
        min_energy_threshold = float(kwargs.get("min_energy_threshold", 1e-6))
        max_zcr_threshold = float(kwargs.get("max_zcr_threshold", 0.5))

        energy_arr = np.atleast_1d(np.asarray(energy, dtype=np.float32))
        zcr_arr = np.atleast_1d(np.asarray(zcr, dtype=np.float32))
        e_hist = (
            np.asarray(list(energy_history), dtype=np.float32)
            if energy_history is not None
            else np.zeros((0,), np.float32)
        )
        z_hist = (
            np.asarray(list(zcr_history), dtype=np.float32)
            if zcr_history is not None
            else np.zeros((0,), np.float32)
        )
        result = _to_np(
            ops.adaptive_voice_activity_detection(
                _to_dev(energy_arr),
                _to_dev(zcr_arr),
                _to_dev(e_hist),
                _to_dev(z_hist),
                alpha=alpha,
                min_energy_threshold=min_energy_threshold,
                max_zcr_threshold=max_zcr_threshold,
            )
        )
        if np.asarray(energy).ndim == 0 and np.asarray(zcr).ndim == 0:
            return bool(result[0])
        return result.astype(bool)


@contextlib.contextmanager
def on_device(device):
    """Run the enclosed facade calls on ``device``, then put
    ``SignalProcessing.device`` back (the ``--device`` of the entry
    points)."""
    before = SignalProcessing.device
    SignalProcessing.device = device
    try:
        yield
    finally:
        SignalProcessing.device = before


# Free-function surface, importable directly (reference __all__,
# signal_processing/__init__.py:256-273).
preemphasis = SignalProcessing.preemphasis
framing = SignalProcessing.framing
calculate_short_time_energy = SignalProcessing.calculate_short_time_energy
calculate_zero_crossing_rate = SignalProcessing.calculate_zero_crossing_rate
calculate_short_time_autocorrelation = (
    SignalProcessing.calculate_short_time_autocorrelation
)
calculate_average_magnitude_difference = (
    SignalProcessing.calculate_average_magnitude_difference
)
mel_filterbank = SignalProcessing.mel_filterbank
compute_mfcc = SignalProcessing.compute_mfcc
calculate_spectral_entropy = SignalProcessing.calculate_spectral_entropy
voice_activity_detection = SignalProcessing.voice_activity_detection
adaptive_voice_activity_detection = SignalProcessing.adaptive_voice_activity_detection

__all__ = [
    "SignalProcessing",
    "hamming_window",
    "hanning_window",
    "rectangular_window",
    "preemphasis",
    "framing",
    "calculate_short_time_energy",
    "calculate_zero_crossing_rate",
    "calculate_short_time_autocorrelation",
    "calculate_average_magnitude_difference",
    "mel_filterbank",
    "compute_mfcc",
    "calculate_spectral_entropy",
    "voice_activity_detection",
    "adaptive_voice_activity_detection",
]
