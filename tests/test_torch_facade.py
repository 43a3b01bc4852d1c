#!/usr/bin/env python3
"""The port's ``SignalProcessing`` facade: the historical API's
polymorphism quirks (the cases of ``tests/test_facade.py``), and every
method against the JAX package's facade on the same seeded inputs.

The facade's device is the class attribute ``SignalProcessing.device``
(``"cuda"`` by default); the fixture sets it to ``"cpu"`` for each test.
Gates: windows, framing, ZCR and both VADs EQUAL to the JAX facade's;
energy, ACF, AMDF, MFCC and entropy NMSE <= 1e-10 against it and <= 1e-5
against ``tests/oracle.py``.
"""

import numpy as np
import pytest
import torch

from sspv_tpu.signal_processing import SignalProcessing as JSP
from sspv_tpu_torch import SignalProcessing
from sspv_tpu_torch import signal_processing as tsp
from sspv_tpu_torch.config import Config as TConfig

import oracle

GEOMETRIES = [(320, 160), (400, 160), (322, 161)]


def nmse(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(SignalProcessing, "device", "cpu")


def signal(n=8000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return 4000 * np.sin(2 * np.pi * 140 * t) * (t > 0.1) + rng.normal(0, 200, n)


def test_default_device_is_the_card(monkeypatch):
    """The class attribute is read at each call; left at its default the
    batched work needs a card and raises without one (the 1-D scalar paths
    stay on the host)."""
    monkeypatch.undo()
    assert SignalProcessing.device == "cuda"
    frame = np.ones(320, np.float32)
    assert SignalProcessing.calculate_short_time_energy(frame) == 320.0
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            SignalProcessing.calculate_short_time_energy(frame[None, :])
    with tsp.on_device("cpu"):
        assert SignalProcessing.device == "cpu"
        out = SignalProcessing.calculate_short_time_energy(frame[None, :])
        assert isinstance(out, np.ndarray) and out[0] == 320.0
    assert SignalProcessing.device == "cuda"


def test_energy_scalar_vs_batch():
    frame = np.random.default_rng(0).normal(0, 100, 320).astype(np.float32)
    scalar = SignalProcessing.calculate_short_time_energy(frame)
    assert isinstance(scalar, float)
    batch = SignalProcessing.calculate_short_time_energy(frame[None, :])
    assert isinstance(batch, np.ndarray) and batch.shape == (1,)
    np.testing.assert_allclose(scalar, batch[0], rtol=1e-5)


def test_zcr_scalar_empty():
    assert SignalProcessing.calculate_zero_crossing_rate(np.zeros(0)) == 0.0
    z = SignalProcessing.calculate_zero_crossing_rate(
        np.array([1.0, -1.0, 1.0, 1.0]))
    assert isinstance(z, float) and z == 0.5


def test_entropy_scalar_vs_batch():
    frame = np.random.default_rng(1).normal(0, 100, 320).astype(np.float32)
    scalar = SignalProcessing.calculate_spectral_entropy(frame)
    assert isinstance(scalar, float)
    batch = SignalProcessing.calculate_spectral_entropy(frame[None, :])
    assert batch.shape == (1,) and scalar == float(batch[0])


def test_autocorr_single_frame_normalized_length():
    frame = np.sin(np.arange(320) * 0.1).astype(np.float32)
    acf = SignalProcessing.calculate_short_time_autocorrelation(frame, 50)
    # single frame: length == max_lag (NOT max_lag+1), acf[0] == 1
    assert acf.shape == (50,) and acf.dtype == np.float32
    assert acf[0] == 1.0
    assert nmse(acf, JSP.calculate_short_time_autocorrelation(frame, 50)) <= 1e-10
    # multi frame: (num_frames, max_lag+1), unnormalized
    frames = np.stack([frame, frame * 2])
    acf2 = SignalProcessing.calculate_short_time_autocorrelation(frames, 50)
    assert acf2.shape == (2, 51)
    assert acf2[1, 0] > acf2[0, 0]
    # an all-zero single frame stays unnormalized zeros
    assert not SignalProcessing.calculate_short_time_autocorrelation(
        np.zeros(320), 10).any()


def test_amdf_single_frame_promotes_to_2d():
    frame = np.sin(np.arange(320) * 0.1).astype(np.float32)
    out = SignalProcessing.calculate_average_magnitude_difference(frame, 40)
    assert out.shape == (1, 40)
    want = JSP.calculate_average_magnitude_difference(frame, 40)
    assert nmse(out, want) <= 1e-10


def test_mel_filterbank_param_name_shim():
    fb = SignalProcessing.mel_filterbank(n_filters=26, n_fft=512, sample_rate=16000)
    assert fb.shape == (26, 257)
    np.testing.assert_allclose(fb, oracle.mel_filterbank(26, 512, 16000), atol=1e-6)
    np.testing.assert_array_equal(fb, JSP.mel_filterbank(26, 512, 16000))


def test_mfcc_pre_emphasis_and_lifter_paths():
    rng = np.random.default_rng(3)
    frame = rng.normal(0, 1000, 320).astype(np.float32)
    base = SignalProcessing.compute_mfcc(frame, 16000)
    lifted = SignalProcessing.compute_mfcc(frame, 16000, lifter=22)
    pre = SignalProcessing.compute_mfcc(frame, 16000, pre_emphasis=0.97)
    assert base.shape == lifted.shape == pre.shape == (13,)
    lift = 1.0 + 11.0 * np.sin(np.pi * np.arange(13) / 22.0)
    np.testing.assert_allclose(lifted, base * lift, rtol=1e-5)
    # pre-emphasis changes the spectrum
    assert not np.allclose(pre, base)
    # oracle cross-check of the pre-emphasis path
    pre_frame = oracle.preemphasis(frame, 0.97)
    want = oracle.mfcc(pre_frame, 16000)[0]
    np.testing.assert_allclose(pre, want, atol=2e-3)
    for kw in (dict(), dict(lifter=22), dict(pre_emphasis=0.97)):
        assert nmse(SignalProcessing.compute_mfcc(frame, 16000, **kw),
                    JSP.compute_mfcc(frame, 16000, **kw)) <= 1e-10


def test_mfcc_lifters_the_truncated_width():
    """num_ceps > n_filters: the DCT yields n_filters coefficients and the
    lifter covers that width (the historical code would fail to
    broadcast)."""
    frames = np.random.default_rng(4).normal(0, 1000, (5, 320)).astype(np.float32)
    got = SignalProcessing.compute_mfcc(frames, 16000, n_filters=20,
                                        num_ceps=30, lifter=22)
    want = JSP.compute_mfcc(frames, 16000, n_filters=20, num_ceps=30, lifter=22)
    assert got.shape == want.shape == (5, 20)
    assert nmse(got, want) <= 1e-10


def test_vad_threshold_defaults_come_from_config():
    assert tsp._Config is TConfig
    e = np.array([TConfig.ENERGY_THRESHOLD * 2.0], np.float32)
    z = np.array([TConfig.ZCR_THRESHOLD / 2.0], np.float32)
    out = SignalProcessing.voice_activity_detection(e, z)
    assert out.dtype == bool and bool(out[0])
    assert not SignalProcessing.voice_activity_detection(e / 4.0, z)[0]


def test_scalar_vad_inputs_return_python_scalars():
    out = SignalProcessing.voice_activity_detection(10000, 0.2)
    assert type(out) is int and out == 1
    assert SignalProcessing.voice_activity_detection(500, 0.05) == 0
    out = SignalProcessing.adaptive_voice_activity_detection(
        5000.0, 0.02, [200.0] * 30, [0.03] * 30)
    assert type(out) is bool and out is True
    assert SignalProcessing.adaptive_voice_activity_detection(
        100.0, 0.02, [200.0] * 30, [0.03] * 30) is False


def test_adaptive_vad_batch_returns_bool_array():
    e = np.array([5000.0, 100.0], np.float32)
    z = np.array([0.02, 0.02], np.float32)
    out = SignalProcessing.adaptive_voice_activity_detection(
        e, z, [200.0] * 30, [0.03] * 30, alpha=0.8
    )
    assert out.dtype == bool and out.shape == (2,)
    assert bool(out[0]) and not bool(out[1])


@pytest.mark.parametrize("kwargs", [
    dict(), dict(alpha=0.5), dict(energy_k=0.3), dict(zcr_k=0.9),
    dict(energy_k=None, zcr_k=0.2), dict(energy_k="loud"), dict(alpha=5.0),
    dict(min_energy_threshold=3000.0), dict(max_zcr_threshold=0.01),
])
def test_adaptive_vad_legacy_kwargs_map_to_alpha(kwargs):
    """energy_k / zcr_k stand in for alpha when alpha is not given (an
    unreadable value falls back to 0.8); inputs sit away from the blended
    thresholds, so the decisions equal the JAX facade's."""
    e = np.array([5000.0, 100.0, 900.0, 2500.0, 40.0], np.float32)
    z = np.array([0.02, 0.02, 0.3, 0.011, 0.001], np.float32)
    hist_e, hist_z = [200.0, 400.0, 150.0] * 10, [0.03, 0.05, 0.04] * 10
    got = SignalProcessing.adaptive_voice_activity_detection(
        e, z, hist_e, hist_z, **kwargs)
    want = JSP.adaptive_voice_activity_detection(e, z, hist_e, hist_z, **kwargs)
    np.testing.assert_array_equal(got, want)
    none = SignalProcessing.adaptive_voice_activity_detection(
        e, z, None, None, **kwargs)
    np.testing.assert_array_equal(
        none, JSP.adaptive_voice_activity_detection(e, z, None, None, **kwargs))


@pytest.mark.parametrize("window", ["hamming", "hanning", "rectangular"])
@pytest.mark.parametrize("frame,hop", GEOMETRIES)
def test_batched_calls_match_the_jax_facade(frame, hop, window):
    sig = signal(seed=frame)
    frames = SignalProcessing.framing(sig, frame, hop, window)
    want = JSP.framing(sig, frame, hop, window)
    assert isinstance(frames, np.ndarray) and frames.dtype == np.float32
    np.testing.assert_array_equal(frames, want)
    np.testing.assert_array_equal(
        SignalProcessing.calculate_zero_crossing_rate(frames),
        JSP.calculate_zero_crossing_rate(frames))
    for name, ref in (
        ("calculate_short_time_energy", oracle.short_time_energy(frames)),
        ("calculate_spectral_entropy", oracle.spectral_entropy(frames)),
    ):
        got = getattr(SignalProcessing, name)(frames)
        assert nmse(got, getattr(JSP, name)(frames)) <= 1e-10, name
        assert nmse(got, ref) <= 1e-5, name
    got = SignalProcessing.compute_mfcc(frames, 16000, lifter=22)
    assert nmse(got, JSP.compute_mfcc(frames, 16000, lifter=22)) <= 1e-10
    assert nmse(got, oracle.mfcc(frames, 16000, lifter=22)) <= 1e-5
    acf = SignalProcessing.calculate_short_time_autocorrelation(frames, 60)
    assert nmse(acf, JSP.calculate_short_time_autocorrelation(frames, 60)) <= 1e-10
    assert nmse(acf, oracle.autocorrelation(frames, 60)) <= 1e-5
    amdf = SignalProcessing.calculate_average_magnitude_difference(frames, 60)
    assert nmse(amdf, oracle.amdf(frames, 60)) <= 1e-5
    e = SignalProcessing.calculate_short_time_energy(frames)
    z = SignalProcessing.calculate_zero_crossing_rate(frames)
    np.testing.assert_array_equal(
        SignalProcessing.voice_activity_detection(e, z, 1e6, 0.1),
        JSP.voice_activity_detection(e, z, 1e6, 0.1))


def test_preemphasis_and_windows_equal_the_jax_facade():
    x = signal(1000, seed=2)
    np.testing.assert_array_equal(SignalProcessing.preemphasis(x),
                                  JSP.preemphasis(x))
    assert SignalProcessing.preemphasis(np.zeros(0)).shape == (0,)
    for name in ("hamming_window", "hanning_window", "rectangular_window"):
        np.testing.assert_array_equal(getattr(SignalProcessing, name)(320),
                                      getattr(JSP, name)(320))
        assert getattr(tsp, name) is not None


def test_free_functions_are_the_static_methods():
    for name in tsp.__all__:
        if name == "SignalProcessing" or name.endswith("_window"):
            continue
        assert getattr(tsp, name) is getattr(SignalProcessing, name), name
