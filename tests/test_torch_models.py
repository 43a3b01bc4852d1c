#!/usr/bin/env python3
"""The port's frontend transforms (``sspv_tpu_torch.models``) against the
JAX package's and the NumPy oracle: the cases of ``tests/test_models.py``,
over three geometries and two windows.

Gates: VAD decisions and ZCR EQUAL to the JAX transforms' (the eager JAX
call divides the count by the frame length, and so do these modules);
every float output NMSE <= 1e-10 against JAX and <= 1e-5 against
``tests/oracle.py``. The modules run with ``device="cpu"`` here; their
default is the card.
"""

import numpy as np
import pytest
import torch

import sspv_tpu.models as jm
import sspv_tpu_torch.models as tm
from sspv_tpu_torch.ops.pipeline import FeatureConfig, FeaturePipeline

import oracle

GEOMETRIES = [(320, 160), (400, 160), (322, 161)]
WINDOWS = ["hamming", "hanning"]


def nmse(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


def signal(seconds=1.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    gate = ((t * 4).astype(int) % 2) == 1
    tone = 5000 * np.sin(2 * np.pi * 130 * t) + 1500 * np.sin(2 * np.pi * 390 * t)
    return (np.where(gate, tone, 0) + rng.normal(0, 300, t.size)).astype(np.float32)


def geometry(frame, hop, window):
    return dict(frame_size=frame, hop_size=hop, window_type=window)


def windowed_frames(frame, hop, window, seed=0):
    return np.array(jm.Spectrogram(**geometry(frame, hop, window)).frames_of(
        signal(seed=seed)))  # a writable copy


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("frame,hop", GEOMETRIES)
def test_spectrogram_matches_rfft(frame, hop, window):
    g = geometry(frame, hop, window)
    frames = windowed_frames(frame, hop, window)
    model = tm.Spectrogram(device="cpu", **g)
    got = model(frames)
    assert isinstance(model, torch.nn.Module) and got.dtype == torch.float32
    assert nmse(got.numpy(), np.asarray(jm.Spectrogram(**g)(frames))) <= 1e-10
    assert nmse(got.numpy(), np.abs(np.fft.rfft(frames, n=512)) ** 2) < 1e-8
    # a tensor goes in as well as an array
    assert torch.equal(model(torch.from_numpy(frames.copy())), got)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("frame,hop", GEOMETRIES)
def test_mel_and_mfcc_match_oracle(frame, hop, window):
    g = geometry(frame, hop, window)
    frames = windowed_frames(frame, hop, window, seed=1)
    got_mel = tm.MelSpectrogram(device="cpu", **g)(frames).numpy()
    fb = oracle.mel_filterbank(26, 512, 16000)
    want_mel = np.log(np.maximum(np.abs(np.fft.rfft(frames, 512)) ** 2 @ fb.T, 1e-10))
    assert nmse(got_mel, want_mel) < 1e-8
    assert nmse(got_mel, np.asarray(jm.MelSpectrogram(**g)(frames))) <= 1e-10
    linear = tm.MelSpectrogram(log=False, device="cpu", **g)(frames).numpy()
    assert nmse(linear, np.asarray(jm.MelSpectrogram(log=False, **g)(frames))) <= 1e-10

    got_mfcc = tm.MFCC(device="cpu", **g)(frames).numpy()
    assert nmse(got_mfcc, oracle.mfcc(frames, 16000, lifter=22)) < 1e-5
    assert nmse(got_mfcc, np.asarray(jm.MFCC(**g)(frames))) <= 1e-10
    plain = tm.MFCC(lifter=None, num_ceps=20, num_filters=40, n_fft=1024,
                    device="cpu", **g)(frames).numpy()
    want = jm.MFCC(lifter=None, num_ceps=20, num_filters=40, n_fft=1024, **g)
    assert plain.shape == (frames.shape[0], 20)
    assert nmse(plain, np.asarray(want(frames))) <= 1e-10


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("frame,hop", GEOMETRIES)
def test_entropy_and_vad_models(frame, hop, window):
    g = geometry(frame, hop, window)
    frames = windowed_frames(frame, hop, window, seed=2)
    got = tm.SpectralEntropy(device="cpu", **g)(frames).numpy()
    assert nmse(got, oracle.spectral_entropy(frames, 512)) < 1e-6
    assert nmse(got, np.asarray(jm.SpectralEntropy(**g)(frames))) <= 1e-10

    e = oracle.short_time_energy(frames)
    z = oracle.zero_crossing_rate(frames)
    for e_th, z_th in ((1.0, 1.0), (float(np.median(e)), float(np.median(z)))):
        kw = dict(energy_threshold=e_th, zcr_threshold=z_th, **g)
        vad = tm.VADModel(device="cpu", **kw)(frames)
        assert vad.dtype == torch.bool
        np.testing.assert_array_equal(vad.numpy(),
                                      np.asarray(jm.VADModel(**kw)(frames)))
        # away from the energy threshold the oracle's float64 sums agree
        keep = np.abs(e - e_th) > 1e-4 * e_th
        np.testing.assert_array_equal(
            vad.numpy()[keep], oracle.fixed_vad(e, z, e_th, np.float32(z_th))[keep])


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("frame,hop", GEOMETRIES)
def test_frontend_bundle_and_from_signal(frame, hop, window):
    g = geometry(frame, hop, window)
    sig = signal(seed=3)
    fe = tm.SpeechFrontend(device="cpu", **g)
    out = fe.from_signal(sig)
    n = 1 + int(np.ceil((16000 - frame) / hop))
    assert tuple(out["mfcc"].shape) == (n, 13)
    assert tuple(out["energy"].shape) == (n,)
    want = jm.SpeechFrontend(**g).from_signal(sig)
    np.testing.assert_array_equal(out["zcr"].numpy(), np.asarray(want["zcr"]))
    for k in ("energy", "entropy", "mfcc"):
        assert nmse(out[k].numpy(), np.asarray(want[k])) <= 1e-10, k
    frames = fe.frames_of(sig)
    np.testing.assert_array_equal(
        frames.numpy(), np.asarray(jm.SpeechFrontend(**g).frames_of(sig)))
    # one spectrum serves MFCC and entropy: the bundle equals the single
    # transforms, bit for bit
    assert torch.equal(out["mfcc"], tm.MFCC(device="cpu", **g)(frames))
    assert torch.equal(out["entropy"], tm.SpectralEntropy(device="cpu", **g)(frames))
    assert nmse(out["mfcc"].numpy(),
                oracle.mfcc(frames.numpy(), 16000, lifter=22)) < 1e-5


@pytest.mark.parametrize("frame,hop", GEOMETRIES)
def test_frontend_is_a_second_implementation_beside_the_pipeline(frame, hop):
    """The modules do not route to the fused frames path: they agree with
    it (its plain version here) to rounding, and their ZCR (count / frame)
    is within one ulp of the pipeline's (count * f32(1/frame)), equal once
    both are turned back into counts."""
    sig = signal(seed=4)
    fe = tm.SpeechFrontend(frame_size=frame, hop_size=hop, device="cpu")
    out = fe.from_signal(sig)
    pipe = FeaturePipeline(FeatureConfig(frame_size=frame, hop_size=hop),
                           device="cpu")
    block, _ = pipe.process_signal(sig)
    # the pipeline keeps full frames only, the transform pads the tail:
    # compare the frames both have
    n = block.energy.shape[0]
    assert out["energy"].shape[0] - n in (0, 1)
    for k in ("energy", "entropy", "mfcc"):
        assert nmse(out[k][:n].numpy(), getattr(block, k)[:n].numpy()) <= 1e-9, k
    a, b = out["zcr"][:n].numpy(), block.zcr[:n].numpy()
    assert np.all(np.abs(a - b) <= np.spacing(np.maximum(a, b)))
    np.testing.assert_array_equal(np.rint(a * frame), np.rint(b * frame))


def test_modules_hold_their_constants_as_buffers():
    fe = tm.SpeechFrontend(device="cpu")
    names = {n for n, _ in fe.named_buffers()}
    assert {"window", "_mfcc.window", "_mfcc._cos", "_mfcc._sin",
            "_mfcc._fb_t", "_mfcc._dct", "_mfcc._lifter"} <= names
    assert not list(fe.parameters())
    j = jm.MFCC()
    t = tm.MFCC(device="cpu")
    for name in ("window", "_cos", "_sin", "_fb_t", "_dct", "_lifter"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), err_msg=name)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises((AssertionError, RuntimeError)):
            tm.Spectrogram()


@pytest.mark.parametrize("method", ["acf", "amdf"])
def test_pitch_transform_both_methods(method):
    sr = 16000
    t = np.arange(2 * sr) / sr
    sig = (np.sin(2 * np.pi * 200 * t) * 4000).astype(np.float32)
    model = tm.Pitch(method=method, device="cpu")
    f0, conf = model.from_signal(sig)
    # interior frames (tail zero-padding perturbs the last few)
    mid = f0.numpy()[2:-4]
    assert np.all(np.abs(mid - 200.0) < 4.0), (method, mid[:5])
    assert conf.numpy()[2:-4].min() > 0.4, method
    jf0, jconf = jm.Pitch(method=method).from_signal(sig)
    np.testing.assert_array_equal(mid, np.asarray(jf0)[2:-4])
    assert nmse(conf.numpy(), np.asarray(jconf)) <= 1e-10
    # frames_of does NOT window, unlike the spectral transforms
    raw = model.frames_of(sig)
    np.testing.assert_array_equal(raw.numpy()[0], sig[:320])


def test_pitch_transform_validation():
    with pytest.raises(ValueError):
        tm.Pitch(method="cepstrum", device="cpu")
    with pytest.raises(ValueError):
        tm.Pitch(fmin=10.0, fmax=20.0, device="cpu")  # empty lag band at 320
