#!/usr/bin/env python3
"""The port's L1 ops against the JAX package's, function for function.

The same seeded NumPy inputs go through ``sspv_tpu.ops`` (on its CPU
backend, eager or jitted as the function is defined) and through
``sspv_tpu_torch.ops`` on CPU tensors. Gates:

- EQUAL: windows and framing (one float32 multiply), pre-emphasis (one
  multiply and one subtraction, each rounded), the zero-crossing rate (a
  count over a true division), the fixed VAD, the adaptive VAD away from
  its thresholds (the means sum in different orders: a frame within
  rounding of a blended threshold could flip, so the inputs keep a margin),
  the hangover automaton;
- NMSE <= 1e-10 against JAX for every float sum (energy, the direct ACF,
  the AMDF, the power spectrum, MFCC, entropy, pitch confidence) and
  NMSE <= 1e-5 against the NumPy oracle (``tests/oracle.py``);
- discrete pitch picks: equal on the inputs of ``tests/test_pitch.py``
  (clean tones), and on >= 99.9 % of the frames of a noisy signal (two lags
  can tie to rounding; the inputs keep a noise floor).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sspv_tpu
import sspv_tpu.ops as jops
import sspv_tpu_torch
import sspv_tpu_torch.ops as tops
from sspv_tpu.ops import vad as jvad
from sspv_tpu_torch.ops import vad as tvad

import oracle

SR = 16000
GEOMETRIES = [(320, 160), (400, 160), (322, 161)]
WINDOWS = ["hamming", "hanning", "rectangular"]


def nmse(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


def speech(seconds=1.0, seed=0):
    """Gated 130 Hz tone with two harmonics over a noise floor."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    tone = (6000 * np.sin(2 * np.pi * 130 * t) + 2000 * np.sin(2 * np.pi * 260 * t)
            + 900 * np.sin(2 * np.pi * 390 * t))
    gate = ((t * 4).astype(int) % 2) == 1
    return (np.where(gate, tone, 0.0) + rng.normal(0, 200, t.size)).astype(np.float32)


def frames_of(frame, hop, window="hamming", seed=0, seconds=1.0):
    return np.asarray(jops.framing(speech(seconds, seed), frame, hop, window))


def T(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def tone_frames(freq, n_frames=20, frame_size=320, sr=SR):
    """The clean tones of tests/test_pitch.py."""
    t = np.arange(n_frames * 160 + frame_size) / sr
    sig = np.sin(2 * np.pi * freq * t).astype(np.float32)
    idx = np.arange(frame_size)[None, :] + 160 * np.arange(n_frames)[:, None]
    return sig[idx]


# -- the export lists -------------------------------------------------------

def test_export_lists_cover_the_jax_package():
    want = set(jops.__all__) - {"pitch_track_signal_jit"}
    assert want <= set(tops.__all__), want - set(tops.__all__)
    for name in tops.__all__:
        assert hasattr(tops, name), name
    assert "SignalProcessing" in sspv_tpu_torch.__all__
    assert "SignalProcessing" in sspv_tpu.__all__
    import sspv_tpu.models as jmodels
    import sspv_tpu.signal_processing as jsp
    import sspv_tpu_torch.models as tmodels
    import sspv_tpu_torch.signal_processing as tsp

    assert tsp.__all__ == jsp.__all__
    assert tmodels.__all__ == jmodels.__all__
    for name in ("SessionData", "load_session", "validate_session",
                 "RealTimeFactor", "device_trace"):
        assert name in sspv_tpu_torch.utils.__all__


# -- preprocessing ----------------------------------------------------------

@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("frame,hop", GEOMETRIES)
def test_framing_equals_jax(frame, hop, window):
    sig = speech(0.5, seed=frame)
    got = tops.framing(T(sig), frame, hop, window)
    want = np.asarray(jops.framing(sig, frame, hop, window))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    ref = oracle.framing(sig, frame, hop, tops.get_window(window, frame))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n", [0, 1, 319, 320, 321, 1000])
def test_framing_short_and_empty_inputs(n):
    sig = speech(0.1)[:n]
    got = tops.framing(T(sig), 320, 160)
    want = np.asarray(jops.framing(sig, 320, 160))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("alpha", [0.97, 0.5, 0.0])
@pytest.mark.parametrize("shape", [(0,), (1,), (1000,), (4, 320)])
def test_preemphasis_equals_jax(shape, alpha):
    x = np.random.default_rng(3).normal(0, 3000, shape).astype(np.float32)
    got = tops.preemphasis(T(x), alpha)
    want = np.asarray(jops.preemphasis(x, alpha))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if len(shape) == 1 and shape[0] > 1:
        assert nmse(got.numpy(), oracle.preemphasis(x, alpha)) <= 1e-10


# -- time features ----------------------------------------------------------

@pytest.mark.parametrize("window", ["hamming", "hanning"])
@pytest.mark.parametrize("frame,hop", GEOMETRIES)
def test_energy_and_zcr_match_jax(frame, hop, window):
    frames = frames_of(frame, hop, window, seed=hop)
    e = tops.calculate_short_time_energy(T(frames)).numpy()
    assert nmse(e, np.asarray(jops.calculate_short_time_energy(frames))) <= 1e-10
    assert nmse(e, oracle.short_time_energy(frames)) <= 1e-5
    # raw frames for the crossings: a Hann window has zeros at both ends
    raw = np.asarray(jops.frame_signal(speech(1.0, hop), frame, hop))
    for x in (frames, raw):
        z = tops.calculate_zero_crossing_rate(T(x)).numpy()
        assert z.dtype == np.float32
        # the eager JAX call divides, and so does the port's L1 op
        np.testing.assert_array_equal(
            z, np.asarray(jops.calculate_zero_crossing_rate(x)))
        np.testing.assert_array_equal(z, oracle.zero_crossing_rate(x))


def test_zcr_divides_where_the_pipeline_multiplies():
    """Every count 0..frame-1 over the frame length: the L1 op's true
    division equals NumPy's, and differs from count * f32(1/frame) (what
    the pipeline's kernels compute) for some counts at 400 samples."""
    frame = 400
    x = np.ones((frame, frame), np.float32)
    for c in range(frame):  # row c alternates for c samples, then holds
        x[c, 1:c + 1] = np.where(np.arange(c) % 2 == 0, -1.0, 1.0)
        x[c, c + 1:] = x[c, c]
    z = tops.calculate_zero_crossing_rate(T(x)).numpy()
    counts = np.arange(frame, dtype=np.float32)
    np.testing.assert_array_equal(z, counts / np.float32(frame))
    assert np.any(z != counts * (np.float32(1) / np.float32(frame)))


@pytest.mark.parametrize("op", ["energy", "zcr"])
def test_energy_zcr_empty_shapes(op):
    fn = {"energy": tops.calculate_short_time_energy,
          "zcr": tops.calculate_zero_crossing_rate}[op]
    for shape in ((0, 320), (0,), (3, 0)):
        out = fn(torch.zeros(shape))
        assert tuple(out.shape) == (0,) and out.dtype == torch.float32


@pytest.mark.parametrize("max_lag", [0, 32, 200, 319])
@pytest.mark.parametrize("frame,hop", GEOMETRIES)
def test_direct_acf_matches_jax(frame, hop, max_lag):
    frames = frames_of(frame, hop, "rectangular", seed=max_lag)[:40]
    got = tops.calculate_short_time_autocorrelation(T(frames), max_lag).numpy()
    want = np.asarray(jops.calculate_short_time_autocorrelation(frames, max_lag))
    assert got.shape == want.shape == (40, max_lag + 1)
    assert nmse(got, want) <= 1e-10
    assert nmse(got, oracle.autocorrelation(frames, max_lag)) <= 1e-5
    # the Wiener-Khinchin form agrees to float32-matmul accuracy
    dft = tops.autocorrelation_via_dft(T(frames), max_lag).numpy()
    assert nmse(dft, got) < 1e-9


@pytest.mark.parametrize("max_lag,lag_start", [(40, 1), (320, 40), (200, 7),
                                               (10, 11)])
def test_amdf_matches_jax(max_lag, lag_start):
    frames = frames_of(400, 160, "rectangular", seed=5)[:30]
    got = tops.calculate_average_magnitude_difference(
        T(frames), max_lag, lag_start).numpy()
    want = np.asarray(jops.calculate_average_magnitude_difference(
        frames, max_lag, lag_start))
    assert got.shape == want.shape == (30, max(0, max_lag - lag_start + 1))
    if got.size:
        assert nmse(got, want) <= 1e-10
        full = oracle.amdf(frames, max_lag)[:, lag_start - 1:]
        assert nmse(got, full) <= 1e-5
    # the banded call is the full call's columns, bit for bit
    whole = tops.calculate_average_magnitude_difference(T(frames), max_lag)
    np.testing.assert_array_equal(got, whole.numpy()[:, lag_start - 1:])


def test_acf_and_amdf_degenerate_shapes():
    for frames in (np.zeros((0, 320), np.float32), np.zeros((320,), np.float32)):
        for max_lag in (10, -1):
            got = tops.calculate_short_time_autocorrelation(T(frames), max_lag)
            want = np.asarray(
                jops.calculate_short_time_autocorrelation(frames, max_lag))
            assert tuple(got.shape) == want.shape
            got = tops.calculate_average_magnitude_difference(T(frames), max_lag)
            want = np.asarray(
                jops.calculate_average_magnitude_difference(frames, max_lag))
            assert tuple(got.shape) == want.shape


# -- frequency features -----------------------------------------------------

@pytest.mark.parametrize("filters,n_fft,fmin,fmax", [
    (26, 512, 0.0, None), (40, 1024, 0.0, None), (26, 512, 100.0, 4000.0)])
def test_mel_filterbank_equals_jax(filters, n_fft, fmin, fmax):
    got = tops.mel_filterbank(filters, n_fft, SR, fmin, fmax, device="cpu")
    want = np.asarray(jops.mel_filterbank(filters, n_fft, SR, fmin, fmax))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_fft", [512, 1024, 256])
@pytest.mark.parametrize("frame,hop", GEOMETRIES)
def test_power_spectrum_matches_jax(frame, hop, n_fft):
    """n_fft 256 is shorter than every frame: rfft(n=...) truncates in both."""
    frames = frames_of(frame, hop, seed=n_fft)
    got = tops.power_spectrum(T(frames), n_fft).numpy()
    want = np.asarray(jops.power_spectrum(frames, n_fft))
    assert got.shape == want.shape == (frames.shape[0], n_fft // 2 + 1)
    assert got.dtype == np.float32
    assert nmse(got, want) <= 1e-10
    assert nmse(got, np.abs(np.fft.rfft(frames, n=n_fft)) ** 2) <= 1e-5


@pytest.mark.parametrize("window", ["hamming", "hanning"])
@pytest.mark.parametrize("frame,hop", GEOMETRIES)
def test_mfcc_and_entropy_match_jax(frame, hop, window):
    frames = frames_of(frame, hop, window, seed=frame + hop)
    got = tops.compute_mfcc(T(frames), SR).numpy()
    want = np.asarray(jops.compute_mfcc(frames, SR))
    assert got.shape == want.shape == (frames.shape[0], 13)
    assert nmse(got, want) <= 1e-10
    assert nmse(got, oracle.mfcc(frames, SR)) <= 1e-5
    ent = tops.calculate_spectral_entropy(T(frames)).numpy()
    assert nmse(ent, np.asarray(jops.calculate_spectral_entropy(frames))) <= 1e-10
    assert nmse(ent, oracle.spectral_entropy(frames)) <= 1e-5


@pytest.mark.parametrize("kw", [
    dict(n_fft=1024, num_filters=40, num_ceps=20),
    dict(num_filters=20, num_ceps=30),          # clamped to 20 coefficients
    dict(fmin=100.0, fmax=6000.0),
])
def test_mfcc_options_match_jax(kw):
    frames = frames_of(400, 160, seed=9)[:50]
    got = tops.compute_mfcc(T(frames), SR, **kw).numpy()
    want = np.asarray(jops.compute_mfcc(frames, SR, **kw))
    assert got.shape == want.shape
    assert nmse(got, want) <= 1e-10


def test_mfcc_and_entropy_empty_shapes():
    empty = torch.zeros((0, 320))
    # the empty return keeps the caller's num_ceps, unclamped
    assert tuple(tops.compute_mfcc(empty, SR, num_filters=20,
                                   num_ceps=30).shape) == (0, 30)
    assert np.asarray(jops.compute_mfcc(np.zeros((0, 320), np.float32), SR,
                                        num_filters=20, num_ceps=30)).shape == (0, 30)
    assert tuple(tops.calculate_spectral_entropy(empty).shape) == (0,)


# -- VAD --------------------------------------------------------------------

def vad_features(n=400, seed=0):
    rng = np.random.default_rng(seed)
    voiced = rng.random(n) < 0.4
    energy = np.where(voiced, rng.uniform(2e3, 1e7, n),
                      rng.uniform(0, 900, n)).astype(np.float32)
    zcr = np.where(voiced, rng.uniform(0.01, 0.25, n),
                   rng.uniform(0.2, 0.5, n)).astype(np.float32)
    return energy, zcr


@pytest.mark.parametrize("e_th,z_th", [(1000.0, 0.3), (2500, 0.12), (0.0, 1.0)])
def test_fixed_vad_equals_jax(e_th, z_th):
    e, z = vad_features(seed=int(e_th))
    # values exactly at the thresholds: strict comparisons on both sides
    e[:3], z[3:6] = e_th, z_th
    got = tops.voice_activity_detection(T(e), T(z), e_th, z_th)
    want = np.asarray(jops.voice_activity_detection(e, z, e_th, z_th))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), oracle.fixed_vad(e, z, np.float32(e_th), np.float32(z_th)))


def _margin(values, th, rel=1e-4):
    """Drop the frames within ``rel`` of a threshold: both packages decide
    in float32 from means summed in different orders."""
    return np.abs(values - th) > rel * max(abs(th), 1e-12)


@pytest.mark.parametrize("alpha", [0.8, 0.0, 0.5, 1.7, -2.0])
@pytest.mark.parametrize("history", ["long", "empty", "none"])
def test_adaptive_vad_equals_jax(alpha, history):
    e, z = vad_features(seed=11)
    hist_e, hist_z = {"long": vad_features(256, seed=12),
                      "empty": (np.zeros(0, np.float32),) * 2,
                      "none": (None, None)}[history]
    got = tops.adaptive_voice_activity_detection(
        T(e), T(z), hist_e if hist_e is None else T(hist_e),
        hist_z if hist_z is None else T(hist_z), alpha=alpha).numpy()
    want = np.asarray(jops.adaptive_voice_activity_detection(
        e, z, hist_e, hist_z, alpha=alpha))
    a = max(0.0, min(alpha, 0.99))  # the clamp
    he = e.mean() if hist_e is None or hist_e.size == 0 else hist_e.mean()
    hz = z.mean() if hist_z is None or hist_z.size == 0 else hist_z.mean()
    keep = _margin(e, max(1e-6, a * he + (1 - a) * e.mean())) & _margin(
        z, min(0.5, a * hz + (1 - a) * z.mean()))
    assert keep.mean() > 0.95
    np.testing.assert_array_equal(got[keep], want[keep])
    ref = oracle.adaptive_vad(e, z, [] if hist_e is None else hist_e,
                              [] if hist_z is None else hist_z, alpha=alpha)
    np.testing.assert_array_equal(got[keep], ref[keep])
    assert got.any() and not got.all()


def test_adaptive_vad_takes_sequences_floors_and_ceilings():
    e = np.array([5000.0, 100.0, 3e-7], np.float32)
    z = np.array([0.02, 0.02, 0.6], np.float32)
    got = tops.adaptive_voice_activity_detection(
        T(e), T(z), [200.0] * 30, [0.03] * 30, alpha=0.8)
    want = np.asarray(jops.adaptive_voice_activity_detection(
        e, z, [200.0] * 30, [0.03] * 30, alpha=0.8))
    np.testing.assert_array_equal(got.numpy(), want)
    # the floor and the ceiling: a silent history cannot open the gate
    quiet = tops.adaptive_voice_activity_detection(
        torch.tensor([5e-7, 2e-6]), torch.tensor([0.7, 0.4]), [0.0], [0.9],
        alpha=0.99)
    np.testing.assert_array_equal(quiet.numpy(), [False, True])


@pytest.mark.parametrize("seed", range(8))
def test_hangover_smooth_equals_its_scan(seed):
    """The parallel form against the port's own sequential automaton over
    randomised (on, off), on == 0 and off in {0, 1} included, and the
    automaton against the JAX package's lax.scan."""
    rng = np.random.default_rng(seed)
    pairs = [(0, 0), (0, 3), (3, 0), (3, 1)] + [
        (int(rng.integers(0, 7)), int(rng.integers(0, 7))) for _ in range(4)]
    on, off = pairs[seed]
    v = rng.random(700) < rng.choice([0.05, 0.3, 0.7])
    par, _ = tvad.hangover_smooth(
        T(v), torch.tensor(-(on + 1), dtype=torch.int32), on, off)
    seq, (hold, run) = tvad.hangover_smooth_scan(T(v), 0, 0, on, off)
    assert seq.dtype == torch.int32 and hold.dtype == torch.int32
    np.testing.assert_array_equal(par.numpy(), seq.numpy(),
                                  err_msg=f"on={on} off={off}")
    jseq, (jhold, jrun) = jvad.hangover_smooth_scan(
        jnp.asarray(v), jnp.int32(0), jnp.int32(0), on, off)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    assert (int(hold), int(run)) == (int(jhold), int(jrun))
    # carried across a split, the automaton gives the same decisions
    a, (h1, r1) = tvad.hangover_smooth_scan(T(v[:300]), 0, 0, on, off)
    b, _ = tvad.hangover_smooth_scan(T(v[300:]), h1, r1, on, off)
    np.testing.assert_array_equal(torch.cat([a, b]).numpy(), seq.numpy())


# -- pitch ------------------------------------------------------------------

@pytest.mark.parametrize("freq", [100.0, 150.0, 220.0, 330.0])
@pytest.mark.parametrize("impl", ["direct", "dft", "amdf"])
def test_pitch_recovers_tone_frequency(freq, impl):
    frames = tone_frames(freq)
    if impl == "amdf":
        f0, conf = tops.pitch_from_frames_amdf(T(frames), SR)
        jf0, jconf = jops.pitch_from_frames_amdf(frames, SR)
        floor = 0.5
    else:
        f0, conf = tops.pitch_from_frames(T(frames), SR, acf_impl=impl)
        jf0, jconf = jops.pitch_from_frames(frames, SR, acf_impl=impl)
        floor = 0.45
    tol = freq * freq / SR + 1.0
    assert np.all(np.abs(f0.numpy() - freq) < tol), (freq, f0[:3])
    assert np.all(conf.numpy() >= floor)
    np.testing.assert_array_equal(f0.numpy(), np.asarray(jf0))
    assert nmse(conf.numpy(), np.asarray(jconf)) <= 1e-10


def test_pitch_defaults_are_the_jax_defaults():
    """acf_impl: "direct" on frames, "dft" on a signal, in both packages."""
    import inspect

    from sspv_tpu.ops import pitch as jp
    from sspv_tpu_torch.ops import pitch as tp

    def default(fn, name="acf_impl"):
        fn = getattr(fn, "__wrapped__", fn)
        return inspect.signature(fn).parameters[name].default

    for name in ("pitch_from_frames", "pitch_track", "pitch_track_gated",
                 "pitch_track_signal"):
        assert default(getattr(tp, name)) == default(getattr(jp, name)), name
    assert default(tp.pitch_from_frames) == "direct"
    assert default(tp.pitch_track_signal) == "dft"
    assert default(tp.pitch_track_amdf, "min_confidence") == \
        default(jp.pitch_track_amdf, "min_confidence") == 0.25
    frames = T(tone_frames(180.0))
    a = tops.pitch_from_frames(frames)
    b = tops.pitch_from_frames(frames, acf_impl="direct")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("impl", ["direct", "dft", "amdf"])
@pytest.mark.parametrize("frame,hop", GEOMETRIES)
def test_pitch_picks_on_a_noisy_signal(frame, hop, impl):
    """Discrete picks against the JAX function on 6 s of gated tone over a
    noise floor: >= 99.9 % of frames pick the same lag (a tie between two
    lags to rounding may go either way), confidence NMSE <= 1e-10."""
    frames = np.asarray(jops.frame_signal(speech(6.0, seed=frame), frame, hop))
    if impl == "amdf":
        f0, conf = tops.pitch_from_frames_amdf(T(frames), SR)
        jf0, jconf = jops.pitch_from_frames_amdf(frames, SR)
    else:
        f0, conf = tops.pitch_from_frames(T(frames), SR, acf_impl=impl)
        jf0, jconf = jops.pitch_from_frames(frames, SR, acf_impl=impl)
    same = f0.numpy() == np.asarray(jf0)
    assert same.mean() >= 0.999, same.mean()
    assert nmse(conf.numpy()[same], np.asarray(jconf)[same]) <= 1e-10
    voiced = ((np.arange(frames.shape[0]) * hop / SR * 4).astype(int) % 2) == 1
    inner = voiced & np.roll(voiced, 3) & np.roll(voiced, -3)
    assert abs(np.median(f0.numpy()[inner]) - 130.0) < 5.0


def test_direct_and_dft_pick_the_same_track():
    for freq in (100.0, 220.0, 330.0):
        frames = T(tone_frames(freq))
        f0_d, _ = tops.pitch_from_frames(frames, SR, acf_impl="direct")
        f0_f, _ = tops.pitch_from_frames(frames, SR, acf_impl="dft")
        np.testing.assert_allclose(f0_d.numpy(), f0_f.numpy())
    frames = T(np.asarray(jops.frame_signal(speech(4.0, 8), 320, 160)))
    f0_d, c_d = tops.pitch_from_frames(frames, SR, acf_impl="direct")
    f0_f, c_f = tops.pitch_from_frames(frames, SR, acf_impl="dft")
    assert (f0_d == f0_f).float().mean() >= 0.999
    assert nmse(c_f.numpy(), c_d.numpy()) < 1e-9


@pytest.mark.parametrize("impl", ["direct", "dft"])
@pytest.mark.parametrize("frame,hop", GEOMETRIES)
def test_pitch_track_signal_matches_jax(frame, hop, impl):
    """Both ACF forms through the signal-level entry point: the view
    geometries (320/160, 322/161) take the rows view for "dft", everything
    else the streaming frames."""
    sig = speech(2.0, seed=hop)
    n = 1 + (sig.size - frame) // hop
    vad = (np.random.default_rng(1).random(n) > 0.3).astype(np.int32)
    f0, conf = tops.pitch_track_signal(T(sig), vad, frame, hop, acf_impl=impl)
    jf0, jconf = jops.pitch_track_signal(sig, vad, frame, hop, acf_impl=impl)
    assert tuple(f0.shape) == (n,)
    same = f0.numpy() == np.asarray(jf0)
    assert same.mean() >= 0.999
    assert nmse(conf.numpy(), np.asarray(jconf)) <= 1e-9
    assert np.all(f0.numpy()[vad == 0] == 0.0)
    # the gated twin and the rows view give the same track
    g0, gc = tops.pitch_track_signal_gated(T(sig), vad, 0.3, frame_size=frame,
                                           hop_size=hop, acf_impl=impl)
    assert torch.equal(g0, f0) and torch.equal(gc, conf)
    if frame == 2 * hop:
        rows = T(sig[: (n + 1) * hop].reshape(n + 1, hop))
        r0, rc = tops.pitch_track_signal(rows, vad, frame, hop, acf_impl=impl)
        assert torch.equal(r0, f0) and torch.equal(rc, conf)


def test_pitch_tracks_gate_on_vad_and_confidence():
    rng = np.random.default_rng(0)
    voiced = tone_frames(120.0, n_frames=10)
    noise = rng.normal(0, 1.0, (10, 320)).astype(np.float32)
    frames = np.concatenate([voiced, noise])
    vad = np.array([1] * 10 + [0] * 10)
    for track, jtrack in ((tops.pitch_track, jops.pitch_track),
                          (tops.pitch_track_amdf, jops.pitch_track_amdf)):
        f0, conf = track(T(frames), vad, SR)
        jf0, jconf = jtrack(frames, vad, SR)
        np.testing.assert_array_equal(f0.numpy(), np.asarray(jf0))
        assert np.all(f0.numpy()[:10] > 0) and np.all(f0.numpy()[10:] == 0)
        assert conf[:10].mean() > conf[10:].mean()
    # min_confidence above every peak: nothing passes; a traced-style gate
    f0, _ = tops.pitch_track(T(frames), np.ones(20, np.int32), SR,
                             min_confidence=2.0)
    assert not f0.any()
    g0, _ = tops.pitch_track_gated(T(frames), vad, 0.3, acf_impl="dft")
    j0, _ = jops.pitch_track_gated(frames, vad, 0.3, acf_impl="dft")
    np.testing.assert_array_equal(g0.numpy(), np.asarray(j0))


def test_amdf_silence_and_validation():
    zero = torch.zeros((3, 320))
    _, conf = tops.pitch_from_frames_amdf(zero, SR)
    np.testing.assert_array_equal(conf.numpy(), 0.0)
    with pytest.raises(ValueError):
        tops.pitch_from_frames_amdf(torch.zeros((2, 64)), SR, 20.0, 40.0)
    with pytest.raises(ValueError, match="empty pitch lag band"):
        tops.pitch_from_frames(torch.zeros((4, 32)), SR)
    with pytest.raises(ValueError, match="empty pitch lag band"):
        tops.pitch_track_signal(torch.zeros(16000), np.ones(99, np.int32),
                                fmin=30.0, fmax=50.0)
    f0, conf = tops.pitch_from_frames_amdf(torch.zeros((0, 320)), SR)
    assert tuple(f0.shape) == tuple(conf.shape) == (0,)


def test_amdf_agrees_with_acf_on_voiced_frames():
    frames = T(tone_frames(180.0, n_frames=30))
    acf_f0, _ = tops.pitch_from_frames(frames, SR)
    amdf_f0, _ = tops.pitch_from_frames_amdf(frames, SR)
    assert np.all(np.abs(acf_f0.numpy() - amdf_f0.numpy()) < 5.0)
