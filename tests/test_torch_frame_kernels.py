#!/usr/bin/env python3
"""The frames-path kernel's wrapper on CPU tensors (its plain PyTorch
version) against the JAX package and the NumPy oracle.

Cases: the 320/160 engine framing and the 400/160 ASR framing with a
Hamming window, 400 with a Hann window (zeros at both ends, so the ZCR of
the windowed frame differs from the raw frame's), and 400 with a separate
1024-point entropy spectrum.

Tolerances, each with its reason:

- vs the JAX Pallas kernel ``fused_features`` in interpret mode (as
  ``tests/test_pallas_fused.py`` runs it): zcr within 1 ulp (the kernel may
  divide where the port multiplies by the reciprocal), energy/entropy/mfcc
  NMSE <= 1e-9 (both float32, different summation order: observed ~1e-13).
- vs the jitted JAX ``FeaturePipeline.features`` (XLA, float32 on the
  CPU): zcr EXACTLY equal (the same integer count times the same float32
  reciprocal), energy/entropy/mfcc NMSE <= 1e-9.
- vs the float64 NumPy oracle: NMSE <= 1e-7, the JAX suite's gate.
"""

import numpy as np
import pytest
import torch

from sspv_tpu.ops.pallas_kernels import fused_features as j_fused_features
from sspv_tpu.ops.pipeline import FeatureConfig as JConfig
from sspv_tpu.ops.pipeline import FeaturePipeline as JPipeline
from sspv_tpu_torch.ops import frame_kernels as fk
from sspv_tpu_torch.ops.pipeline import FeatureConfig as TConfig
from sspv_tpu_torch.ops.pipeline import FeaturePipeline as TPipeline

import oracle

CASES = {
    "hamming_320": dict(frame_size=320, hop_size=160),
    "hamming_400": dict(frame_size=400, hop_size=160),
    "hann_400": dict(frame_size=400, hop_size=160, window_type="hanning"),
    "entropy_1024": dict(frame_size=400, hop_size=160, entropy_n_fft=1024),
}
SIZES = (1, 3, 8, 257)


def _nmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


@pytest.fixture(scope="module")
def pipes():
    return {k: (JPipeline(JConfig(**g)), TPipeline(TConfig(**g), device="cpu"))
            for k, g in CASES.items()}


def _frames(n, frame, seed):
    """Noise, a 130 Hz tone over the noise in every third frame, and a few
    silent frames. (A pure tone under a Hann window leaves bands whose
    power lies below float32 rounding of the DFT, where the log spectrum
    is noise in any implementation: the noise floor keeps every band
    well-conditioned.)"""
    rng = np.random.default_rng(seed)
    t = np.arange(frame) / 16000
    x = rng.normal(0, 1000, (n, frame))
    phase = rng.uniform(0, 6, (len(x[1::3]), 1))
    x[1::3] += 5000 * np.sin(2 * np.pi * 130 * t + phase)
    x[2::5] = 0.0
    return x.astype(np.float32)


def _port(tp, frames):
    out = fk.fused_features(torch.from_numpy(frames), **tp._frame_consts)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_pallas_kernel(pipes, case, n):
    jp, tp = pipes[case]
    frames = _frames(n, jp.cfg.frame_size, seed=n)
    got = _port(tp, frames)
    want = j_fused_features(
        frames, wc=jp._wc, ws=jp._ws, fb_t=jp._fb_t, dct=jp._dct,
        lifter=jp._lifter, window=jp._window,
        entropy_bases=(jp._wc_ent, jp._ws_ent),
    )
    want = {k: np.asarray(v) for k, v in want.items()}
    assert got["mfcc"].shape == (n, 13) and got["energy"].shape == (n,)
    ulp = np.spacing(np.float32(1.0))
    assert np.all(np.abs(got["zcr"] - want["zcr"]) <= ulp)
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(got[k], want[k]) <= 1e-9, k


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_features_jitted(pipes, case, n):
    jp, tp = pipes[case]
    frames = _frames(n, jp.cfg.frame_size, seed=10 + n)
    got = tp.features(frames)
    want = {k: np.asarray(v) for k, v in jp.features(frames).items()}
    np.testing.assert_array_equal(got["zcr"].numpy(), want["zcr"])
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(got[k].numpy(), want[k]) <= 1e-9, k


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_numpy_oracle(pipes, case):
    _, tp = pipes[case]
    c = tp.cfg
    raw = _frames(64, c.frame_size, seed=7)
    got = _port(tp, raw)
    windowed = (raw * tp._window.numpy()).astype(np.float32)
    want = {
        "energy": oracle.short_time_energy(windowed),
        "zcr": oracle.zero_crossing_rate(windowed),
        "entropy": oracle.spectral_entropy(windowed, c.entropy_n_fft),
        "mfcc": oracle.mfcc(windowed, 16000, lifter=22),
    }
    for k, w in want.items():
        assert _nmse(got[k], w) <= 1e-7, k


def test_hann_zcr_counts_the_windowed_frame(pipes):
    """A Hann window's zeros at both ends change the sign-change count of
    the windowed frame against the raw one: the port counts x*w, as the
    JAX kernel does."""
    _, tp = pipes["hann_400"]
    x = np.full((1, 400), -100.0, np.float32)  # no sign change at all
    assert oracle.zero_crossing_rate(x)[0] == 0.0
    # the window's zeros at both ends: sign 0 -> -1 and -1 -> 0
    zcr = _port(tp, x)["zcr"][0]
    assert zcr == np.float32(2) * (np.float32(1) / np.float32(400))


def test_zero_frames_are_finite(pipes):
    """Bucket padding: all-zero frames give energy 0, zcr 0 and finite
    entropy and mfcc (the mel clamp and the 1e-12 entropy floor)."""
    for _, tp in pipes.values():
        out = _port(tp, np.zeros((5, tp.cfg.frame_size), np.float32))
        assert not out["energy"].any() and not out["zcr"].any()
        assert all(np.isfinite(v).all() for v in out.values())


def test_separate_entropy_spectrum(pipes):
    """With entropy_n_fft != n_fft the entropy comes from the separate
    spectrum (the kernel zero-fills its own and the wrapper computes it):
    not the n_fft spectrum's entropy; the other features are unchanged."""
    _, tp = pipes["entropy_1024"]
    frames = torch.from_numpy(_frames(9, 400, seed=3))
    consts = dict(tp._frame_consts)
    wce, wse = consts.pop("entropy_bases")
    shared = fk.frame_features_plain(frames, **consts)
    got = fk.fused_features(frames, **tp._frame_consts)
    np.testing.assert_array_equal(
        got["entropy"].numpy(), fk._separate_entropy(frames, wce, wse).numpy()
    )
    assert not np.allclose(got["entropy"].numpy(), shared["entropy"].numpy())
    for k in ("energy", "zcr", "mfcc"):
        assert torch.equal(got[k], shared[k])


def test_plain_blocks_equal_one_block(pipes):
    """The plain version's frame blocking (bounded intermediates) leaves
    every frame's value as it was, up to the summation order BLAS picks for
    another number of rows (NMSE <= 1e-12; zcr exact)."""
    _, tp = pipes["hamming_400"]
    frames = torch.from_numpy(_frames(700, 400, seed=9))
    one = fk.frame_features_plain(frames, **tp._frame_consts)
    many = fk.frame_features_plain(frames, **tp._frame_consts, block_frames=256)
    assert torch.equal(many["zcr"], one["zcr"])
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(many[k], one[k]) <= 1e-12, k
