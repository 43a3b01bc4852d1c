#!/usr/bin/env python3
"""The view kernels' wrappers on CPU tensors (their plain PyTorch versions)
against the JAX package and the NumPy oracle.

Tolerances, each with its reason:

- vs the JAX XLA view path (``FeaturePipeline._features_from_rows``,
  compiled as the JAX pipeline compiles it; on the CPU backend its matmuls
  are float32): zcr EXACTLY equal (an integer count times the same float32
  reciprocal), energy/entropy/mfcc NMSE <= 1e-9 (both float32, different
  summation order: observed ~1e-13).
- vs the JAX Pallas kernel in interpret mode: NMSE <= 1e-7, the JAX suite's
  own gate for that kernel (its products are 3-pass bf16).
- vs the float64 NumPy oracle: NMSE <= 1e-7, the same gate.
- pitch: F0 equal on >= 99.9 % of frames (an argmax flips only where two
  lags tie to rounding; at these sizes that means every frame), confidence
  NMSE <= 1e-9 vs the XLA track and <= 1e-7 vs the bf16 kernel.
"""

import jax
import numpy as np
import pytest
import torch

from sspv_tpu.ops import pallas_view
from sspv_tpu.ops.pipeline import FeatureConfig as JConfig
from sspv_tpu.ops.pipeline import FeaturePipeline as JPipeline
from sspv_tpu.ops.pitch import pitch_track_signal as j_pitch_track_signal
from sspv_tpu_torch.ops import view_kernels as vk
from sspv_tpu_torch.ops.pipeline import FeaturePipeline as TPipeline

import oracle

SIZES = (1, 3, 511, 513)
HOP = 160


def _nmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


@pytest.fixture(scope="module")
def pipes():
    jp = JPipeline(JConfig())
    return jp, TPipeline(device="cpu"), jax.jit(jp._features_from_rows)


def _speech_rows(n, seed):
    """Rows of noise with 130 Hz voiced stretches (so pitch has peaks)."""
    rng = np.random.default_rng(seed)
    t = np.arange(HOP * (n + 1)) / 16000
    sig = np.where(((t * 8).astype(int) % 2) == 1,
                   5000 * np.sin(2 * np.pi * 130 * t),
                   rng.normal(0, 1000, t.size))
    return sig.astype(np.float32).reshape(n + 1, HOP)


def _port_features(tp, rows):
    out = vk.fused_view_features(torch.from_numpy(rows), **tp._view_consts)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("n", SIZES)
def test_features_match_jax_xla_view_path(pipes, n):
    jp, tp, j_rows = pipes
    rows = _speech_rows(n, seed=n)
    got = _port_features(tp, rows)
    want = {k: np.asarray(v) for k, v in j_rows(rows).items()}
    assert got["mfcc"].shape == (n, 13) and got["energy"].shape == (n,)
    np.testing.assert_array_equal(got["zcr"], want["zcr"])
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(got[k], want[k]) <= 1e-9, k


@pytest.mark.parametrize("n", SIZES)
def test_features_match_jax_pallas_kernel(pipes, n):
    jp, tp, _ = pipes
    rows = _speech_rows(n, seed=100 + n)
    got = _port_features(tp, rows)
    want = pallas_view.fused_view_features(
        rows, wm=jp._wm, wnyq=jp._wnyq, fb_t=jp._fb_t, dct=jp._dct,
        lifter=jp._lifter, window=jp._window,
    )
    for k in ("energy", "zcr", "entropy", "mfcc"):
        assert _nmse(got[k], np.asarray(want[k])) <= 1e-7, k


@pytest.mark.parametrize("n", SIZES)
def test_features_match_numpy_oracle(pipes, n):
    _, tp, _ = pipes
    rows = _speech_rows(n, seed=200 + n)
    got = _port_features(tp, rows)
    frames = oracle.framing(rows.reshape(-1), 320, HOP, oracle.hamming(320))[:n]
    want = {
        "energy": oracle.short_time_energy(frames),
        "zcr": oracle.zero_crossing_rate(frames),
        "entropy": oracle.spectral_entropy(frames, 512),
        "mfcc": oracle.mfcc(frames, 16000, lifter=22),
    }
    for k, w in want.items():
        assert _nmse(got[k], w) <= 1e-7, k


def _port_pitch(tp, rows):
    f0, conf = vk.fused_view_pitch(
        torch.from_numpy(rows), **_pitch_kwargs(tp)
    )
    return f0.numpy(), conf.numpy()


def _pitch_kwargs(tp):
    merged, nyq_b, inv_live, inv_nyq = tp._acf_bases(319)
    return dict(merged=merged, nyq_b=nyq_b, inv_live=inv_live,
                inv_nyq=inv_nyq, lag_min=40, lag_max=319, sample_rate=16000)


@pytest.mark.parametrize("use_kernel,conf_gate", [(False, 1e-9), (True, 1e-7)])
@pytest.mark.parametrize("n", SIZES)
def test_pitch_matches_jax_track(pipes, n, use_kernel, conf_gate):
    """Ungated track (vad on, no confidence floor) of the port vs the JAX
    package's XLA track (use_kernel=False) and its Pallas kernel in
    interpret mode (use_kernel=True)."""
    _, tp, _ = pipes
    rows = _speech_rows(n, seed=300 + n)
    f0, conf = _port_pitch(tp, rows)
    jf0, jconf = j_pitch_track_signal(
        rows, np.ones(n, np.int32), min_confidence=float("-inf"),
        use_kernel=use_kernel,
    )
    assert f0.shape == conf.shape == (n,)
    assert np.mean(f0 == np.asarray(jf0)) >= 0.999
    assert _nmse(conf, np.asarray(jconf)) <= conf_gate


def test_pitch_of_zero_frames(pipes):
    """All-zero frames (bucket padding) give f0 = sr / lag_min and conf 0,
    as the JAX kernel does."""
    _, tp, _ = pipes
    rows = np.zeros((9, HOP), np.float32)
    f0, conf = _port_pitch(tp, rows)
    np.testing.assert_array_equal(f0, np.full(8, np.float32(16000 / 40)))
    np.testing.assert_array_equal(conf, np.zeros(8, np.float32))
    jf0, jconf = j_pitch_track_signal(
        rows, np.ones(8, np.int32), min_confidence=float("-inf"),
        use_kernel=True,
    )
    np.testing.assert_array_equal(f0, np.asarray(jf0))
    np.testing.assert_array_equal(conf, np.asarray(jconf))


def test_plain_row_blocks_equal_one_block(pipes):
    """The plain versions' row blocking (bounded intermediates on long
    signals) leaves every frame's value as it was, up to the summation order
    BLAS picks for another number of rows (NMSE <= 1e-12; zcr exact)."""
    _, tp, _ = pipes
    rows = torch.from_numpy(_speech_rows(700, seed=9))
    one = vk.view_features_plain(rows, **tp._view_consts)
    many = vk.view_features_plain(rows, **tp._view_consts, block_frames=256)
    assert torch.equal(many["zcr"], one["zcr"])
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(many[k], one[k]) <= 1e-12, k
    f0_one, conf_one = vk.view_pitch_plain(rows, **_pitch_kwargs(tp))
    f0_many, conf_many = vk.view_pitch_plain(
        rows, **_pitch_kwargs(tp), block_frames=256
    )
    assert torch.equal(f0_many, f0_one)
    assert _nmse(conf_many, conf_one) <= 1e-12
