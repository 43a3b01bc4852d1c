#!/usr/bin/env python3
"""View geometries the view kernels do not take, on the CPU, against the
JAX package's XLA view path.

Frame = 2·hop with a strictly positive window routes to the view path in
both packages. K1 also needs hop % 4 == 0, an even n_fft and a shared
entropy spectrum; the port runs the view routes of the three geometries
without them (322/161, 320/160 with n_fft 511, 320/160 with entropy_n_fft
1024) through K3 on the frames formed on the device. K2 takes the pitch of
all three on the rows view, as the JAX package's K2 does. Tolerances: zcr
EXACTLY equal, energy/entropy/mfcc NMSE <= 1e-9, VAD decisions and the state's integer scalars IDENTICAL, F0
identical on every frame, confidence NMSE <= 1e-9.
"""

import numpy as np
import pytest

from sspv_tpu.ops.pipeline import FeatureConfig as JConfig
from sspv_tpu.ops.pipeline import FeaturePipeline as JPipeline
from sspv_tpu_torch.ops import vad as tvad
from sspv_tpu_torch.ops.pipeline import FeatureConfig as TConfig
from sspv_tpu_torch.ops.pipeline import FeaturePipeline as TPipeline

SR = 16000
GAPS = {"hop_161": dict(frame_size=322, hop_size=161),
        "n_fft_511": dict(n_fft=511, entropy_n_fft=511),
        "entropy_1024": dict(entropy_n_fft=1024)}


def _nmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


def speech(n_samples, seed, dtype=np.float32):
    """Noise, a 130 Hz tone over low noise and loud noise in alternating
    quarter seconds."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / SR
    seg = (t * 4).astype(int) % 3
    sig = rng.normal(0, 40, n_samples)
    sig = np.where(seg == 1, 6000 * np.sin(2 * np.pi * 130 * t) + sig, sig)
    sig = np.where(seg == 2, rng.normal(0, 2000, n_samples), sig)
    return np.clip(sig, -32768, 32767).astype(dtype)


@pytest.fixture(scope="module")
def pipes():
    return {k: (JPipeline(JConfig(**g)), TPipeline(TConfig(**g), device="cpu"))
            for k, g in GAPS.items()}


def assert_blocks_match(tblock, jblock):
    np.testing.assert_array_equal(tblock.zcr.numpy(), np.asarray(jblock.zcr))
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(getattr(tblock, k), np.asarray(getattr(jblock, k))) <= 1e-9
    np.testing.assert_array_equal(tblock.vad.numpy(), np.asarray(jblock.vad))
    np.testing.assert_array_equal(tblock.vad_adaptive.numpy(),
                                  np.asarray(jblock.vad_adaptive))


def assert_states_match(tstate, jstate):
    _, z, count, last = tvad.vad_state_to_numpy(tstate)
    assert count == int(jstate.count) and last == int(jstate.last_voiced)
    np.testing.assert_array_equal(z, np.asarray(jstate.zcr_buf))


ENTRIES = ("process_signal_device", "process_signal_auto")


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("gap", list(GAPS))
def test_signal_entry_points_match_jax(pipes, gap, entry, dtype):
    jp, tp = pipes[gap]
    sig = speech(3 * SR + 123, seed=1, dtype=dtype)
    jblock, jstate = getattr(jp, entry)(sig)
    tblock, tstate = getattr(tp, entry)(sig)
    assert tblock.vad.shape == np.asarray(jblock.vad).shape
    assert_blocks_match(tblock, jblock)
    assert_states_match(tstate, jstate)


@pytest.mark.parametrize("gap", list(GAPS))
def test_pitch_entry_points_match_jax(pipes, gap):
    """process_signal_pitch_auto (fused) and pitch_signal_auto (two-call)
    equal the JAX package's, and each other."""
    jp, tp = pipes[gap]
    sig = speech(3 * SR + 123, seed=2)
    jblock, _, jf0, jconf = jp.process_signal_pitch_auto(sig)
    tblock, _, tf0, tconf = tp.process_signal_pitch_auto(sig)
    assert_blocks_match(tblock, jblock)
    np.testing.assert_array_equal(tf0, np.asarray(jf0))
    assert _nmse(tconf, np.asarray(jconf)) <= 1e-9
    assert (tf0 > 0).sum() > 50 and abs(np.median(tf0[tf0 > 0]) - 130) < 5
    f0, conf = tp.pitch_signal_auto(sig, tblock.vad)
    np.testing.assert_array_equal(f0, tf0)
    np.testing.assert_array_equal(conf, tconf)


def test_long_signal_matches_jax(pipes):
    """Past SCAN_BLOCK_FRAMES: K3 over all 40,000 frames and one
    full-length VAD, against the JAX package's scanned view path."""
    jp, tp = pipes["hop_161"]
    sig = speech(161 * 39_999 + 322, seed=3)
    jblock, jstate = jp.process_signal_device(sig)
    tblock, tstate = tp.process_signal_device(sig)
    assert tblock.vad.shape == (40_000,)
    assert_blocks_match(tblock, jblock)
    assert_states_match(tstate, jstate)


@pytest.mark.parametrize("gap", list(GAPS))
def test_samples_dispatch_programs_match_jax(pipes, gap):
    """The engine's samples dispatch stays on, as in the JAX package:
    process_signal_packed(_pitch) frame the bucketed int16 samples on the
    device and equal the JAX packed programs column for column."""
    jp, tp = pipes[gap]
    assert tp.supports_samples_dispatch() and jp.supports_samples_dispatch()
    sig = speech(SR, seed=4, dtype=np.int16)
    true_len = SR - 1234
    sig[true_len:] = 0
    n = 1 + (true_len - tp.cfg.frame_size) // tp.cfg.hop_size
    state = tp.initial_packed_state()
    got, got_state = tp.process_signal_packed(sig, state, true_len)
    want, want_state = jp.process_signal_packed(sig, state, true_len)
    tb = tp.split_packed_block(got, n)
    jb = jp.split_packed_block(np.asarray(want), n)
    np.testing.assert_array_equal(tb.zcr, jb.zcr)
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(getattr(tb, k), getattr(jb, k)) <= 1e-9, k
    np.testing.assert_array_equal(tb.vad, jb.vad)
    np.testing.assert_array_equal(tb.vad_adaptive, jb.vad_adaptive)
    gs, ws = got_state.numpy().view(np.int32), np.asarray(want_state).view(np.int32)
    np.testing.assert_array_equal(gs[-2:], ws[-2:])
    got, _ = tp.process_signal_packed_pitch(sig, state, true_len, 0.3)
    want, _ = jp.process_signal_packed_pitch(sig, state, true_len, 0.3)
    tb, tf0, tconf = tp.split_packed_block_pitch(got, n)
    jb, jf0, jconf = jp.split_packed_block_pitch(np.asarray(want), n)
    np.testing.assert_array_equal(tb.vad, jb.vad)
    np.testing.assert_array_equal(tf0, jf0)
    assert _nmse(tconf, jconf) <= 1e-9


def test_view_routes_take_k3_there(monkeypatch):
    """The gap geometries never reach K1's wrapper (K3 computes their
    features); K2 takes their pitch, hop 161 included."""
    from sspv_tpu_torch.ops import pipeline as pipeline_mod
    from sspv_tpu_torch.ops import pitch as pitch_mod

    calls = []
    real_pitch = pitch_mod.fused_view_pitch

    def refuse(*a, **k):
        raise AssertionError("K1 was called")

    def counting(*a, **k):
        calls.append(1)
        return real_pitch(*a, **k)

    monkeypatch.setattr(pipeline_mod, "fused_view_features", refuse)
    monkeypatch.setattr(pitch_mod, "fused_view_pitch", counting)
    sig = speech(SR, seed=5)
    for name, g in GAPS.items():
        calls.clear()
        tp = TPipeline(TConfig(**g), device="cpu")
        tp.process_signal_pitch_auto(sig)
        tp.process_signal_device(sig)
        assert len(calls) == 1, name
    # the default geometry still takes K1
    with pytest.raises(AssertionError):
        TPipeline(device="cpu").process_signal_device(sig)
