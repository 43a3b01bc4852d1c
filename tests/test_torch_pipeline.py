#!/usr/bin/env python3
"""The offline signal path of the port against the JAX package's, end to end
on the CPU: rows view -> features -> composite VAD -> VAD-gated pitch.

Sizes: n = 17, 99 and 1024 frames take the exact-length VAD (17 and 99 with
the direct window sums, 1024 with the blocked cumsums); 40 000 frames take
the long branch (the gate vectors padded to a multiple of 256 under a
``valid`` mask, the plain features in row blocks of 32 768 frames).

Tolerances, each with its reason: zcr EXACTLY equal (same integer count
times the same float32 reciprocal); energy/entropy/mfcc NMSE <= 1e-9 (both
float32, different summation order); VAD decisions, adaptive decisions and
the state's integer scalars IDENTICAL; the state's history buffers hold the
last 256 energies/zcrs, so they equal the port's own features exactly and the
JAX package's to float32 rounding (rtol 1e-5); F0 identical on every frame.
"""

import numpy as np
import pytest
import torch

from sspv_tpu.ops.pipeline import FeatureConfig as JConfig
from sspv_tpu.ops.pipeline import FeaturePipeline as JPipeline
from sspv_tpu_torch.ops import vad as tvad
from sspv_tpu_torch.ops.pipeline import FeaturePipeline

SR = 16000


def _nmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


@pytest.fixture(scope="module")
def pipes():
    return JPipeline(JConfig()), FeaturePipeline(device="cpu")


def speech(n_samples, seed, dtype=np.float32):
    """Noise, a 130 Hz tone and loud noise in alternating quarter seconds."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / SR
    seg = (t * 4).astype(int) % 3
    sig = rng.normal(0, 40, n_samples)
    sig = np.where(seg == 1, 6000 * np.sin(2 * np.pi * 130 * t), sig)
    sig = np.where(seg == 2, rng.normal(0, 2000, n_samples), sig)
    return np.clip(sig, -32768, 32767).astype(dtype)


def assert_blocks_match(tblock, jblock):
    np.testing.assert_array_equal(tblock.zcr.numpy(), np.asarray(jblock.zcr))
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(getattr(tblock, k).numpy(), getattr(jblock, k)) <= 1e-9, k
    np.testing.assert_array_equal(tblock.vad.numpy(), np.asarray(jblock.vad))
    np.testing.assert_array_equal(
        tblock.vad_adaptive.numpy(), np.asarray(jblock.vad_adaptive)
    )


def assert_states_match(tstate, jstate, tblock):
    e, z, count, last = tvad.vad_state_to_numpy(tstate)
    assert count == int(jstate.count) and last == int(jstate.last_voiced)
    k = int(count)
    np.testing.assert_array_equal(e[256 - k:], tblock.energy.numpy()[-k:])
    np.testing.assert_array_equal(z[256 - k:], tblock.zcr.numpy()[-k:])
    np.testing.assert_allclose(e, np.asarray(jstate.energy_buf), rtol=1e-5)
    np.testing.assert_array_equal(z, np.asarray(jstate.zcr_buf))


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("n", [17, 99, 1024, 40_000])
def test_process_signal_device_matches_jax(pipes, n, dtype):
    jp, tp = pipes
    sig = speech(160 * (n + 1) + 77, seed=n, dtype=dtype)  # 77 dropped samples
    jblock, jstate = jp.process_signal_device(sig)
    tblock, tstate = tp.process_signal_device(sig)
    assert tblock.energy.shape == (n,) and tblock.mfcc.shape == (n, 13)
    assert tblock.vad.dtype == torch.int32
    assert_blocks_match(tblock, jblock)
    assert_states_match(tstate, jstate, tblock)


def test_jax_state_carried_into_the_port(pipes):
    """The port continues a stream the JAX package started: its second
    chunk gives the JAX two-chunk decisions."""
    jp, tp = pipes
    sig = speech(160 * 1400, seed=3)
    first, second = sig[: 160 * 600], sig[160 * 600 - 160:]
    jb1, js1 = jp.process_signal_device(first)
    jb2, js2 = jp.process_signal_device(second, js1)
    tb2, ts2 = tp.process_signal_device(
        second, tvad.vad_state_from_numpy(js1, device="cpu")
    )
    assert_blocks_match(tb2, jb2)
    assert_states_match(ts2, js2, tb2)


def test_load_constants_from_jax(pipes):
    """Bases taken from the JAX pipeline's attributes and ACF basis function give
    bit-identical outputs (the port's own copies are bit-identical)."""
    jp, tp = pipes
    from sspv_tpu.ops.time_features import _acf_dft_bases_merged

    loaded = FeaturePipeline(device="cpu")
    consts = {k: getattr(jp, "_" + k)
              for k in ("window", "wm", "wnyq", "fb_t", "dct", "lifter")}
    consts.update(zip(("acf_merged", "acf_nyq", "acf_inv_live", "acf_inv_nyq"),
                      _acf_dft_bases_merged(320, 319)))
    loaded.load_constants(consts)
    sig = speech(SR, seed=4)
    a = loaded.process_signal_pitch_auto(sig)
    b = tp.process_signal_pitch_auto(sig)
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(a[2], b[2])


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_process_signal_pitch_auto_matches_jax(pipes, dtype):
    """A 3 s tone-and-noise clip, bucketed to 8 s: the same block and the
    same F0 on every (voiced or not) frame as the JAX fused call."""
    jp, tp = pipes
    sig = speech(3 * SR, seed=8, dtype=dtype)
    jblock, jstate, jf0, jconf = jp.process_signal_pitch_auto(sig)
    tblock, tstate, tf0, tconf = tp.process_signal_pitch_auto(sig)
    assert_blocks_match(tblock, jblock)
    assert_states_match(tstate, jstate, tblock)
    assert tf0.shape == (tblock.vad.shape[0],) and (tf0 > 0).sum() > 50
    np.testing.assert_array_equal(tf0, np.asarray(jf0))
    assert _nmse(tconf, jconf) <= 1e-9
    voiced = tf0[tf0 > 0]
    assert abs(np.median(voiced) - 130.0) < 5.0


def test_auto_two_call_path_matches_jax(pipes):
    """process_signal_auto + pitch_signal_auto: the same bucketing and
    masking as the JAX package, and the same result as the fused call."""
    jp, tp = pipes
    sig = speech(5 * SR + 123, seed=12)
    jblock, _ = jp.process_signal_auto(sig)
    tblock, _ = tp.process_signal_auto(sig)
    assert_blocks_match(tblock, jblock)
    jf0, _ = jp.pitch_signal_auto(sig, np.asarray(jblock.vad))
    tf0, _ = tp.pitch_signal_auto(sig, tblock.vad)
    np.testing.assert_array_equal(tf0, jf0)
    fused = tp.process_signal_pitch_auto(sig)
    np.testing.assert_array_equal(fused[2], tf0)


@pytest.mark.parametrize("form", ["samples", "int16_samples", "rows"])
def test_tensor_input_equals_host_input(pipes, form):
    """A tensor already on the device (1-D samples, int16 cast on the
    device, or the rows view) gives what the host array gives."""
    _, tp = pipes
    sig = speech(160 * 700 + 50, seed=21, dtype=np.int16)
    want, want_state = tp.process_signal_device(sig)
    t = torch.from_numpy(sig)
    if form == "samples":
        t = t.to(torch.float32)
    elif form == "rows":
        t = torch.from_numpy(tp.host_rows_view(sig.astype(np.float32)))
    got, got_state = tp.process_signal_device(t)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(got_state, want_state):
        assert torch.equal(a, b)


def test_signal_shorter_than_a_frame(pipes):
    _, tp = pipes
    block, state = tp.process_signal_device(np.zeros(100, np.float32))
    assert block.energy.shape == (0,) and block.mfcc.shape == (0, 13)
    assert int(state.count) == 0
    block, _, f0, conf = tp.process_signal_pitch_auto(np.zeros(100, np.int16))
    assert block.vad.shape == (0,) and f0.shape == (0,) == conf.shape


def test_device_is_required():
    """The default device is the card: without one, construction raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert FeaturePipeline().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            FeaturePipeline()
