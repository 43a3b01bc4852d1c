#!/usr/bin/env python3
"""The adaptive VAD gate at float32 threshold ties.

The reference blends the adaptive thresholds from float64 means and then
compares the float32 feature with them in float32: ``tests/oracle.py``
``adaptive_vad`` compares a float32 array with a Python float, which NumPy
rounds to float32. Where the float64 threshold lies strictly between a
feature and the feature's float32 neighbour, the two precisions decide
apart. The inputs below build such ties on purpose, in the zero-crossing
rate and in the energy, and the port's ``streaming_vad`` must decide them
as ``EngineVadOracle`` and the JAX package (float32 throughout) do, with
both trailing-sum implementations, under a ``valid`` mask and split into
two calls that carry the state.

The means stay float64: a float32 trailing mean flips ``vad_adaptive`` at
frame 46 of ``synth_signal`` (the last test).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sspv_tpu.ops import vad as jvad
from sspv_tpu_torch.ops import vad as tvad

import oracle

GATES = dict(energy_threshold=1000.0, zcr_threshold=0.3,
             entropy_voice_max=0.65, use_adaptive=True, adaptive_alpha=3.0)
ALPHA = 0.99  # adaptive_alpha 3.0 clamped, as the engine does
F32 = np.float32
N = 512  # two blocks of history_len: the blocked sums take the whole call
TIE = 4  # the frame whose threshold ties


def ulp(x) -> F32:
    return np.spacing(F32(x))


def zcr_tie():
    """Four frames of history whose zcr mean is z + ulp/4, then a loud
    frame with zcr z: its float64 threshold z + 0.2475 ulp lies strictly
    between z and the next float32. Every other frame decides clearly:
    falling energies keep the adaptive gate shut, and all stay below the
    fixed energy gate."""
    z = F32(11 / 512)
    e, zc = np.empty(N, F32), np.empty(N, F32)
    e[:TIE], zc[:TIE] = [120, 110, 105, 101], [z, z, z + ulp(z), z]
    e[TIE], zc[TIE] = 500, z
    e[TIE + 1:] = F32(90) - F32(0.125) * np.arange(N - TIE - 1, dtype=F32)
    zc[TIE + 1:] = 0.4
    return e, zc, np.full(N, 0.9, F32)


def energy_tie():
    """The same for the energy: a history whose mean is e - ulp/4 gives a
    float64 threshold e - 0.2475 ulp, strictly between e's float32
    neighbour below and e; its zcr passes clearly."""
    es = F32(800)
    e, zc = np.empty(N, F32), np.empty(N, F32)
    e[:TIE], zc[:TIE] = [es, es, es - ulp(es), es], [0.40, 0.42, 0.44, 0.46]
    e[TIE], zc[TIE] = es, 0.05
    e[TIE + 1:] = F32(400) - F32(0.125) * np.arange(N - TIE - 1, dtype=F32)
    zc[TIE + 1:] = 0.4
    return e, zc, np.full(N, 0.9, F32)


TIES = {"zcr": zcr_tie, "energy": energy_tie}


def threshold64(values: np.ndarray, t: int) -> float:
    """The reference's float64 threshold of frame ``t`` (history < 256)."""
    hist = [float(v) for v in values[:t]]
    return ALPHA * float(np.mean(hist)) + (1 - ALPHA) * float(values[t])


def oracle_run(e, z, h):
    return oracle.EngineVadOracle().run_all(e, z, h)


@functools.lru_cache(maxsize=None)
def _jax_vad(impl: str):
    return jax.jit(lambda e, z, h, s, valid: jvad.streaming_vad(
        e, z, h, s, valid=valid, trailing_impl=impl, **GATES))


def run_jax(e, z, h, impl, state=None, valid=None):
    state = jvad.initial_vad_state() if state is None else state
    v, a, s = _jax_vad(impl)(jnp.asarray(e), jnp.asarray(z), jnp.asarray(h),
                             state, None if valid is None else jnp.asarray(valid))
    return np.asarray(v), np.asarray(a), s


def run_torch(e, z, h, impl, state=None, valid=None, **kw):
    state = tvad.initial_vad_state(device="cpu") if state is None else state
    v, a, s = tvad.streaming_vad(
        torch.from_numpy(e), torch.from_numpy(z), torch.from_numpy(h), state,
        valid=None if valid is None else torch.from_numpy(valid),
        trailing_impl=impl, **dict(GATES, **kw))
    return v.numpy(), a.numpy(), s


def run_mode(run, e, z, h, impl, mode):
    """``(vad, vad_adaptive)`` of the whole signal through ``run`` (the port
    or the JAX package) in one of the callers' forms."""
    if mode == "one call":
        return run(e, z, h, impl)[:2]
    if mode == "valid mask":
        # a bucket-padded call: 256 zero frames behind the signal
        pad = lambda x: np.concatenate([x, np.zeros(256, F32)])
        valid = np.arange(N + 256) < N
        v, a, _ = run(pad(e), pad(z), pad(h), impl, valid=valid)
        return v[:N], a[:N]
    cut = int(mode.split()[-1])  # "split at k": two calls, state carried
    v1, a1, s = run(e[:cut], z[:cut], h[:cut], impl)
    v2, a2, _ = run(e[cut:], z[cut:], h[cut:], impl, state=s)
    return np.concatenate([v1, v2]), np.concatenate([a1, a2])


def test_the_inputs_tie():
    """Each construction puts the float64 threshold strictly between the
    feature and its float32 neighbour, so the float64 comparison says
    voiced and the float32 one does not."""
    e, z, _ = zcr_tie()
    th = threshold64(z, TIE)
    assert float(z[TIE]) < th and F32(th) == z[TIE]
    e, z, _ = energy_tie()
    th = threshold64(e, TIE)
    assert th < float(e[TIE]) and F32(th) == e[TIE]


@pytest.mark.parametrize("mode", ["one call", "valid mask", "split at 4",
                                  "split at 256"])
@pytest.mark.parametrize("impl", ["conv", "blocked"])
@pytest.mark.parametrize("tie", sorted(TIES))
def test_tie_decides_as_the_oracle_and_jax(tie, impl, mode):
    e, z, h = TIES[tie]()
    want_v, want_a = oracle_run(e, z, h)
    # the reference says silent at the tie (the float64 comparison would
    # say voiced)
    assert want_a[TIE] == 0 and want_v[TIE] == 0
    got_v, got_a = run_mode(run_torch, e, z, h, impl, mode)
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_array_equal(got_v, want_v)
    jax_v, jax_a = run_mode(run_jax, e, z, h, impl, mode)
    np.testing.assert_array_equal(got_a, jax_a)
    np.testing.assert_array_equal(got_v, jax_v)


def full_history_tie():
    """A full history (256 frames) of zcr 7/320 in float32, 40 of them one
    float32 above: the threshold of the next frame at zcr 7/320 is
    0.0218749999156 against a feature of 0.0218749996275, the shape of the
    tie a test WAV showed (0.021875 against 0.0218750002860)."""
    z = F32(7 / 320)
    e, zc = np.empty(N, F32), np.full(N, z, F32)
    e[:256] = F32(900) - F32(0.5) * np.arange(256, dtype=F32)
    zc[256 - 40:256] = z + ulp(z)
    e[256] = 950
    e[257:] = F32(600) - F32(0.5) * np.arange(N - 257, dtype=F32)
    zc[257:] = 0.4
    return e, zc, np.full(N, 0.9, F32)


@pytest.mark.parametrize("impl", ["conv", "blocked"])
def test_full_history_tie_decides_as_the_oracle(impl):
    e, z, h = full_history_tie()
    th = float(np.mean(z[:256].astype(np.float64))) * ALPHA + (1 - ALPHA) * float(z[256])
    assert float(z[256]) < th and F32(th) == z[256]
    want_v, want_a = oracle_run(e, z, h)
    assert want_a[256] == 0
    got_v, got_a, _ = run_torch(e, z, h, impl)
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_array_equal(got_v, want_v)
    if impl == "blocked":  # the JAX package's shipped sums agree here too
        jax_v, jax_a, _ = run_jax(e, z, h, impl)
        np.testing.assert_array_equal(jax_a, want_a)


@pytest.mark.parametrize("impl", ["conv", "blocked"])
def test_fixed_gate_compares_in_float64(impl):
    """The fixed energy gate is the reference's Python-float comparison:
    a float32 energy just above a threshold that float32 rounds up to it
    passes."""
    thr = 1000.00004
    e = np.full(N, F32(1000.00006), F32)  # the float32 after 1000
    assert float(e[0]) > thr and F32(thr) == e[0]
    z = np.full(N, F32(0.1), F32)
    h = np.full(N, F32(0.9), F32)
    want_v, want_a = oracle.EngineVadOracle(energy_threshold=thr).run_all(e, z, h)
    got_v, got_a, _ = run_torch(e, z, h, impl, energy_threshold=thr)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_a, want_a)
    assert want_v.all()


@pytest.mark.parametrize("impl", ["conv", "blocked"])
def test_frame_46_keeps_float64_means(impl):
    """``synth_signal``'s frame 46: the port equals the oracle, and a
    running float32 mean of the same history would decide it apart."""
    from sspv_tpu_torch.ops.pipeline import FeatureConfig, FeaturePipeline
    from sspv_tpu_torch.utils.synth import synth_signal

    pipe = FeaturePipeline(FeatureConfig(vad_trailing_impl=impl), device="cpu")
    block, _ = pipe.process_signal_device(synth_signal(2.0))
    e, z, h = (getattr(block, k).numpy() for k in ("energy", "zcr", "entropy"))
    want_v, want_a = oracle_run(e, z, h)
    np.testing.assert_array_equal(block.vad.numpy(), want_v)
    np.testing.assert_array_equal(block.vad_adaptive.numpy(), want_a)

    t = 46
    acc = F32(0)
    for v in z[:t]:  # a running float32 sum of the history
        acc = F32(acc + v)
    mean32 = float(acc / F32(t))
    th64 = ALPHA * float(np.mean(z[:t].astype(np.float64))) + (1 - ALPHA) * float(z[t])
    th32 = ALPHA * mean32 + (1 - ALPHA) * float(z[t])
    assert (z[t] < F32(th64)) != (z[t] < F32(th32))
