#!/usr/bin/env python3
"""The port's streaming composite VAD against the JAX package's and the
sequential engine oracle.

Inputs are made with NumPy from a seed and handed to both. Decisions,
adaptive decisions and the carried state must be IDENTICAL: the state's
buffers are copies of the float32 inputs and its scalars are integers, and
the features here sit nowhere near a float32 threshold tie (the port decides
in float64, the JAX package in float32; see sspv_tpu_torch/ops/vad.py).
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

CPU = torch.device("cpu")
GATES = dict(energy_threshold=1000.0, zcr_threshold=0.3,
             entropy_voice_max=0.65, use_adaptive=True, adaptive_alpha=3.0)


def synth_features(n, seed):
    """Per-frame features with runs of voiced and silent frames."""
    rng = np.random.default_rng(seed)
    voiced = rng.random(n) < 0.35
    for i in range(1, n):
        if voiced[i - 1] and rng.random() < 0.6:
            voiced[i] = True
    energy = np.where(voiced, rng.uniform(2e3, 1e7, n),
                      rng.uniform(0, 900, n)).astype(np.float32)
    zcr = np.where(voiced, rng.uniform(0.01, 0.25, n),
                   rng.uniform(0.2, 0.5, n)).astype(np.float32)
    entropy = np.where(voiced, rng.uniform(0.2, 0.6, n),
                       rng.uniform(0.6, 1.0, n)).astype(np.float32)
    return energy, zcr, entropy


def loud_then_quiet(n, seed):
    """Loud passage then near-silence: the dynamic-range case where a
    subtractive trailing sum cancels and flips decisions."""
    rng = np.random.default_rng(seed)
    energy = np.empty(n, np.float32)
    energy[: n // 2] = rng.uniform(1e9, 3e9, n // 2)
    energy[n // 2:] = rng.uniform(0.005, 0.02, n - n // 2)
    zcr = rng.uniform(0, 0.5, n).astype(np.float32)
    entropy = rng.uniform(0, 1, n).astype(np.float32)
    return energy, zcr, entropy


@functools.lru_cache(maxsize=None)
def _jax_vad(items):
    """One compiled JAX program per keyword set (eager dispatch compiles
    every op per shape, which is most of this file's time)."""
    kw = dict(items)
    return jax.jit(lambda e, z, h, s, valid: jvad.streaming_vad(
        e, z, h, s, valid=valid, **kw))


def run_jax(e, z, h, state=None, valid=None, **kw):
    state = jvad.initial_vad_state() if state is None else state
    v, a, s = _jax_vad(tuple(sorted(kw.items())))(
        jnp.asarray(e), jnp.asarray(z), jnp.asarray(h), state,
        None if valid is None else jnp.asarray(valid),
    )
    return np.asarray(v), np.asarray(a), s


def run_torch(e, z, h, state=None, valid=None, **kw):
    state = tvad.initial_vad_state(device=CPU) if state is None else state
    v, a, s = tvad.streaming_vad(
        torch.from_numpy(e), torch.from_numpy(z), torch.from_numpy(h), state,
        valid=None if valid is None else torch.from_numpy(valid), **kw,
    )
    return v.numpy(), a.numpy(), s


def assert_same_state(tstate, jstate):
    got = tvad.vad_state_to_numpy(tstate)
    want = tuple(np.asarray(x) for x in jstate)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), (g, w)


@pytest.mark.parametrize("impl", ["conv", "blocked"])
@pytest.mark.parametrize("n", [500, 1024])
def test_one_shot_matches_jax_and_oracle(impl, n):
    e, z, h = synth_features(n, seed=n)
    kw = dict(GATES, trailing_impl=impl)
    tv, ta, ts = run_torch(e, z, h, **kw)
    jv, ja, js = run_jax(e, z, h, **kw)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ta, ja)
    assert_same_state(ts, js)
    ov, oa = oracle.EngineVadOracle().run_all(e, z, h)
    np.testing.assert_array_equal(tv, ov)
    np.testing.assert_array_equal(ta, oa)


@pytest.mark.parametrize("impl", ["conv", "blocked"])
@pytest.mark.parametrize("sizes", [[100] * 6, [7, 250, 343], [1] * 20 + [580],
                                   [256, 256, 88], [512, 88]])
def test_chunked_with_carried_state(impl, sizes):
    """Any chunking, with the state carried from chunk to chunk, gives the
    decisions of the engine oracle and the final state of the JAX package's
    one-shot run; the history window (256) straddles the chunk boundaries."""
    e, z, h = synth_features(600, seed=7)
    kw = dict(GATES, trailing_impl=impl)
    ov, oa = oracle.EngineVadOracle().run_all(e, z, h)
    tstate, pos = None, 0
    got_v, got_a = [], []
    for s in sizes:
        sl = slice(pos, pos + s)
        tv, ta, tstate = run_torch(e[sl], z[sl], h[sl], tstate, **kw)
        got_v.append(tv)
        got_a.append(ta)
        pos += s
    np.testing.assert_array_equal(np.concatenate(got_v), ov)
    np.testing.assert_array_equal(np.concatenate(got_a), oa)
    assert_same_state(tstate, run_jax(e, z, h, **kw)[2])


@pytest.mark.parametrize("impl", ["conv", "blocked"])
@pytest.mark.parametrize("features", ["synth", "loud_then_quiet"])
def test_padded_tails_with_valid_masks(impl, features):
    """Bucketed blocks with zero-padded tails under a ``valid`` mask give
    the unpadded decisions and state, like the JAX package."""
    make = synth_features if features == "synth" else loud_then_quiet
    e, z, h = make(300, seed=11)
    kw = dict(GATES, trailing_impl=impl, adaptive_alpha=0.9)
    want_v, want_a, want_s = run_torch(e, z, h, **kw)
    tstate, jstate = None, None
    got_v = []
    for lo, hi, bucket in [(0, 137, 256), (137, 300, 256)]:
        m = hi - lo
        pad = lambda x: np.pad(x[lo:hi], (0, bucket - m))  # noqa: E731
        valid = np.arange(bucket) < m
        tv, ta, tstate = run_torch(pad(e), pad(z), pad(h), tstate, valid, **kw)
        jv, ja, jstate = run_jax(pad(e), pad(z), pad(h), jstate, valid, **kw)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(ta, ja)
        assert_same_state(tstate, jstate)
        got_v.append(tv[:m])
    np.testing.assert_array_equal(np.concatenate(got_v), want_v)
    assert_same_state(tstate, tuple(
        np.asarray(x) for x in tvad.vad_state_to_numpy(want_s)))


@pytest.mark.parametrize("impl", ["conv", "blocked"])
def test_loud_then_quiet_matches_jax_and_oracle(impl):
    e, z, h = loud_then_quiet(512, seed=29)
    kw = dict(GATES, trailing_impl=impl, adaptive_alpha=0.9)
    tv, ta, ts = run_torch(e, z, h, **kw)
    jv, ja, js = run_jax(e, z, h, **kw)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ta, ja)
    assert_same_state(ts, js)
    ov, oa = oracle.EngineVadOracle(alpha_raw=0.9).run_all(e, z, h)
    np.testing.assert_array_equal(tv, ov)
    np.testing.assert_array_equal(ta, oa)


def test_blocked_trailing_sums_keep_quiet_windows_exact():
    """Windows fully inside the quiet span sum to ~1e-10 of the loud block
    totals; the direct (non-subtractive) cumsums keep them to float64
    rounding of the exact sums."""
    rng = np.random.default_rng(23)
    f, h = 1024, 256
    ext = rng.uniform(1e9, 3e9, h + f).astype(np.float32)
    ext[h + f // 4: h + 3 * f // 4] = rng.uniform(0.005, 0.02, f // 2)
    got = tvad._blocked_trailing_sums(
        torch.from_numpy(ext).to(torch.float64), f, h
    ).numpy()
    want = np.array([ext[t: t + h].astype(np.float64).sum() for t in range(f)])
    np.testing.assert_allclose(got, want, rtol=1e-9)


@pytest.mark.parametrize("on,off", [(3, 2), (1, 1), (5, 3), (2, 7), (3, 0),
                                    (0, 2), (0, 0), (4, 1)])
@pytest.mark.parametrize("n", [300, 2048])
def test_hangover_smooth_matches_jax_scan(on, off, n):
    rng = np.random.default_rng(on * 10 + off)
    v = rng.random(n) < 0.3
    got, _ = tvad.hangover_smooth(
        torch.from_numpy(v), torch.tensor(-(on + 1), dtype=torch.int32), on, off
    )
    want, _ = jvad.hangover_smooth_scan(
        jnp.asarray(v), jnp.int32(0), jnp.int32(0), on, off
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("margin,mode", [(1.5, "or"), (1.0, "and")])
def test_opt_in_knobs_match_jax(margin, mode):
    e, z, h = synth_features(512, seed=31)
    kw = dict(GATES, trailing_impl="blocked", adaptive_margin=margin,
              composite_mode=mode)
    tv, ta, ts = run_torch(e, z, h, **kw)
    jv, ja, js = run_jax(e, z, h, **kw)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ta, ja)
    assert_same_state(ts, js)


def test_empty_masked_block_keeps_state():
    e = np.zeros(0, np.float32)
    state = tvad.initial_vad_state(device=CPU)
    v, a, s = run_torch(e, e, e, state, np.zeros(0, bool), **GATES)
    assert v.shape == (0,) and a.shape == (0,)
    assert_same_state(s, jvad.initial_vad_state())


def test_state_round_trip_through_jax():
    """A JAX state carried into the port (and back) continues the stream
    exactly as the JAX package would."""
    e, z, h = synth_features(700, seed=5)
    _, _, js = run_jax(e[:333], z[:333], h[:333], **GATES)
    ts = tvad.vad_state_from_numpy(js, device=CPU)
    assert_same_state(ts, js)
    tv, ta, ts2 = run_torch(e[333:], z[333:], h[333:], ts, **GATES)
    jv, ja, js2 = run_jax(e[333:], z[333:], h[333:], js, **GATES)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ta, ja)
    assert_same_state(ts2, js2)
