#!/usr/bin/env python3
"""K4's plain version with a leading batch axis, its wrapper's dispatch on
the CPU, and the batch programs' one VAD call per device.

``vad.streaming_vad`` takes ``(B, f)`` rows with a state and a mask row
each, as the JAX package ``vmap``s it; every row must give the bits of a
1-D call on that row (decisions, adaptive decisions, every field of the
state: the buffers are copies of float32 inputs and the scalars integers,
so "equal" is exact). Against ``jax.vmap`` of the JAX package's
``streaming_vad`` and ``EngineVadOracle`` the decisions and the state are
equal on ``synth_signal``'s features (no float32 threshold tie among them).
K4 itself is held to this plain version in ``test_torch_kernels_on_cpu.py``
(its CUDA source under g++) and ``test_torch_cuda.py`` (on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sspv_tpu.ops import vad as jvad
from sspv_tpu.parallel import BatchPipeline as JBatchPipeline
from sspv_tpu.parallel import make_mesh as jmake_mesh
from sspv_tpu_torch.ops import _build
from sspv_tpu_torch.ops import pipeline as pipeline_mod
from sspv_tpu_torch.ops import vad as tvad
from sspv_tpu_torch.ops import vad_kernels
from sspv_tpu_torch.ops.pipeline import FeatureConfig, FeaturePipeline
from sspv_tpu_torch.parallel import make_mesh
from sspv_tpu_torch.utils.synth import synth_signal

import oracle
from test_torch_parallel import (
    MASKED_LENGTHS,
    PITCH_LENGTHS,
    assert_states_match,
    masked_signals,
    pitch_signals,
    port,
)
from vad_inputs import GATES, row_mask, vad_rows

CPU = torch.device("cpu")


def assert_same(got, want):
    """Two ``streaming_vad`` results bit for bit: decisions, adaptive
    decisions, and every field of the state with its dtype and shape."""
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype == torch.int32 and torch.equal(g, w)
    for name, g, w in zip(tvad.VadState._fields, got[2], want[2]):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


def per_row(e, z, h, state, valid, **kw):
    """The 1-D call on each row, stacked."""
    outs = [tvad.streaming_vad(e[r], z[r], h[r], s,
                               valid=None if valid is None else valid[r], **kw)
            for r, s in enumerate(tvad.unstack_states(state))]
    v, a, states = zip(*outs)
    return torch.stack(v), torch.stack(a), tvad.stack_states(states)


@pytest.mark.parametrize("mask", ["none", "prefix", "holes"])
@pytest.mark.parametrize("impl", ["conv", "blocked"])
@pytest.mark.parametrize("f", [1, 255, 256, 257, 4096])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_batched_rows_equal_one_dimensional_calls(b, f, impl, mask):
    """Every row of a batched call, and of a second one on the new states,
    is the 1-D call on that row: states with full, empty and partial
    histories, masks with per-row counts 0 and f, and masks with holes."""
    e, z, h, state = vad_rows(b, f, seed=b * 7 + f)
    valid = row_mask(mask, b, f, seed=f)
    kw = dict(GATES, trailing_impl=impl)
    got = tvad.streaming_vad(e, z, h, state, valid=valid, **kw)
    assert_same(got, per_row(e, z, h, state, valid, **kw))
    again = tvad.streaming_vad(e.flip(-1), z, h, got[2], valid=valid, **kw)
    assert_same(again, per_row(e.flip(-1), z, h, got[2], valid, **kw))


def test_batched_call_of_no_frame_keeps_every_state():
    _, _, _, state = vad_rows(3, 1, seed=1)
    empty = torch.zeros((3, 0))
    for valid in (None, torch.zeros((3, 0), dtype=torch.bool)):
        v, a, s = tvad.streaming_vad(empty, empty, empty, state, valid=valid,
                                     **GATES)
        assert v.shape == a.shape == (3, 0)
        for x, y in zip(s, state):
            assert torch.equal(x, y)


def synth_rows(seconds: float, seeds) -> tuple:
    """``synth_signal``'s features (the port's CPU pipeline), one row per
    seed, as float32 NumPy ``(B, f)`` arrays."""
    pipe = FeaturePipeline(device="cpu")
    blocks = [pipe.process_signal_device(synth_signal(seconds, seed=s))[0]
              for s in seeds]
    return tuple(np.stack([getattr(b, k).numpy() for b in blocks])
                 for k in ("energy", "zcr", "entropy"))


@pytest.mark.parametrize("impl", ["conv", "blocked"])
def test_batched_equals_jax_vmap_and_the_oracle(impl):
    """Four rows of ``synth_signal`` (seeds 0-3, 6 s: 599 frames) padded to
    768 frames, each with its own true length under the mask (599, 300, 0
    and 451 frames): the decisions and states of ``jax.vmap`` of the JAX
    package's ``streaming_vad`` on its CPU backend, and each row's true
    frames equal to ``EngineVadOracle`` on them alone."""
    e, z, h = synth_rows(6.0, range(4))
    f, f_pad = e.shape[1], 768
    pad = lambda x: np.pad(x, ((0, 0), (0, f_pad - f)))  # noqa: E731
    e, z, h = pad(e), pad(z), pad(h)
    true_n = np.array([599, 300, 0, 451])
    valid = np.arange(f_pad)[None, :] < true_n[:, None]
    kw = dict(GATES, trailing_impl=impl)

    got = tvad.streaming_vad(
        *(torch.from_numpy(x) for x in (e, z, h)),
        tvad.initial_states(4, device=CPU), valid=torch.from_numpy(valid),
        **kw)
    init = jvad.initial_vad_state()
    jstates = jvad.VadState(*(jnp.stack([x] * 4) for x in init))
    jv, ja, js = jax.jit(jax.vmap(lambda e, z, h, s, v: jvad.streaming_vad(
        e, z, h, s, valid=v, **kw)))(jnp.asarray(e), jnp.asarray(z),
                                     jnp.asarray(h), jstates,
                                     jnp.asarray(valid))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ja))
    for g, w in zip(tvad.vad_state_to_numpy(got[2]), js):
        np.testing.assert_array_equal(g, np.asarray(w))
    for r, n in enumerate(true_n):
        if n == 0:
            continue
        want_v, want_a = oracle.EngineVadOracle().run_all(e[r, :n], z[r, :n],
                                                          h[r, :n])
        np.testing.assert_array_equal(got[0][r, :n].numpy(), want_v)
        np.testing.assert_array_equal(got[1][r, :n].numpy(), want_a)
    assert got[2].count.tolist() == [256, 256, 0, 256]


def counting_vad(monkeypatch) -> list:
    """Record the shape of every call of the pipeline's VAD wrapper."""
    calls = []
    real = pipeline_mod.fused_streaming_vad

    def counting(energy, *args, **kw):
        calls.append(tuple(energy.shape))
        return real(energy, *args, **kw)

    monkeypatch.setattr(pipeline_mod, "fused_streaming_vad", counting)
    return calls


@pytest.fixture(scope="module")
def jbp2():
    return JBatchPipeline(jmake_mesh(8, dp=2))


@pytest.mark.parametrize("program", ["masked", "masked_pitch"])
def test_batch_programs_run_one_vad_call_per_device(monkeypatch, jbp2,
                                                    program):
    """``process_batch_masked(_pitch)`` on a CPU mesh with two "data"
    devices: ONE VAD call per device over its four rows (K4 once per
    device and batch on the card), and the rows' decisions and states of
    the JAX package's batch program on the same rows."""
    calls = counting_vad(monkeypatch)
    bp = port(make_mesh(8, dp=2, device="cpu"), jpipe=jbp2.pipe)
    if program == "masked":
        sigs, lengths = masked_signals(), MASKED_LENGTHS
        block, states = bp.process_batch_masked(sigs, lengths)
        jblock, jstates = jbp2.process_batch_masked(sigs, lengths)
    else:
        sigs, lengths = pitch_signals(), PITCH_LENGTHS
        block, states, f0, _ = bp.process_batch_masked_pitch(sigs, lengths)
        jblock, jstates, jf0, _ = jbp2.process_batch_masked_pitch(sigs,
                                                                  lengths)
        np.testing.assert_array_equal(f0.numpy(), np.asarray(jf0))
    f = block.vad.shape[1]
    assert calls == [(4, f)] * 2
    np.testing.assert_array_equal(block.vad.numpy(), np.asarray(jblock.vad))
    np.testing.assert_array_equal(block.vad_adaptive.numpy(),
                                  np.asarray(jblock.vad_adaptive))
    assert_states_match(states, jstates)


def test_wrapper_runs_the_plain_version_on_the_cpu(monkeypatch):
    """On CPU tensors the wrapper is the plain function: the same bits,
    no library loaded, no launch counted."""
    def no_library():
        raise AssertionError("the CPU path loaded the kernel library")

    monkeypatch.setattr(_build, "library", no_library)
    before = dict(_build.LAUNCHES), dict(_build.ROUTES)
    e, z, h, state = vad_rows(3, 300, seed=5)
    valid = row_mask("prefix", 3, 300, seed=5)
    for args in ((e, z, h, state), (e[1], z[1], h[1],
                                     tvad.unstack_states(state)[1])):
        kw = dict(GATES, trailing_impl="blocked")
        assert_same(vad_kernels.fused_streaming_vad(*args, **kw),
                    tvad.streaming_vad(*args, **kw))
    assert_same(
        vad_kernels.fused_streaming_vad(e, z, h, state, valid=valid, **GATES),
        tvad.streaming_vad(e, z, h, state, valid=valid, **GATES))
    assert (dict(_build.LAUNCHES), dict(_build.ROUTES)) == before


def test_wrapper_refuses_a_device_without_a_kernel():
    e = torch.zeros(10, device="meta")
    state = tvad.initial_vad_state(device="meta")
    with pytest.raises(ValueError, match="no vad kernel"):
        vad_kernels.fused_streaming_vad(e, e, e, state, **GATES)


ENTRY_POINTS = {
    "process_signal_device": lambda p, sig: p.process_signal_device(sig),
    "process_signal": lambda p, sig: p.process_signal(sig),
    "process_block_packed": lambda p, sig: p.process_block_packed(
        np.lib.stride_tricks.sliding_window_view(sig, 320)[::160][:64]
        .astype(np.int16), p.initial_packed_state(), 50),
    "process_signal_pitch_auto": lambda p, sig: p.process_signal_pitch_auto(
        sig),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_every_pipeline_path_goes_through_the_wrapper(monkeypatch, entry):
    """The view path, the frames path, the packed programs and the auto
    (bucketed) calls all run their VAD through ``fused_streaming_vad``:
    K4 on the card."""
    calls = counting_vad(monkeypatch)
    pipe = FeaturePipeline(FeatureConfig(), device="cpu")
    ENTRY_POINTS[entry](pipe, synth_signal(1.0))
    assert len(calls) == 1
