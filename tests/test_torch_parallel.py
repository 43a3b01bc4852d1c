#!/usr/bin/env python3
"""The port's ``BatchPipeline`` batch programs and its mesh, on the CPU,
against the JAX package's ``BatchPipeline`` on 8 virtual devices and
against the port's own single-device pipeline.

The port runs the plain versions of its kernels on a mesh of logical CPU
devices (``make_mesh(n, device="cpu")``); its constants come from the JAX
pipeline (``load_constants``). Tolerances, as in
``test_torch_frames_path.py``: zcr EXACTLY equal; energy/entropy/mfcc NMSE
<= 1e-9; vad, vad_adaptive and the batched states' integer scalars
IDENTICAL; F0 identical on every frame, confidence NMSE <= 1e-9. Against the
port's own constructions (the two-call pitch, the single-device pipeline on
the same frames) the programs are bit-identical.
"""

import numpy as np
import pytest
import torch

from sspv_tpu.ops.vad import VadState as JVadState
from sspv_tpu.parallel import BatchPipeline as JBatchPipeline
from sspv_tpu.parallel import make_mesh as jmake_mesh
from sspv_tpu_torch.ops import vad as tvad
from sspv_tpu_torch.ops.pipeline import FEATURE_CONSTANTS
from sspv_tpu_torch.ops.pipeline import FeatureConfig as TConfig
from sspv_tpu_torch.ops.pipeline import FeaturePipeline as TPipeline
from sspv_tpu_torch.ops.pitch import pitch_track_signal_gated
from sspv_tpu_torch.parallel import BatchPipeline, Mesh, make_mesh
from sspv_tpu_torch.parallel import mesh as mesh_mod

SR = 16000
FEATURES = ("energy", "zcr", "entropy", "mfcc", "vad", "vad_adaptive")
# process_batch_masked's lengths of the JAX package's test (a sub-frame row
# of 319 samples among them)
MASKED_LENGTHS = [SR // 2, SR, SR + 7 * 160, SR * 2, SR // 4, SR, 319, SR * 2]
# process_batch_masked_pitch's: a sub-frame row and an empty padding row
PITCH_LENGTHS = [SR, SR // 2, 300, SR * 2, 0, SR + 11 * 160, SR * 2, SR // 4]
PITCH_BANDS = {"default": {},
               "band_80_300": dict(fmin=80.0, fmax=300.0, min_confidence=0.6)}


def _nmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


def jax_constants(jpipe) -> dict:
    return {k: getattr(jpipe, "_" + k, None) for k in FEATURE_CONSTANTS}


def port(mesh, cfg=None, long_kernel=None, jpipe=None):
    bp = BatchPipeline(mesh, cfg, long_kernel=long_kernel)
    if jpipe is not None:
        bp.load_constants(jax_constants(jpipe))
    return bp


def assert_row_matches(tblock, jblock, row, n):
    """Row ``row`` of a batched port block against the JAX one on its first
    ``n`` frames, at the stated tolerances."""
    if n == 0:
        return
    t = {k: getattr(tblock, k)[row][:n].numpy() for k in FEATURES}
    j = {k: np.asarray(getattr(jblock, k)[row])[:n] for k in FEATURES}
    np.testing.assert_array_equal(t["zcr"], j["zcr"])
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(t[k], j[k]) <= 1e-9, (row, k)
    np.testing.assert_array_equal(t["vad"], j["vad"])
    np.testing.assert_array_equal(t["vad_adaptive"], j["vad_adaptive"])


def assert_states_match(tstates, jstates):
    e, z, count, last = tvad.vad_state_to_numpy(tstates)
    np.testing.assert_array_equal(count, np.asarray(jstates.count))
    np.testing.assert_array_equal(last, np.asarray(jstates.last_voiced))
    np.testing.assert_allclose(e, np.asarray(jstates.energy_buf), rtol=1e-5)
    np.testing.assert_array_equal(z, np.asarray(jstates.zcr_buf))


def masked_signals(dtype=np.float32):
    rng = np.random.default_rng(9)
    sigs = np.zeros((8, max(MASKED_LENGTHS)), dtype)
    for i, n in enumerate(MASKED_LENGTHS):
        sigs[i, :n] = rng.normal(0, 3000, n)
    return sigs


def pitch_signals():
    """Tones switched on and off at 4 Hz over a noise floor, int16."""
    rng = np.random.default_rng(23)
    t = np.arange(max(PITCH_LENGTHS)) / SR
    sigs = np.zeros((8, t.size), np.int16)
    for i, n in enumerate(PITCH_LENGTHS):
        tone = 6000 * np.sin(2 * np.pi * (120 + 15 * i) * t[:n])
        sigs[i, :n] = (tone * ((t[:n] * 4).astype(int) % 2 == 0)
                       + rng.normal(0, 500, n)).astype(np.int16)
    return sigs


@pytest.fixture(scope="module")
def jbp():
    return JBatchPipeline(jmake_mesh(8))


@pytest.fixture(scope="module")
def jax_masked(jbp):
    return jbp.process_batch_masked(masked_signals(), MASKED_LENGTHS)


@pytest.fixture(scope="module")
def jax_pitch(jbp):
    sigs = pitch_signals()
    return {name: jbp.process_batch_masked_pitch(sigs, PITCH_LENGTHS, **kw)
            for name, kw in PITCH_BANDS.items()}


# -- the mesh -----------------------------------------------------------------


@pytest.mark.parametrize("n,dp", [(8, None), (8, 8), (8, 1), (8, 2), (4, None),
                                  (1, None)])
def test_mesh_shape_follows_jax(n, dp):
    got = make_mesh(n, dp=dp, device="cpu")
    want = jmake_mesh(n, dp=dp)
    assert got.devices.shape == want.devices.shape
    assert got.axis_names == want.axis_names == ("data", "seq")
    assert got.devices.size == n
    assert all(d == torch.device("cpu") for d in got.devices.flat)


def test_mesh_takes_a_repeated_device():
    mesh = Mesh([torch.device("cpu")] * 4)
    assert mesh.devices.shape == (1, 4)
    assert mesh.shape == {"data": 1, "seq": 4}
    bp = BatchPipeline(mesh)
    assert len(bp._pipes) == 1  # one pipeline (one set of constants) per device
    with pytest.raises(ValueError):
        Mesh([])


def test_make_mesh_defaults_to_the_card():
    """No CPU fallback: without a card the default mesh raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        make_mesh()
    with pytest.raises(RuntimeError):
        make_mesh(4, device="cuda")


# -- batched VAD state --------------------------------------------------------


def test_batched_states_stack_and_unstack(jbp):
    bp = port(make_mesh(8, device="cpu"))
    s = bp.initial_states(3)
    j = jbp.initial_states(3)
    assert s.energy_buf.shape == (3, 256) and s.count.shape == (3,)
    assert_states_match(s, j)
    rows = tvad.unstack_states(s)
    assert len(rows) == 3 and rows[0].count.shape == ()
    for a, b in zip(tvad.stack_states(rows), s):
        assert torch.equal(a, b)


def test_jax_batched_states_carry_into_the_port_and_back(jbp):
    """A batch the JAX package started continues in the port, and the
    port's batched state continues in the JAX package."""
    sigs = masked_signals()
    half = sigs.shape[1] // 2
    lengths = np.minimum(MASKED_LENGTHS, half)
    rest = np.maximum(np.asarray(MASKED_LENGTHS) - half, 0)
    bp = port(make_mesh(8, device="cpu"), jpipe=jbp.pipe)
    _, js1 = jbp.process_batch_masked(sigs[:, :half], lengths)
    jb2, js2 = jbp.process_batch_masked(sigs[:, half:], rest, js1)
    tb2, ts2 = bp.process_batch_masked(
        sigs[:, half:], rest, tvad.vad_state_from_numpy(js1, device="cpu"))
    assert_states_match(ts2, js2)
    row_n = np.where(rest >= 320, 1 + (rest - 320) // 160, 0)
    for row, n in enumerate(row_n):
        assert_row_matches(tb2, jb2, row, n)
    # and back: the port's state into the JAX package
    _, ts1 = bp.process_batch_masked(sigs[:, :half], lengths)
    jb2b, js2b = jbp.process_batch_masked(
        sigs[:, half:], rest, JVadState(*tvad.vad_state_to_numpy(ts1)))
    assert_states_match(ts2, js2b)
    np.testing.assert_array_equal(np.asarray(jb2b.vad), np.asarray(jb2.vad))


# -- (B, L) programs ----------------------------------------------------------


def test_batch_matches_single_device(jbp):
    """process_batch: K3 over every row's frames equals the single-device
    view path per row (zcr and VAD exactly) and the JAX batch."""
    signals = np.random.default_rng(0).normal(0, 3000, (8, SR)).astype(np.float32)
    bp = port(make_mesh(8, device="cpu"), jpipe=jbp.pipe)
    block, states = bp.process_batch(signals)
    jblock, jstates = jbp.process_batch(signals)
    assert block.energy.shape == (8, 99) and block.mfcc.shape == (8, 99, 13)
    assert_states_match(states, jstates)
    for i in range(8):
        assert_row_matches(block, jblock, i, 99)
        want, want_state = bp.pipe.process_signal_device(signals[i])
        assert torch.equal(block.zcr[i], want.zcr)
        assert torch.equal(block.vad[i], want.vad)
        assert _nmse(block.mfcc[i], want.mfcc) <= 1e-9
        assert int(states.count[i]) == int(want_state.count)


@pytest.mark.parametrize("n_frames", [17, 99, 256])
def test_batch_on_a_seq_mesh(jbp, n_frames):
    """A (1, 8) mesh (every row on the first device) gives the rows of the
    single-device frames path bit for bit, and the JAX batch's rows."""
    rng = np.random.default_rng(n_frames)
    sigs = rng.normal(0, 3000, (2, (n_frames - 1) * 160 + 320)).astype(np.float32)
    bp = port(make_mesh(8, dp=1, device="cpu"), jpipe=jbp.pipe)
    block, states = bp.process_batch(sigs)
    jblock, jstates = JBatchPipeline(jmake_mesh(8, dp=1)).process_batch(sigs)
    assert_states_match(states, jstates)
    for i in range(2):
        assert_row_matches(block, jblock, i, n_frames)
        ref, ref_state = bp.pipe.process_signal(sigs[i])
        for k in FEATURES:
            assert torch.equal(getattr(block, k)[i], getattr(ref, k)), k
        for a, b in zip(tvad.unstack_states(states)[i], ref_state):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dp", [None, 1, 2, 8])
def test_batch_masked_unequal_lengths(jax_masked, jbp, dp):
    """Rows of unequal length on meshes of every data extent: each row's
    true frames equal its prefix alone on one device (bit for bit) and the
    JAX batch; the 319-sample row keeps its initial state."""
    sigs = masked_signals()
    bp = port(make_mesh(8, dp=dp, device="cpu"), jpipe=jbp.pipe)
    block, states = bp.process_batch_masked(sigs, MASKED_LENGTHS)
    jblock, jstates = jax_masked
    assert_states_match(states, jstates)
    for i, n in enumerate(MASKED_LENGTHS):
        if n < 320:
            assert int(states.count[i]) == 0
            assert int(states.last_voiced[i]) == -4
            continue
        want, want_state = bp.pipe.process_signal(sigs[i, :n])
        true_n = want.energy.shape[0]
        assert_row_matches(block, jblock, i, true_n)
        for k in FEATURES:
            assert torch.equal(getattr(block, k)[i][:true_n], getattr(want, k))
        assert int(states.count[i]) == int(want_state.count) == true_n


def test_batch_runs_one_k3_call_per_device(monkeypatch):
    """Each "data" device runs ONE features call over all of its rows'
    frames (one K3 launch on the card), not one per row."""
    from sspv_tpu_torch.ops import pipeline as pipeline_mod

    calls = []
    real = pipeline_mod.fused_features

    def counting(frames, **kw):
        calls.append(tuple(frames.shape))
        return real(frames, **kw)

    monkeypatch.setattr(pipeline_mod, "fused_features", counting)
    bp = port(make_mesh(8, dp=2, device="cpu"))
    bp.process_batch_masked(masked_signals(), MASKED_LENGTHS)
    assert calls == [(4 * 199, 320)] * 2


def test_batch_rejects_rows_not_divisible_by_data_axis():
    bp = port(make_mesh(8, device="cpu"))  # dp = 4
    with pytest.raises(ValueError):
        bp.process_batch(np.zeros((6, SR), np.float32))


@pytest.mark.parametrize("band", list(PITCH_BANDS))
def test_batch_masked_pitch_matches_two_calls_and_jax(jax_pitch, jbp, band):
    """process_batch_masked_pitch equals its two-call construction (the
    masked batch, then each row's shared gated pitch on the VAD masked to
    its true frames) bit for bit, and the JAX output at the tolerances."""
    kw = PITCH_BANDS[band]
    sigs = pitch_signals()
    bp = port(make_mesh(8, device="cpu"), jpipe=jbp.pipe)
    block, states, f0, conf = bp.process_batch_masked_pitch(
        sigs, PITCH_LENGTHS, **kw)
    block2, states2 = bp.process_batch_masked(sigs, PITCH_LENGTHS)
    for a, b in zip(block + states, block2 + states2):
        assert torch.equal(a, b)
    band_kw = {k: v for k, v in kw.items() if k != "min_confidence"}
    row_n = np.where(np.asarray(PITCH_LENGTHS) >= 320,
                     1 + (np.asarray(PITCH_LENGTHS) - 320) // 160, 0)
    for i, n in enumerate(row_n):
        gate = torch.where(torch.arange(f0.shape[1]) < int(n), block2.vad, 0)
        f0_2, conf_2 = pitch_track_signal_gated(
            torch.from_numpy(sigs[i]), gate[i], kw.get("min_confidence", 0.3),
            **bp.pipe._pitch_kwargs(band_kw.get("fmin", 50.0),
                                    band_kw.get("fmax", 400.0)))
        assert torch.equal(f0[i], f0_2) and torch.equal(conf[i], conf_2)
    jblock, jstates, jf0, jconf = jax_pitch[band]
    assert_states_match(states, jstates)
    np.testing.assert_array_equal(f0.numpy(), np.asarray(jf0))
    assert _nmse(conf, jconf) <= 1e-9
    for i, n in enumerate(row_n):
        assert_row_matches(block, jblock, i, n)
    if band == "default":
        assert (f0 > 0).sum() > 50


def test_batch_pitch_is_one_k2_call_per_device(monkeypatch):
    """The pitch program runs one K2 call over the concatenated rows views
    of a device's rows (each row's straddling last frame dropped)."""
    calls = []
    real = mesh_mod.fused_view_pitch

    def counting(rows, **kw):
        calls.append(tuple(rows.shape))
        return real(rows, **kw)

    monkeypatch.setattr(mesh_mod, "fused_view_pitch", counting)
    bp = port(make_mesh(8, dp=2, device="cpu"))
    _, _, f0, _ = bp.process_batch_masked_pitch(pitch_signals(), PITCH_LENGTHS)
    assert calls == [(4 * 200, 160)] * 2 and f0.shape == (8, 199)


def test_batch_pitch_off_the_k2_geometry():
    """400/160 and 322/161: the batch pitch runs the frames pitch of the
    batch's frames and equals each row's pitch_track_signal_gated."""
    sigs = pitch_signals()
    for g in (dict(frame_size=400, hop_size=160),
              dict(frame_size=322, hop_size=161)):
        bp = port(make_mesh(2, device="cpu"), TConfig(**g))
        block, _, f0, conf = bp.process_batch_masked_pitch(sigs, PITCH_LENGTHS)
        for i, length in enumerate(PITCH_LENGTHS):
            n = 1 + (length - g["frame_size"]) // g["hop_size"] \
                if length >= g["frame_size"] else 0
            gate = torch.where(torch.arange(f0.shape[1]) < n, block.vad[i], 0)
            f0_2, conf_2 = pitch_track_signal_gated(
                torch.from_numpy(sigs[i]), gate, 0.3,
                **bp.pipe._pitch_kwargs(50.0, 400.0))
            assert torch.equal(f0[i], f0_2) and torch.equal(conf[i], conf_2)


def test_constants_live_on_every_device_of_the_mesh():
    """One FeaturePipeline per distinct device; load_constants reaches all
    of them."""
    bp = BatchPipeline(Mesh([[torch.device("cpu")], [torch.device("meta")]]))
    assert set(bp._pipes) == {torch.device("cpu"), torch.device("meta")}
    assert bp.pipe.device == torch.device("cpu")
    consts = TPipeline(device="cpu").constants()
    consts["window"] = consts["window"] * 2
    bp.load_constants(consts)
    for p in bp._pipes.values():
        assert p._window.device == p.device
        assert p._window.shape == (320,)
    assert torch.equal(bp.pipe._window, torch.from_numpy(consts["window"]))
