#!/usr/bin/env python3
"""The port's ``BatchPipeline.process_long`` / ``process_long_pitch`` on the
CPU: both routes at awkward frame counts and shard counts, against the JAX
package's ``BatchPipeline`` on 8 virtual devices and against the port's own
single-device calls.

The shard route (``_long_kernel_feats`` / ``_long_kernel_pitch``: each
shard's block of frames plus its seam row) must be BIT-identical to the
single-device kernel calls at every shard count: per-frame math does not
depend on the split. The view route (``long_kernel=False``) is the
single-device view path with the padded blocked VAD. Against the JAX package
(its XLA view path on the CPU): zcr EXACTLY equal, energy/entropy/mfcc NMSE
<= 1e-9, VAD decisions and the state's integer scalars IDENTICAL, F0
identical on every frame and confidence NMSE <= 1e-9.
"""

import numpy as np
import pytest
import torch

from sspv_tpu.ops.pipeline import FeatureConfig as JConfig
from sspv_tpu.parallel import BatchPipeline as JBatchPipeline
from sspv_tpu.parallel import make_mesh as jmake_mesh
from sspv_tpu_torch.ops.pipeline import FEATURE_CONSTANTS
from sspv_tpu_torch.ops.pipeline import FeatureConfig as TConfig
from sspv_tpu_torch.ops.pitch import pitch_track_signal_gated
from sspv_tpu_torch.parallel import BatchPipeline, make_mesh
from sspv_tpu_torch.parallel import mesh as mesh_mod

FEATURES = ("energy", "zcr", "entropy", "mfcc", "vad", "vad_adaptive")
SIZES = (17, 99, 1024, 1203)
SHARDS = (1, 4, 8)
ROUTES = ("shard", "view")
GAPS = {"hop_161": dict(frame_size=322, hop_size=161),
        "n_fft_511": dict(n_fft=511, entropy_n_fft=511),
        "entropy_1024": dict(entropy_n_fft=1024),
        "n_fft_640": dict(n_fft=640, entropy_n_fft=640)}


def _nmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


def signal(n_frames: int, frame: int = 320, hop: int = 160) -> np.ndarray:
    """A 220 Hz tone over noise, then louder noise: voiced and unvoiced
    frames, a noise floor everywhere."""
    rng = np.random.default_rng(n_frames)
    length = (n_frames - 1) * hop + frame
    t = np.arange(length) / 16000
    sig = rng.normal(0, 300, length)
    sig[: length // 2] += 8000 * np.sin(2 * np.pi * 220 * t[: length // 2])
    sig[length // 2 :] += rng.normal(0, 3000, length - length // 2)
    return sig.astype(np.float32)


def port(jpipe, d: int, route: str, cfg=None) -> BatchPipeline:
    bp = BatchPipeline(make_mesh(d, device="cpu"), cfg,
                       long_kernel=route == "shard")
    bp.load_constants({k: getattr(jpipe, "_" + k, None)
                       for k in FEATURE_CONSTANTS})
    return bp


def assert_matches_jax(block, state, jblock, jstate):
    np.testing.assert_array_equal(block.zcr.numpy(), np.asarray(jblock.zcr))
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(getattr(block, k), np.asarray(getattr(jblock, k))) <= 1e-9
    np.testing.assert_array_equal(block.vad.numpy(), np.asarray(jblock.vad))
    np.testing.assert_array_equal(block.vad_adaptive.numpy(),
                                  np.asarray(jblock.vad_adaptive))
    assert int(state.count) == int(jstate.count)
    assert int(state.last_voiced) == int(jstate.last_voiced)
    np.testing.assert_array_equal(state.zcr_buf.numpy(),
                                  np.asarray(jstate.zcr_buf))


def assert_equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def jax_long():
    """The JAX package's process_long and process_long_pitch per size (its
    default CPU route: the XLA view path under the 8-device mesh)."""
    jbp = JBatchPipeline(jmake_mesh(8))
    return jbp, {n: (jbp.process_long(signal(n)),
                     jbp.process_long_pitch(signal(n))) for n in SIZES}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("n", SIZES)
def test_process_long(jax_long, n, d, route):
    jbp, ref = jax_long
    bp = port(jbp.pipe, d, route)
    assert bp._long_kernel == (route == "shard")
    sig = signal(n)
    before = mesh_mod.MESH_KERNEL_TRACE_COUNT
    block, state = bp.process_long(sig)
    assert mesh_mod.MESH_KERNEL_TRACE_COUNT == before + (route == "shard")
    assert block.energy.shape == (n,) and block.mfcc.shape == (n, 13)
    # bit-identical to the single-device kernel call
    one, one_state = bp.pipe.process_signal_device(sig)
    assert_equal(block, one)
    assert_equal(state, one_state)
    assert_matches_jax(block, state, *ref[n][0])


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("n", SIZES)
def test_process_long_pitch(jax_long, n, d, route):
    """process_long_pitch's block equals process_long's; its F0 and
    confidence equal the single-device gated pitch (K2 on the whole rows
    view) bit for bit, and the JAX package's."""
    jbp, ref = jax_long
    bp = port(jbp.pipe, d, route)
    sig = signal(n)
    block, state, f0, conf = bp.process_long_pitch(sig)
    long_block, long_state = bp.process_long(sig)
    assert_equal(block, long_block)
    assert_equal(state, long_state)
    f0_1, conf_1 = pitch_track_signal_gated(
        torch.from_numpy(sig), block.vad, 0.3, **bp.pipe._pitch_kwargs(50.0, 400.0))
    assert torch.equal(f0, f0_1) and torch.equal(conf, conf_1)
    jblock, jstate, jf0, jconf = ref[n][1]
    assert_matches_jax(block, state, jblock, jstate)
    np.testing.assert_array_equal(f0.numpy(), np.asarray(jf0))
    assert _nmse(conf, np.asarray(jconf)) <= 1e-9
    if n >= 99:
        voiced = f0[f0 > 0]
        assert voiced.numel() > 10
        assert bool(((voiced - 220).abs() < 12).all())


def test_process_long_one_frame_per_shard():
    """n = 5 frames over 8 shards: one frame (or none) per shard. On the
    CPU a 1-row matrix product rounds differently from a many-row one, so
    here only energy, zcr, VAD and F0 are bit-identical to the single-device
    call, and entropy, mfcc and confidence agree to rounding; all match the
    JAX package."""
    jbp = JBatchPipeline(jmake_mesh(8))
    bp = port(jbp.pipe, 8, "shard")
    sig = signal(5)
    block, state, f0, conf = bp.process_long_pitch(sig)
    one, one_state = bp.pipe.process_signal_device(sig)
    for k in ("energy", "zcr", "vad", "vad_adaptive"):
        assert torch.equal(getattr(block, k), getattr(one, k)), k
    for k in ("entropy", "mfcc"):
        assert _nmse(getattr(block, k), getattr(one, k)) <= 1e-9, k
    assert_equal(state, one_state)
    f0_1, conf_1 = pitch_track_signal_gated(
        torch.from_numpy(sig), one.vad, 0.3, **bp.pipe._pitch_kwargs(50.0, 400.0))
    assert torch.equal(f0, f0_1) and _nmse(conf, conf_1) <= 1e-9
    jblock, jstate, jf0, jconf = jbp.process_long_pitch(sig)
    assert_matches_jax(block, state, jblock, jstate)
    np.testing.assert_array_equal(f0.numpy(), np.asarray(jf0))
    assert _nmse(conf, np.asarray(jconf)) <= 1e-9


@pytest.mark.parametrize("route", ROUTES)
def test_process_long_past_the_scan_block(route):
    """SCAN_BLOCK_FRAMES shrunk to 64: 199 frames run the full-length VAD
    either way, equal to the JAX package's long path at the same block."""
    rng = np.random.default_rng(7)
    sig = np.zeros(16000 * 2, dtype=np.float32)
    sig[4000:12000] = np.sin(2 * np.pi * 200 * np.arange(8000) / 16000) * 9000
    sig[12000:20000] = rng.normal(0, 2500, 8000)
    sig += rng.normal(0, 30, sig.size).astype(np.float32)
    jbp = JBatchPipeline(jmake_mesh(8))
    jbp.pipe.SCAN_BLOCK_FRAMES = 64
    bp = port(jbp.pipe, 8, route)
    bp.pipe.SCAN_BLOCK_FRAMES = 64
    block, state = bp.process_long(sig)
    assert block.energy.shape == (199,)
    assert_matches_jax(block, state, *jbp.process_long(sig))


@pytest.mark.parametrize("route", ROUTES)
def test_process_long_int16_and_sub_frame(route):
    """int16 uploads as int16 and casts on the device: the same result as
    its float32 values. A signal shorter than a frame gives empty outputs
    and keeps the state."""
    bp = port(JBatchPipeline(jmake_mesh(8)).pipe, 4, route)
    sig = np.clip(signal(300), -32768, 32767).astype(np.int16)
    (b16, s16), (b32, s32) = (bp.process_long(sig),
                              bp.process_long(sig.astype(np.float32)))
    assert_equal(b16, b32)
    assert_equal(s16, s32)
    block, state, f0, conf = bp.process_long_pitch(sig[:319])
    assert block.vad.shape == (0,) and f0.shape == (0,) == conf.shape
    assert int(state.count) == 0


@pytest.mark.parametrize("n", [17, 99])
def test_process_long_off_the_view_geometry(n):
    """400/160: device framing, K3, the padded blocked VAD and the frames
    pitch, equal to the single-device frames path and the JAX package."""
    cfg = dict(frame_size=400, hop_size=160)
    jbp = JBatchPipeline(jmake_mesh(8), JConfig(**cfg))
    bp = port(jbp.pipe, 8, "shard", TConfig(**cfg))
    assert not bp._long_kernel
    sig = signal(n, 400)
    block, state, f0, conf = bp.process_long_pitch(sig)
    one, _ = bp.pipe.process_signal(sig)
    assert_equal(block, one)
    jblock, jstate, jf0, jconf = jbp.process_long_pitch(sig)
    assert_matches_jax(block, state, jblock, jstate)
    np.testing.assert_array_equal(f0.numpy(), np.asarray(jf0))
    assert _nmse(conf, np.asarray(jconf)) <= 1e-9


@pytest.mark.parametrize("gap", list(GAPS))
def test_process_long_in_the_view_geometry_gaps(gap):
    """View geometries K1 does not take leave the shard route and run K3 on
    the device-formed frames; 322/161, which K1 takes at any hop, keeps the
    shard route; results equal the JAX package's XLA view path under its
    mesh."""
    jbp = JBatchPipeline(jmake_mesh(8), JConfig(**GAPS[gap]))
    bp = port(jbp.pipe, 8, "shard", TConfig(**GAPS[gap]))
    assert bp._long_kernel == (gap == "hop_161")
    c = bp.pipe.cfg
    sig = signal(1203, c.frame_size, c.hop_size)
    block, state, f0, conf = bp.process_long_pitch(sig)
    jblock, jstate, jf0, jconf = jbp.process_long_pitch(sig)
    assert_matches_jax(block, state, jblock, jstate)
    np.testing.assert_array_equal(f0.numpy(), np.asarray(jf0))
    assert _nmse(conf, np.asarray(jconf)) <= 1e-9


GATE_CASES = {
    "default": ({}, True),
    "frame_400": (dict(frame_size=400, hop_size=160), False),
    "hann": (dict(window_type="hanning"), False),
    "hop_161": (GAPS["hop_161"], True),
    "n_fft_511": (GAPS["n_fft_511"], False),
    "entropy_1024": (GAPS["entropy_1024"], False),
    "n_fft_640": (GAPS["n_fft_640"], False),
    # a transform shorter than the frame (the dense bases wrap it around)
    "n_fft_256": (dict(n_fft=256, entropy_n_fft=256), False),
    # the port's kernels are fp32 whatever precision says: no precision
    # gate, where the JAX package's shard route refuses "highest"
    "precision_highest": (dict(precision="highest"), True),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_long_kernel_gates(case):
    cfg, want = GATE_CASES[case]
    mesh = make_mesh(8, device="cpu")
    assert BatchPipeline(mesh, TConfig(**cfg))._long_kernel is want
    assert BatchPipeline(mesh, TConfig(**cfg), long_kernel=True)._long_kernel is want
    assert BatchPipeline(mesh, TConfig(**cfg), long_kernel=False)._long_kernel is False
    if case == "precision_highest":
        jbp = JBatchPipeline(jmake_mesh(8), JConfig(**cfg), long_kernel=True)
        assert not jbp._long_kernel
