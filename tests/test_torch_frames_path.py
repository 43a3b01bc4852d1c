#!/usr/bin/env python3
"""The port's frames path against the JAX package's, on the CPU: every
geometry the view path does not take (frame != 2*hop, a window with zeros)
and every entry point that takes raw frames.

Geometries: the 400/160 ASR framing (Hamming), 320/160 with a Hann window
(zeros at both ends), and 400/160 with a separate 1024-point entropy
spectrum. Entry points: ``process_block`` (with and without ``valid``),
``process_signal`` (``pad_tail`` both ways), ``stream`` with buckets,
``process_signal_device`` (exact-length VAD, and the > 32,768-frame branch:
K3's plain version over all frames, then one full-length VAD),
``process_signal_auto`` and the frames branch of the pitch entry points.

Tolerances, each with its reason: zcr EXACTLY equal (the same integer count
times the same float32 reciprocal); energy/entropy/mfcc NMSE <= 1e-9 (both
float32, different summation order); VAD decisions, adaptive decisions and
the state's integer scalars IDENTICAL; the state's history buffers equal
the port's own last features exactly and the JAX package's to float32
rounding (rtol 1e-5); F0 identical on every frame, confidence NMSE <= 1e-9.
"""

import numpy as np
import pytest
import torch

from sspv_tpu.ops.pipeline import FeatureConfig as JConfig
from sspv_tpu.ops.pipeline import FeaturePipeline as JPipeline
from sspv_tpu_torch.ops import vad as tvad
from sspv_tpu_torch.ops.pipeline import FeatureConfig as TConfig
from sspv_tpu_torch.ops.pipeline import FeaturePipeline as TPipeline

import oracle

SR = 16000
GEOMETRIES = {
    "asr_400_160": dict(frame_size=400, hop_size=160),
    "hann_320_160": dict(frame_size=320, hop_size=160, window_type="hanning"),
    "entropy_1024": dict(frame_size=400, hop_size=160, entropy_n_fft=1024),
}


def _nmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


@pytest.fixture(scope="module")
def pipes():
    return {k: (JPipeline(JConfig(**g)), TPipeline(TConfig(**g), device="cpu"))
            for k, g in GEOMETRIES.items()}


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


def assert_blocks_match(tblock, jblock, n=None):
    sl = slice(None) if n is None else slice(0, n)
    np.testing.assert_array_equal(tblock.zcr.numpy()[sl],
                                  np.asarray(jblock.zcr)[sl])
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(getattr(tblock, k).numpy()[sl],
                     np.asarray(getattr(jblock, k))[sl]) <= 1e-9, k
    np.testing.assert_array_equal(tblock.vad.numpy()[sl],
                                  np.asarray(jblock.vad)[sl])
    np.testing.assert_array_equal(tblock.vad_adaptive.numpy()[sl],
                                  np.asarray(jblock.vad_adaptive)[sl])


def assert_states_match(tstate, jstate, energies, zcrs):
    e, z, count, last = tvad.vad_state_to_numpy(tstate)
    assert count == int(jstate.count) and last == int(jstate.last_voiced)
    k = int(count)
    np.testing.assert_array_equal(e[256 - k:], np.asarray(energies)[-k:])
    np.testing.assert_array_equal(z[256 - k:], np.asarray(zcrs)[-k:])
    np.testing.assert_allclose(e, np.asarray(jstate.energy_buf), rtol=1e-5)
    np.testing.assert_array_equal(z, np.asarray(jstate.zcr_buf))


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_process_block_matches_jax(pipes, geom):
    jp, tp = pipes[geom]
    frames = tp.stream_frames(speech(SR, seed=1))
    jblock, jstate = jp.process_block(frames, jp.initial_state())
    tblock, tstate = tp.process_block(frames, tp.initial_state())
    assert tblock.mfcc.shape == (frames.shape[0], 13)
    assert_blocks_match(tblock, jblock)
    assert_states_match(tstate, jstate, tblock.energy, tblock.zcr)


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_process_block_valid_mask_matches_jax(pipes, geom):
    """A bucket-padded block: padded frames run through the features but do
    not advance the state."""
    jp, tp = pipes[geom]
    frames = tp.stream_frames(speech(SR // 2, seed=2))
    n = frames.shape[0]
    padded = np.pad(frames, ((0, 128 - n), (0, 0)))
    valid = np.arange(128) < n
    jblock, jstate = jp.process_block(padded, jp.initial_state(), valid=valid)
    tblock, tstate = tp.process_block(padded, tp.initial_state(), valid=valid)
    assert_blocks_match(tblock, jblock, n)
    assert_states_match(tstate, jstate, tblock.energy[:n], tblock.zcr[:n])


@pytest.mark.parametrize("pad_tail", [False, True])
@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_process_signal_matches_jax(pipes, geom, pad_tail):
    jp, tp = pipes[geom]
    sig = speech(2 * SR + 77, seed=3)
    jblock, jstate = jp.process_signal(sig, pad_tail=pad_tail)
    tblock, tstate = tp.process_signal(sig, pad_tail=pad_tail)
    assert tblock.vad.shape == np.asarray(jblock.vad).shape
    assert_blocks_match(tblock, jblock)
    assert_states_match(tstate, jstate, tblock.energy, tblock.zcr)


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("n", [99, 1024, 40_000])
def test_process_signal_device_matches_jax(pipes, n, dtype):
    """99 and 1024 frames take the exact-length VAD; 40,000 frames take the
    long branch (K3 over all frames, one full-length VAD)."""
    jp, tp = pipes["asr_400_160"]
    sig = speech(160 * (n - 1) + 400 + 77, seed=n, dtype=dtype)
    jblock, jstate = jp.process_signal_device(sig)
    tblock, tstate = tp.process_signal_device(sig)
    assert tblock.energy.shape == (n,) and tblock.vad.dtype == torch.int32
    assert_blocks_match(tblock, jblock)
    assert_states_match(tstate, jstate, tblock.energy, tblock.zcr)


def test_long_branch_equals_exact_length_and_oracle(pipes):
    """The > SCAN_BLOCK_FRAMES branch gives the decisions of the sequential
    engine oracle, the same as process_signal's one exact-length block."""
    _, tp = pipes["asr_400_160"]
    sig = speech(160 * 33_000 + 400, seed=5)
    long_block, long_state = tp.process_signal_device(sig)
    one_block, one_state = tp.process_signal(sig)
    assert long_block.vad.shape == (33_001,)
    assert torch.equal(long_block.vad, one_block.vad)
    assert torch.equal(long_block.vad_adaptive, one_block.vad_adaptive)
    assert torch.equal(long_state.count, one_state.count)
    assert torch.equal(long_state.last_voiced, one_state.last_voiced)
    want_vad, want_adp = oracle.EngineVadOracle().run_all(
        long_block.energy.numpy(), long_block.zcr.numpy(),
        long_block.entropy.numpy(),
    )
    np.testing.assert_array_equal(long_block.vad.numpy(), want_vad)
    np.testing.assert_array_equal(long_block.vad_adaptive.numpy(), want_adp)


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_stream_with_buckets_matches_jax(pipes, geom):
    jp, tp = pipes[geom]
    sig = speech(3 * SR, seed=6)
    sizes = [777, 4096, 123, 16000]
    chunks, pos, i = [], 0, 0
    while pos < len(sig):
        chunks.append(sig[pos : pos + sizes[i % len(sizes)]])
        pos += sizes[i % len(sizes)]
        i += 1
    buckets = (8, 32, 128)
    jblocks = list(jp.stream(iter(chunks), buckets=buckets))
    tblocks = list(tp.stream(iter(chunks), buckets=buckets))
    assert len(tblocks) == len(jblocks)
    for tb, jb in zip(tblocks, jblocks):
        assert_blocks_match(tb, jb)
    # chunking and bucket padding are invisible to the VAD
    whole, _ = tp.process_signal(sig)
    np.testing.assert_array_equal(
        np.concatenate([b.vad.numpy() for b in tblocks]), whole.vad.numpy()
    )


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_auto_entry_points_match_jax(pipes, geom):
    """process_signal_auto runs a frames geometry at exact length;
    process_signal_pitch_auto is the two-call path; pitch runs on the
    streaming frames."""
    jp, tp = pipes[geom]
    sig = speech(3 * SR + 123, seed=8)
    jblock, jstate = jp.process_signal_auto(sig)
    tblock, tstate = tp.process_signal_auto(sig)
    assert_blocks_match(tblock, jblock)
    assert_states_match(tstate, jstate, tblock.energy, tblock.zcr)
    jb, _, jf0, jconf = jp.process_signal_pitch_auto(sig)
    tb, _, tf0, tconf = tp.process_signal_pitch_auto(sig)
    assert_blocks_match(tb, jb)
    assert tf0.shape == (tb.vad.shape[0],) and (tf0 > 0).sum() > 50
    np.testing.assert_array_equal(tf0, np.asarray(jf0))
    assert _nmse(tconf, jconf) <= 1e-9
    assert abs(np.median(tf0[tf0 > 0]) - 130.0) < 5.0


def test_jax_state_carried_into_the_port(pipes):
    """The port continues a frames-path stream the JAX package started."""
    jp, tp = pipes["asr_400_160"]
    frames = tp.stream_frames(speech(2 * SR, seed=9))
    first, second = frames[:120], frames[120:]
    jb1, js1 = jp.process_block(first, jp.initial_state())
    jb2, js2 = jp.process_block(second, js1)
    tb2, ts2 = tp.process_block(second, tvad.vad_state_from_numpy(js1, device="cpu"))
    assert_blocks_match(tb2, jb2)
    energies = np.concatenate([np.asarray(jb1.energy), tb2.energy.numpy()])
    zcrs = np.concatenate([np.asarray(jb1.zcr), tb2.zcr.numpy()])
    assert_states_match(ts2, js2, energies, zcrs)


def test_geometries_route_as_in_jax():
    """frame != 2*hop and windows with zeros take the frames path (no rows
    view, no samples dispatch); the default geometry takes the view path."""
    for g in GEOMETRIES.values():
        tp = TPipeline(TConfig(**g), device="cpu")
        if g.get("entropy_n_fft", 512) == 512:
            assert tp.host_rows_view(np.zeros(4000, np.float32)) is None
        assert not tp.supports_samples_dispatch()
    tp = TPipeline(device="cpu")
    assert tp.host_rows_view(np.zeros(4000, np.float32)).shape == (25, 160)
    assert tp.supports_samples_dispatch()


def test_process_signal_on_the_view_geometry_is_the_frames_path():
    """process_signal takes raw frames at every geometry, as in the JAX
    package; at 320/160 its features equal the view path's to rounding."""
    tp = TPipeline(device="cpu")
    jp = JPipeline(JConfig())
    sig = speech(2 * SR, seed=10)
    tblock, _ = tp.process_signal(sig)
    jblock, _ = jp.process_signal(sig)
    assert_blocks_match(tblock, jblock)
    view, _ = tp.process_signal_device(sig)
    assert torch.equal(view.zcr, tblock.zcr)
    assert torch.equal(view.vad, tblock.vad)
    assert _nmse(view.mfcc, tblock.mfcc) <= 1e-9


def test_short_signals(pipes):
    _, tp = pipes["asr_400_160"]
    block, state = tp.process_signal_device(np.zeros(399, np.float32))
    assert block.energy.shape == (0,) and block.mfcc.shape == (0, 13)
    assert int(state.count) == 0
    block, _ = tp.process_signal(np.zeros(399, np.float32), pad_tail=True)
    assert block.energy.shape == (1,)  # one zero-padded frame
    block, _ = tp.process_signal(np.zeros(399, np.float32))
    assert block.energy.shape == (0,)  # no full frame
    block, _, f0, conf = tp.process_signal_pitch_auto(np.zeros(100, np.int16))
    assert block.vad.shape == (0,) and f0.shape == (0,) == conf.shape


def test_load_constants_from_jax(pipes):
    """The frames path's bases (the pair and the separate entropy pair)
    taken from the JAX pipeline's attributes give bit-identical outputs."""
    jp, tp = pipes["entropy_1024"]
    loaded = TPipeline(tp.cfg, device="cpu")
    loaded.load_constants({k: getattr(jp, "_" + k) for k in
                           ("window", "wc", "ws", "wm", "wnyq", "fb_t", "dct",
                            "lifter", "wc_ent", "ws_ent")})
    sig = speech(SR, seed=11)
    a, _ = loaded.process_signal(sig)
    b, _ = tp.process_signal(sig)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
