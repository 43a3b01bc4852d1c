#!/usr/bin/env python3
"""The packed single-buffer programs of the streaming engine, in the port
and against the JAX package, on the CPU.

- ``pack_state`` / ``unpack_state``: the two int32 scalars bit-viewed as
  float32, so every value round-trips exactly (including ``-(2**30)`` and
  the small negative ``last_voiced`` values whose bits are NaN patterns);
  the layout is byte-identical to the JAX package's both ways.
- ``process_block_packed`` (frames, K3) and ``process_signal_packed``
  (int16 samples, K1): equal to the unpacked programs bit for bit, and to
  the JAX packed programs within the tolerances below.
- the pitch programs: the same feature columns as the plain programs, bit
  for bit, and f0/confidence columns against the JAX programs.

Tolerances against JAX, each with its reason: zcr, vad and vad_adaptive
columns and the state's integer scalars EXACTLY equal; energy/entropy/mfcc
NMSE <= 1e-9 (both float32, different summation order); F0 identical,
confidence NMSE <= 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sspv_tpu.ops import vad as jvad
from sspv_tpu.ops.pipeline import FeatureConfig as JConfig
from sspv_tpu.ops.pipeline import FeaturePipeline as JPipeline
from sspv_tpu_torch.ops import vad as tvad
from sspv_tpu_torch.ops.pipeline import FeatureConfig as TConfig
from sspv_tpu_torch.ops.pipeline import FeaturePipeline as TPipeline

SR = 16000


def _nmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


@pytest.fixture(scope="module")
def pipes():
    return JPipeline(JConfig()), TPipeline(device="cpu")


def speech(n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    seg = (t * 2).astype(int) % 4
    sig = rng.normal(0, 40, n)
    sig = np.where(seg == 1, 6000 * np.sin(2 * np.pi * 130 * t) + sig, sig)
    sig = np.where(seg == 2, rng.normal(0, 2000, n), sig)
    return np.clip(sig, -32768, 32767).astype(dtype)


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32)


def assert_packed_match(got, want, n):
    """Columns of two packed blocks: 0 energy, 1 zcr, 2 entropy, 3 vad,
    4 vad_adaptive, 5: mfcc (and f0, conf when pitch is on)."""
    got = np.asarray(got)[:n]
    want = np.asarray(want)[:n]
    assert got.shape == want.shape
    for c in (1, 3, 4):
        np.testing.assert_array_equal(got[:, c], want[:, c], err_msg=str(c))
    for c in (0, 2):
        assert _nmse(got[:, c], want[:, c]) <= 1e-9, c
    assert _nmse(got[:, 5:18], want[:, 5:18]) <= 1e-9
    if got.shape[1] > 18:
        np.testing.assert_array_equal(got[:, 18], want[:, 18])
        assert _nmse(got[:, 19], want[:, 19]) <= 1e-9


@pytest.mark.parametrize("count,last", [
    (0, -4), (256, -1), (17, -(2**30) - 1234), (3, -(2**30)), (9, -8388608),
])
def test_pack_unpack_roundtrip_exact(count, last):
    rng = np.random.default_rng(count)
    st = tvad.VadState(
        energy_buf=torch.from_numpy(rng.normal(0, 1e6, 256).astype(np.float32)),
        zcr_buf=torch.from_numpy(rng.random(256).astype(np.float32)),
        count=torch.tensor(count, dtype=torch.int32),
        last_voiced=torch.tensor(last, dtype=torch.int32),
    )
    packed = tvad.pack_state(st)
    assert packed.dtype == torch.float32 and packed.shape == (514,)
    rt = tvad.unpack_state(packed, 256)
    assert torch.equal(rt.energy_buf, st.energy_buf)
    assert torch.equal(rt.zcr_buf, st.zcr_buf)
    assert int(rt.count) == count and int(rt.last_voiced) == last
    # byte-identical to the JAX package's layout
    jst = jvad.VadState(jnp.asarray(st.energy_buf.numpy()),
                        jnp.asarray(st.zcr_buf.numpy()), jnp.int32(count),
                        jnp.int32(last))
    np.testing.assert_array_equal(_bits(packed), _bits(jvad.pack_state(jst)))


@pytest.mark.parametrize("hist,on", [(256, 3), (64, 0), (300, 5)])
def test_initial_packed_state_matches_jax(hist, on):
    got = tvad.initial_packed_state(hist, on)
    np.testing.assert_array_equal(_bits(got), _bits(jvad.initial_packed_state(hist, on)))
    st = tvad.unpack_state(torch.from_numpy(got), hist)
    assert int(st.count) == 0 and int(st.last_voiced) == -(on + 1)


def test_packed_block_equals_unpacked(pipes):
    _, tp = pipes
    frames = tp.stream_frames(speech(2 * SR))
    n = frames.shape[0]
    padded = np.pad(frames, ((0, 256 - n % 256), (0, 0)))
    valid = np.arange(padded.shape[0]) < n
    want, want_state = tp.process_block(padded, tp.initial_state(), valid=valid)
    packed, state = tp.process_block_packed(padded, tp.initial_packed_state(), n)
    got = tp.split_packed_block(packed, n)
    for k in ("energy", "zcr", "entropy", "mfcc", "vad", "vad_adaptive"):
        np.testing.assert_array_equal(getattr(got, k),
                                      getattr(want, k).numpy()[:n], err_msg=k)
    assert got.vad.dtype == np.int32 and got.mfcc.shape == (n, 13)
    for a, b in zip(tvad.unpack_state(state, 256), want_state):
        assert torch.equal(a, b)


def test_packed_samples_equal_view_path(pipes):
    """process_signal_packed frames int16 samples on the device through the
    view path: the rows of a bucket-padded block equal the unpadded call
    (zcr, decisions and integer state exactly; energy to the ulp, since
    BLAS sums the padded block's product in another order)."""
    _, tp = pipes
    sig = speech(SR, seed=2, dtype=np.int16)
    n = 1 + (len(sig) - 320) // 160
    blen = (256 - 1) * 160 + 320
    padded = np.pad(sig[: (n - 1) * 160 + 320], (0, blen - ((n - 1) * 160 + 320)))
    packed, state = tp.process_signal_packed(padded, tp.initial_packed_state(),
                                             (n - 1) * 160 + 320)
    want, want_state = tp.process_signal_device(sig)
    got = tp.split_packed_block(packed, n)
    np.testing.assert_array_equal(got.zcr, want.zcr.numpy())
    np.testing.assert_array_equal(got.vad, want.vad.numpy())
    np.testing.assert_array_equal(got.vad_adaptive, want.vad_adaptive.numpy())
    assert _nmse(got.energy, want.energy.numpy()) <= 1e-12
    got_state = tvad.unpack_state(state, 256)
    np.testing.assert_allclose(got_state.energy_buf, want_state.energy_buf,
                               rtol=1e-6)
    assert torch.equal(got_state.zcr_buf, want_state.zcr_buf)
    assert int(got_state.count) == int(want_state.count)
    assert int(got_state.last_voiced) == int(want_state.last_voiced)


def _chunks(total, seed):
    rng = np.random.default_rng(seed)
    lo = 0
    while lo < total:
        n = min(int(rng.integers(1, 100)), total - lo)
        yield lo, n
        lo += n


@pytest.mark.parametrize("pitch", [False, True])
def test_packed_blocks_match_jax_and_state_crosses(pipes, pitch):
    """Random chunks through padded buckets, the packed state carried from
    block to block: the port's blocks match the JAX package's, and each
    block's state is handed across the two packages in turn (the JAX state
    continues in the port and the port's in JAX)."""
    jp, tp = pipes
    frames = tp.stream_frames(speech(3 * SR, seed=5))
    buckets = (8, 32, 128)
    state = tp.initial_packed_state()
    for i, (lo, n) in enumerate(_chunks(frames.shape[0], seed=11)):
        part = frames[lo : lo + n]
        bucket = next((b for b in buckets if n <= b), buckets[-1])
        part = np.pad(part, ((0, bucket - n), (0, 0)))
        host_state = state.numpy() if isinstance(state, torch.Tensor) else state
        if pitch:
            jout, jstate = jp.process_block_packed_pitch(part, host_state, n, 0.3)
            tout, tstate = tp.process_block_packed_pitch(part, host_state, n, 0.3)
        else:
            jout, jstate = jp.process_block_packed(part, host_state, n)
            tout, tstate = tp.process_block_packed(part, host_state, n)
        assert_packed_match(tout.numpy(), jax.device_get(jout), n)
        js = jvad.unpack_state(jstate, 256)
        ts = tvad.unpack_state(tstate, 256)
        assert int(js.count) == int(ts.count)
        assert int(js.last_voiced) == int(ts.last_voiced)
        # alternate whose state continues
        state = np.asarray(jax.device_get(jstate)) if i % 2 else tstate


@pytest.mark.parametrize("pitch", [False, True])
def test_packed_samples_match_jax(pipes, pitch):
    jp, tp = pipes
    rng = np.random.default_rng(0)
    sig = speech(2 * SR, seed=7, dtype=np.int16)
    state = tp.initial_packed_state()
    jstate = jp.initial_packed_state()
    pos = 0
    while pos + 320 <= len(sig):
        n = min(int(rng.integers(1, 300)), 1 + (len(sig) - pos - 320) // 160)
        block = sig[pos : pos + (n - 1) * 160 + 320]
        bucket = 32 if n <= 32 else 256 if n <= 256 else 2048
        blen = (bucket - 1) * 160 + 320
        samples = np.pad(block, (0, blen - len(block)))
        if pitch:
            jout, jstate = jp.process_signal_packed_pitch(samples, jstate, len(block), 0.3)
            tout, state = tp.process_signal_packed_pitch(samples, state, len(block), 0.3)
        else:
            jout, jstate = jp.process_signal_packed(samples, jstate, len(block))
            tout, state = tp.process_signal_packed(samples, state, len(block))
        assert_packed_match(tout.numpy(), jax.device_get(jout), n)
        pos += n * 160
    np.testing.assert_array_equal(
        _bits(state)[-2:], _bits(jax.device_get(jstate))[-2:]
    )


def test_pitch_programs_keep_the_feature_columns(pipes):
    """On the same block, the pitch programs' feature columns equal the
    plain programs' bit for bit, in both dispatch layouts; split layout."""
    _, tp = pipes
    rng = np.random.default_rng(0)
    for bucket in (32, 256):
        frames = rng.normal(0, 3000, (bucket, 320)).astype(np.float32)
        st = tp.initial_packed_state()
        plain, _ = tp.process_block_packed(frames, st, bucket - 5)
        fused, _ = tp.process_block_packed_pitch(frames, st, bucket - 5, 0.3)
        assert fused.shape == (bucket, 20)
        assert torch.equal(plain, fused[:, :18])
        block, f0, conf = tp.split_packed_block_pitch(fused, bucket - 5)
        assert block.mfcc.shape == (bucket - 5, 13)
        np.testing.assert_array_equal(f0, fused[: bucket - 5, 18].numpy())
        np.testing.assert_array_equal(conf, fused[: bucket - 5, 19].numpy())
        blen = (bucket - 1) * 160 + 320
        samples = rng.normal(0, 3000, blen).astype(np.int16)
        plain, _ = tp.process_signal_packed(samples, st, blen - 700)
        fused, _ = tp.process_signal_packed_pitch(samples, st, blen - 700, 0.3)
        assert torch.equal(plain, fused[:, :18])


def test_stream_pitch_matches_jax(pipes):
    jp, tp = pipes
    sig = speech(2 * SR, seed=3)
    chunks = [sig[i : i + 4096] for i in range(0, len(sig), 4096)]
    jout = list(jp.stream_pitch(iter(chunks)))
    tout = list(tp.stream_pitch(iter(chunks)))
    assert len(tout) == len(jout)
    for (tb, tf0, tconf), (jb, jf0, jconf) in zip(tout, jout):
        np.testing.assert_array_equal(tb.vad.numpy(), np.asarray(jb.vad))
        np.testing.assert_array_equal(tf0, np.asarray(jf0))
        assert _nmse(tconf, jconf) <= 1e-9
    plain = list(tp.stream(iter(chunks)))
    for (tb, _, _), pb in zip(tout, plain):
        for a, b in zip(tb, pb):
            assert torch.equal(a, b)
    f0 = np.concatenate([f for _, f, _ in tout])
    assert abs(np.median(f0[f0 > 0]) - 130.0) < 5.0


def test_frames_pitch_matches_jax():
    """pitch_track on raw frames (the frames-path Wiener-Khinchin ACF) at
    the 400-sample framing, against the JAX package."""
    from sspv_tpu.ops.pitch import pitch_track as j_pitch_track
    from sspv_tpu_torch.ops.pitch import pitch_track

    tp = TPipeline(TConfig(frame_size=400, hop_size=160), device="cpu")
    frames = tp.stream_frames(speech(SR, seed=4))
    vad = (np.arange(frames.shape[0]) % 7 != 0).astype(np.int32)
    for band in ((50.0, 400.0), (90.0, 250.0)):
        f0, conf = pitch_track(torch.from_numpy(frames), vad, fmin=band[0],
                               fmax=band[1], acf_impl="dft")
        jf0, jconf = j_pitch_track(frames, vad, fmin=band[0], fmax=band[1],
                                   acf_impl="dft")
        np.testing.assert_array_equal(f0.numpy(), np.asarray(jf0))
        assert _nmse(conf.numpy(), np.asarray(jconf)) <= 1e-9


def test_split_packed_block_layout(pipes):
    _, tp = pipes
    p = np.arange(4 * 18, dtype=np.float32).reshape(4, 18)
    p[:, 3] = [0, 1, 1, 0]
    p[:, 4] = [1, 0, 1, 0]
    b = tp.split_packed_block(p, 3)
    np.testing.assert_array_equal(b.energy, p[:3, 0])
    np.testing.assert_array_equal(b.zcr, p[:3, 1])
    np.testing.assert_array_equal(b.entropy, p[:3, 2])
    np.testing.assert_array_equal(b.vad, [0, 1, 1])
    np.testing.assert_array_equal(b.vad_adaptive, [1, 0, 1])
    np.testing.assert_array_equal(b.mfcc, p[:3, 5:])
    assert tp.PACKED_PREFIX_COLS == 5
