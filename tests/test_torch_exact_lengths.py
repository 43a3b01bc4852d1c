#!/usr/bin/env python3
"""The port's entry points run every signal and block at its own length;
the JAX package pads them to length buckets. Held here on the CPU against
the JAX package's bucketed calls, and against the port's own padded call
(the pad and mask it made before), on lengths around the bucket edges and
at the lengths where the exact count alone would flip the VAD's window-sum
order:

- a signal of exactly 256·k frames, whose own count is a multiple of
  ``history_len`` (blocked) where its bucket's is not (direct);
- a signal of 12,900 frames (129 s), direct at its own count, where the
  512 s bucket's 51,199 frames run the full-length pass (blocked).

The route is a function of the lengths computed on the host
(``FeaturePipeline._auto_frames`` / ``_vad_route``, the engine's bucket):
each call passes it to the VAD as ``route_frames``.

Tolerances, those of the port's tests of the same entry points
(``test_torch_pipeline.py``, ``test_torch_batch.py``,
``test_torch_frames_path.py``): against the JAX package zcr, VAD and
adaptive decisions and the state's integers EXACTLY equal,
energy/entropy/mfcc and pitch confidence NMSE <= 1e-9 (float32 both,
another summation order), F0 identical; against the port's padded call the
decisions and the whole state EXACTLY equal (the same float64 sums in the
same order).
"""

import numpy as np
import pytest
import torch

from sspv_tpu.ops.pipeline import FeatureConfig as JConfig
from sspv_tpu.ops.pipeline import FeaturePipeline as JPipeline
from sspv_tpu_torch.ops import pipeline as pipeline_mod
from sspv_tpu_torch.ops import vad as tvad
from sspv_tpu_torch.ops.pipeline import FeaturePipeline

SR = 16000


def _nmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


def samples_of(frames: int) -> int:
    """The samples of a signal of exactly ``frames`` frames at 320/160."""
    return (frames - 1) * 160 + 320


def speech(n_samples, seed):
    """Noise, a 130 Hz tone and loud noise in alternating quarter seconds,
    int16."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / SR
    seg = (t * 4).astype(int) % 3
    sig = rng.normal(0, 40, n_samples)
    sig = np.where(seg == 1, 6000 * np.sin(2 * np.pi * 130 * t), sig)
    sig = np.where(seg == 2, rng.normal(0, 2000, n_samples), sig)
    return np.clip(sig, -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def pipes():
    return JPipeline(JConfig()), FeaturePipeline(device="cpu")


def assert_blocks_match(tblock, jblock):
    np.testing.assert_array_equal(tblock.zcr.numpy(), np.asarray(jblock.zcr))
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(getattr(tblock, k).numpy(), getattr(jblock, k)) <= 1e-9, k
    np.testing.assert_array_equal(tblock.vad.numpy(), np.asarray(jblock.vad))
    np.testing.assert_array_equal(tblock.vad_adaptive.numpy(),
                                  np.asarray(jblock.vad_adaptive))


def assert_states_match(tstate, jstate):
    e, z, count, last = tvad.vad_state_to_numpy(tstate)
    assert count == int(jstate.count) and last == int(jstate.last_voiced)
    np.testing.assert_allclose(e, np.asarray(jstate.energy_buf), rtol=1e-5)
    np.testing.assert_array_equal(z, np.asarray(jstate.zcr_buf))


def padded_call(tp, sig):
    """The port's bucketed call as it ran before: the signal zero-padded to
    its bucket, the frames past it masked out of the VAD, the block sliced
    back."""
    n = 1 + (len(sig) - 320) // 160
    n_b = tp._auto_frames(len(sig))
    padded = np.pad(sig, (0, samples_of(n_b) - len(sig)))
    rows = torch.from_numpy(tp.host_rows_view(padded).astype(np.float32))
    feats = tp._view_features(rows, n_b)
    h = tp.cfg.history_len
    if n_b <= tp.SCAN_BLOCK_FRAMES:
        f = n_b
    else:  # the full-length pass: the gate vectors padded to a multiple
        f = -(-n_b // h) * h
        feats = {k: (torch.nn.functional.pad(v, (0, f - n_b)) if v.dim() == 1
                     else v) for k, v in feats.items()}
    valid = torch.arange(f) < n
    vad, vad_adaptive, state = tvad.streaming_vad(
        feats["energy"], feats["zcr"], feats["entropy"], tp.initial_state(),
        valid=valid, **tp._vad_kwargs())
    return vad[:n], vad_adaptive[:n], state


def recorded_routes(monkeypatch) -> list:
    """The ``route_frames`` of every VAD call the pipeline makes."""
    seen = []
    real = pipeline_mod.fused_streaming_vad

    def rec(*args, **kw):
        seen.append(kw.get("route_frames"))
        return real(*args, **kw)

    monkeypatch.setattr(pipeline_mod, "fused_streaming_vad", rec)
    return seen


# (samples, the VAD order of its bucketed call, its own count's order): the
# edges of the 2 s and 8 s buckets from below, at and above, 256 and 512
# frames (blocked at their own count, direct in the 8 s bucket), and 12,900
# frames (direct at its own count, blocked in the 512 s bucket)
AUTO_CASES = {
    "below_2s": (2 * SR - 1, "direct", "direct"),
    "at_2s": (2 * SR, "direct", "direct"),
    "above_2s": (2 * SR + 1, "direct", "direct"),
    "at_8s": (8 * SR, "direct", "direct"),
    "above_8s": (8 * SR + 160, "direct", "direct"),
    "256_frames": (samples_of(256), "direct", "blocked"),
    "512_frames": (samples_of(512) + 37, "direct", "blocked"),
    "12900_frames": (samples_of(12_900), "blocked", "direct"),
}


def _route(tp, frames: int) -> str:
    return ("blocked" if tp.cfg.vad_trailing_impl == "blocked"
            and frames % tp.cfg.history_len == 0 else "direct")


@pytest.mark.parametrize("case", list(AUTO_CASES))
def test_process_signal_auto_at_exact_length(pipes, monkeypatch, case):
    """No padding: the block has the signal's own frames and equals the
    JAX package's bucketed call, and the port's padded call bit for bit,
    the route-flip lengths included (their route is the bucket's)."""
    jp, tp = pipes
    length, want_route, own_route = AUTO_CASES[case]
    sig = speech(length, seed=length % 97)
    n = 1 + (length - 320) // 160
    routes = recorded_routes(monkeypatch)
    tblock, tstate = tp.process_signal_auto(sig)
    assert tblock.energy.shape == (n,) and tblock.vad.shape == (n,)
    assert len(routes) == 1 and _route(tp, routes[0]) == want_route
    assert _route(tp, n) == own_route
    jblock, jstate = jp.process_signal_auto(sig)
    assert_blocks_match(tblock, jblock)
    assert_states_match(tstate, jstate)
    vad, vad_adaptive, state = padded_call(tp, sig)
    assert torch.equal(tblock.vad, vad)
    assert torch.equal(tblock.vad_adaptive, vad_adaptive.to(torch.int32))
    for a, b in zip(tstate, state):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["below_2s", "above_8s", "256_frames",
                                  "12900_frames"])
def test_process_signal_pitch_auto_at_exact_length(pipes, case):
    """The fused call: the same block, state and F0 as the JAX package's
    bucketed call, and the same as process_signal_auto followed by
    pitch_signal_auto."""
    jp, tp = pipes
    length = AUTO_CASES[case][0]
    sig = speech(length, seed=3 + length % 89)
    tblock, tstate, tf0, tconf = tp.process_signal_pitch_auto(sig)
    jblock, jstate, jf0, jconf = jp.process_signal_pitch_auto(sig)
    assert tf0.shape == (1 + (length - 320) // 160,)
    assert_blocks_match(tblock, jblock)
    assert_states_match(tstate, jstate)
    np.testing.assert_array_equal(tf0, np.asarray(jf0))
    assert _nmse(tconf, jconf) <= 1e-9
    block, _ = tp.process_signal_auto(sig)
    assert torch.equal(block.vad, tblock.vad)
    f0, conf = tp.pitch_signal_auto(sig, block.vad)
    np.testing.assert_array_equal(f0, tf0)
    np.testing.assert_array_equal(conf, tconf)


@pytest.mark.parametrize("extra", [0, 1])
@pytest.mark.parametrize("case", ["below_2s", "at_2s", "above_8s"])
def test_pitch_signal_auto_at_exact_length(pipes, case, extra):
    """pitch_signal_auto runs only the vad's frames: with a vad of the
    signal's frames, and one frame longer (ceil-framed: its last frame
    reads zeros past the signal; past a bucket the signal fills, 0), equal
    to the JAX package's bucketed track."""
    jp, tp = pipes
    length = AUTO_CASES[case][0]
    sig = speech(length, seed=11 + length % 83)
    n = 1 + (length - 320) // 160 + extra
    vad = (np.arange(n) % 7 < 4).astype(np.int32)
    tf0, tconf = tp.pitch_signal_auto(sig, vad)
    jf0, jconf = jp.pitch_signal_auto(sig, vad)
    assert tf0.shape == (n,) == tconf.shape
    np.testing.assert_array_equal(tf0, np.asarray(jf0))
    assert _nmse(tconf, jconf) <= 1e-9
    if extra and case == "at_2s":  # the bucket is full: no frame past it
        assert tf0[-1] == 0 and tconf[-1] == 0


# blocks of these frame counts (default buckets 32, 256, 2048: each on
# either side of an edge)
STREAM_BLOCKS = (1, 31, 33, 255, 257)


def stream_chunks(sig):
    """Chunks of ``sig`` that complete exactly STREAM_BLOCKS frames each."""
    ends = np.cumsum([samples_of(STREAM_BLOCKS[0])]
                     + [160 * m for m in STREAM_BLOCKS[1:]])
    return np.split(sig[: ends[-1]], ends[:-1])


def test_stream_blocks_at_exact_length(pipes, monkeypatch):
    """``stream`` dispatches each block at its own frame count with its
    bucket's VAD order, and equals the JAX ``stream`` block for block."""
    jp, tp = pipes
    sig = speech(samples_of(sum(STREAM_BLOCKS)), seed=5)
    routes = recorded_routes(monkeypatch)
    tblocks = list(tp.stream(iter(stream_chunks(sig))))
    assert routes == [32, 32, 256, 256, 2048]
    jblocks = list(jp.stream(iter(stream_chunks(sig))))
    assert [b.vad.shape[0] for b in tblocks] == list(STREAM_BLOCKS)
    for tb, jb in zip(tblocks, jblocks):
        assert_blocks_match(tb, jb)


def test_stream_pitch_blocks_at_exact_length(pipes):
    """``stream_pitch`` on the same blocks: the blocks of ``stream`` and
    the JAX package's F0 and confidence."""
    jp, tp = pipes
    sig = speech(samples_of(sum(STREAM_BLOCKS)), seed=6)
    got = list(tp.stream_pitch(iter(stream_chunks(sig))))
    want = list(jp.stream_pitch(iter(stream_chunks(sig))))
    plain = list(tp.stream(iter(stream_chunks(sig))))
    assert len(got) == len(want) == len(STREAM_BLOCKS)
    for (tb, tf0, tconf), (jb, jf0, jconf), pb in zip(got, want, plain):
        assert_blocks_match(tb, jb)
        for a, b in zip(tb, pb):
            assert torch.equal(a, b)
        assert tf0.shape == (tb.vad.shape[0],)
        np.testing.assert_array_equal(tf0, np.asarray(jf0))
        assert _nmse(tconf, jconf) <= 1e-9


@pytest.mark.parametrize("samples_dispatch", [True, False])
def test_engine_dispatches_at_exact_length(pipes, monkeypatch,
                                           samples_dispatch):
    """The engine's dispatches (samples: K1; frames: K3) of blocks of 1,
    31, 33, 255 and 257 frames, one after another with the packed state
    carried: no padding, and the frames equal the JAX ``stream``'s."""
    from sspv_tpu_torch.config import Config
    from sspv_tpu_torch.runtime import AudioRuntime
    from sspv_tpu_torch.utils.framing import frame_i16_to_f32

    monkeypatch.setattr(Config, "PROCESSED_DATA_BUFFER_SIZE", 100_000)
    monkeypatch.setattr(Config, "TPU_STREAM_SAMPLES_DISPATCH",
                        int(samples_dispatch))
    jp, tp = pipes
    sig = speech(samples_of(sum(STREAM_BLOCKS)), seed=7)
    rt = AudioRuntime(audio_source=object(), pipeline=tp, device="cpu")
    assert rt._samples_dispatch == samples_dispatch
    start = 0
    for m in STREAM_BLOCKS:
        block = sig[start * 160 : (start + m - 1) * 160 + 320]
        out = rt._dispatch(block if samples_dispatch
                           else frame_i16_to_f32(block, 320, 160), m)
        assert out[0].shape[0] == m  # the packed block: no padded rows
        rt._materialize(out)
        start += m
    rows = list(rt.processed_data)
    got = {k: np.array([d[k] for d in rows]) for k in
           ("energy", "zcr", "vad", "spec_entropy", "vad_adaptive")}
    jb = list(jp.stream(iter(stream_chunks(sig))))
    cat = lambda k: np.concatenate([np.asarray(getattr(b, k)) for b in jb])  # noqa: E731
    np.testing.assert_array_equal(got["zcr"], cat("zcr").astype(np.float64))
    np.testing.assert_array_equal(got["vad"], cat("vad"))
    np.testing.assert_array_equal(got["vad_adaptive"], cat("vad_adaptive"))
    assert _nmse(got["energy"], cat("energy")) <= 1e-9
    assert _nmse(got["spec_entropy"], cat("entropy")) <= 1e-9


def test_process_corpus_exact_batches_match_jax(tmp_path, monkeypatch):
    """Rows of mixed lengths over two buckets and a ragged last batch
    (batch 3: 3 + 2 files in the 2 s bucket, 2 in the 8 s one, a file
    shorter than a frame among them): no row runs a frame past its own,
    and every file's summary and npz equal the JAX package's."""
    import wave

    from sspv_tpu.batch import process_corpus as jax_process_corpus
    from sspv_tpu_torch.batch import process_corpus
    from sspv_tpu_torch.ops import pipeline as pmod

    files = []
    for k, seconds in enumerate((1.3, 0.01, 1.95, 0.6, 2.0, 3.3, 7.9)):
        sig = speech(int(seconds * SR), seed=20 + k)
        path = tmp_path / f"f{k}.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes(sig.astype("<i2").tobytes())
        files.append(str(path))
    k3_frames = []
    real = pmod.fused_features

    def counting(frames, **kw):
        k3_frames.append(int(frames.shape[0]))
        return real(frames, **kw)

    monkeypatch.setattr(pmod, "fused_features", counting)
    got = process_corpus(files, out_dir=str(tmp_path / "port"),
                         want_pitch=True, batch_size=3, device="cpu")
    want = jax_process_corpus(files, out_dir=str(tmp_path / "jax"),
                              want_pitch=True, batch_size=3)
    assert sum(k3_frames) == sum(s["frames"] for s in got)
    assert len(k3_frames) == 3  # the 2 s bucket in 3 + 2 files, the 8 s one
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k not in ("npz", "mean_energy")} \
            == {k: v for k, v in w.items() if k not in ("npz", "mean_energy")}
        assert g["mean_energy"] == pytest.approx(w["mean_energy"], rel=1e-6)
        with np.load(g["npz"]) as a, np.load(w["npz"]) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in ("zcrs", "vads", "vads_adaptive", "f0"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            for k in ("energies", "spec_entropy", "mfcc", "pitch_confidence"):
                assert a[k].shape == b[k].shape, k
                assert a[k].size == 0 or _nmse(a[k], b[k]) <= 1e-9, k
