#!/usr/bin/env python3
"""The port's streaming engine ``AudioRuntime`` and its host copies
(``Config``, the audio sources, the int16 framing) against the JAX
package's, on the CPU.

Engine runs read an in-memory source to its end (the reference's
hardware-free strategy: swap the device-facing source, run everything else
for real). Every wait is bounded: each run must end within ``RUN_LIMIT_S``
seconds and ``stop()`` must return within it, or the test fails.

Tolerances, each with its reason: frame counts, zcr, VAD and adaptive
decisions EXACTLY equal between the two engines (per-frame features do
not depend on how the engines split the stream into blocks, up to
summation order; the VAD is chunk-invariant); energy/entropy/mfcc NMSE
<= 1e-9 (both float32, different summation order); VAD equal to the
sequential ``EngineVadOracle``; engine F0 identical to the offline
frames-path track on the engine's own decisions, confidence rtol 1e-5
(matmul row blocking differs with the block size); host copies EQUAL to
their originals.
"""

import threading
import time
import wave

import numpy as np
import pytest
import torch

from sspv_tpu.config import Config as JConfig
from sspv_tpu.config import parse_buckets as j_parse_buckets
from sspv_tpu.ops.pipeline import FeatureConfig as JFeatureConfig
from sspv_tpu.runtime import AudioRuntime as JRuntime
from sspv_tpu.runtime import audio_source as jsrc
from sspv_tpu.utils.native import frame_i16_to_f32 as j_frame_i16_to_f32
from sspv_tpu_torch.config import Config as TConfig
from sspv_tpu_torch.config import parse_buckets as t_parse_buckets
from sspv_tpu_torch.ops.pipeline import FeatureConfig as TFeatureConfig
from sspv_tpu_torch.ops.pipeline import FeaturePipeline
from sspv_tpu_torch.ops.pitch import pitch_track
from sspv_tpu_torch.runtime import AudioRuntime as TRuntime
from sspv_tpu_torch.runtime import audio_source as tsrc
from sspv_tpu_torch.runtime import engine as tengine
from sspv_tpu_torch.utils.framing import frame_i16_to_f32

import engine_blocks
import oracle

SR = 16000
RUN_LIMIT_S = 120.0
NPZ_KEYS = {"energies", "zcrs", "vads", "spec_entropy", "vads_adaptive",
            "sample_rate", "frame_size", "hop_size"}


def _nmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


class DummyAudioSource(tsrc.AudioSource):
    """In-memory int16 source honoring the 3-method contract."""

    def __init__(self, signal, read_delay_s: float = 0.0):
        self.sample_rate = SR
        self.channels = 1
        self._data = np.asarray(signal, dtype=np.int16)
        self._delay = read_delay_s
        self._pos = 0
        self.exhausted = False

    def open(self):
        self._pos = 0
        self.exhausted = False

    def read(self, num_frames):
        if self._delay:
            time.sleep(self._delay)
        chunk = self._data[self._pos : self._pos + num_frames]
        self._pos += len(chunk)
        self.exhausted = self._pos >= len(self._data)
        return chunk

    def close(self):
        pass


def speech(seconds, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    seg = (t * 4).astype(int) % 3
    sig = rng.normal(0, 40, n)
    sig = np.where(seg == 1, 7000 * np.sin(2 * np.pi * 140 * t) + sig, sig)
    sig = np.where(seg == 2, rng.normal(0, 2000, n), sig)
    return np.clip(sig, -32768, 32767).astype(np.int16)


def _stop_within(rt, limit_s=RUN_LIMIT_S):
    th = threading.Thread(target=rt.stop, daemon=True)
    th.start()
    th.join(limit_s)
    assert not th.is_alive(), "stop() did not return in time"


def _run_to_eof(rt, limit_s=RUN_LIMIT_S):
    rt.auto_stop_on_eof = True
    rt.start()
    t0 = time.monotonic()
    while rt.is_running and time.monotonic() - t0 < limit_s:
        time.sleep(0.005)
    assert not rt.is_running, "the engine did not reach the end of its source"
    _stop_within(rt, limit_s)
    assert rt.last_error is None, rt.last_error


def _frames_of(rt):
    with rt.lock:
        rows = list(rt.processed_data)
    return {k: np.array([d[k] for d in rows]) for k in
            ("energy", "zcr", "vad", "spec_entropy", "vad_adaptive", "mfcc")}


@pytest.fixture
def both_configs(monkeypatch):
    """Set a knob on both packages' Config classes for one test."""
    def set_both(name, value):
        monkeypatch.setattr(JConfig, name, value)
        monkeypatch.setattr(TConfig, name, value)

    set_both("PROCESSED_DATA_BUFFER_SIZE", 100_000)
    return set_both


@pytest.mark.parametrize("samples_dispatch", [1, 0])
def test_engine_matches_jax_engine(both_configs, samples_dispatch):
    """Both dispatch modes: samples (the view path, K1) and frames (the
    frames path, K3)."""
    both_configs("TPU_STREAM_SAMPLES_DISPATCH", samples_dispatch)
    sig = speech(2.5, seed=samples_dispatch)
    trt = TRuntime(audio_source=DummyAudioSource(sig), device="cpu")
    jrt = JRuntime(audio_source=DummyAudioSource(sig))
    assert trt._samples_dispatch == jrt._samples_dispatch == bool(samples_dispatch)
    _run_to_eof(trt)
    _run_to_eof(jrt)
    got, want = _frames_of(trt), _frames_of(jrt)
    nf = 1 + (len(sig) - 320) // 160
    assert got["energy"].shape == (nf,) == want["energy"].shape
    assert trt.frames_processed == nf and trt.dispatch_count > 0
    np.testing.assert_array_equal(got["zcr"], want["zcr"])
    for k in ("energy", "spec_entropy", "mfcc"):
        assert _nmse(got[k], want[k]) <= 1e-9, k
    np.testing.assert_array_equal(got["vad"], want["vad"])
    np.testing.assert_array_equal(got["vad_adaptive"], want["vad_adaptive"])
    ref_vad, ref_adp = oracle.EngineVadOracle().run_all(
        got["energy"], got["zcr"], got["spec_entropy"]
    )
    np.testing.assert_array_equal(got["vad"], ref_vad)
    np.testing.assert_array_equal(got["vad_adaptive"], ref_adp)
    assert got["vad"].sum() > 20


@pytest.mark.parametrize("samples_dispatch,low_latency", [(1, 0), (0, 0), (1, 1)])
def test_engine_pitch_matches_offline_track(both_configs, samples_dispatch,
                                            low_latency):
    both_configs("TPU_ENGINE_PITCH", True)
    both_configs("TPU_STREAM_SAMPLES_DISPATCH", samples_dispatch)
    both_configs("TPU_LOW_LATENCY", low_latency)
    sig = speech(1.5, seed=7)
    rt = TRuntime(audio_source=DummyAudioSource(sig), device="cpu")
    _run_to_eof(rt)
    f0, conf = rt.get_recent_pitch(max_display=10**6)
    vads = _frames_of(rt)["vad"].astype(np.int32)
    n = vads.shape[0]
    assert f0.shape == conf.shape == (n,)
    pipe = FeaturePipeline(device="cpu")
    frames = torch.from_numpy(pipe.stream_frames(sig)[:n])
    want_f0, want_conf = pitch_track(frames, vads,
                                     min_confidence=TConfig.TPU_ENGINE_PITCH_MIN_CONF,
                                     acf_impl="dft")
    np.testing.assert_array_equal(f0, want_f0.numpy())
    np.testing.assert_allclose(conf, want_conf.numpy(), rtol=1e-5, atol=1e-6)
    v = f0[f0 > 0]
    assert v.size and abs(np.median(v) - 140) < 10
    _, _, _, f0_display = rt.get_recent_display(max_display=50)
    assert f0_display.shape == (50,)


def test_frames_geometry_engine_runs_the_frames_path(both_configs):
    """An engine at the ASR framing (400/160) cannot ship samples: it
    dispatches host frames through the frames path, with the same results
    as the JAX engine."""
    both_configs("FRAME_SIZE", 400)
    sig = speech(1.5, seed=3)
    trt = TRuntime(audio_source=DummyAudioSource(sig), device="cpu")
    jrt = JRuntime(audio_source=DummyAudioSource(sig))
    assert not trt._samples_dispatch and not jrt._samples_dispatch
    _run_to_eof(trt)
    _run_to_eof(jrt)
    got, want = _frames_of(trt), _frames_of(jrt)
    assert got["energy"].shape == (1 + (len(sig) - 400) // 160,)
    np.testing.assert_array_equal(got["zcr"], want["zcr"])
    np.testing.assert_array_equal(got["vad"], want["vad"])
    assert _nmse(got["mfcc"], want["mfcc"]) <= 1e-9


def test_npz_export_schema(both_configs, tmp_path):
    rt = TRuntime(audio_source=DummyAudioSource(speech(0.5)), device="cpu")
    _run_to_eof(rt)
    path = rt.save_data(str(tmp_path))
    with np.load(path) as data:
        assert set(data.files) == NPZ_KEYS
        assert data["energies"].dtype == np.float64
        assert data["zcrs"].dtype == np.float64
        assert data["vads"].dtype == np.int32
        assert data["spec_entropy"].dtype == np.float32
        assert data["vads_adaptive"].dtype == np.float32
        for k in ("sample_rate", "frame_size", "hop_size"):
            assert data[k].dtype == np.int32
        assert int(data["sample_rate"]) == SR
        assert (int(data["frame_size"]), int(data["hop_size"])) == (320, 160)
        n = data["energies"].shape[0]
        assert n == 1 + (len(speech(0.5)) - 320) // 160
        assert all(data[k].shape == (n,) for k in
                   ("zcrs", "vads", "spec_entropy", "vads_adaptive"))


def test_stop_never_strands_pending_audio(both_configs):
    """stop() mid-stream drains every captured sample."""
    sig = np.full(SR, 2500, np.int16)
    rt = TRuntime(audio_source=DummyAudioSource(sig, read_delay_s=0.004),
                  device="cpu")
    rt.start()
    time.sleep(0.15)
    _stop_within(rt)
    assert rt.last_error is None, rt.last_error
    assert rt._pending == [] and rt._pending_samples == 0
    assert rt.frames_processed == len(rt.processed_data) > 0


def test_set_audio_source_resets_history_keeps_hangover(both_configs):
    """A source swap clears the buffers and the adaptive history but keeps
    the hangover distance: a raw-bit copy of the packed last_voiced slot."""
    rt = TRuntime(audio_source=DummyAudioSource(speech(0.6)), device="cpu")
    _run_to_eof(rt)
    assert len(rt.processed_data) > 0
    last = rt._vad_state_packed.numpy().view(np.int32)[-1]
    rt.set_audio_source(DummyAudioSource(speech(0.4, seed=1)),
                        auto_stop_on_eof=True)
    assert len(rt.processed_data) == 0 and len(rt.energy_history) == 0
    fresh = np.asarray(rt._vad_state_packed)
    assert fresh.view(np.int32)[-1] == last
    assert fresh.view(np.int32)[-2] == 0 and not fresh[:-2].any()
    _run_to_eof(rt)
    assert len(rt.processed_data) == 1 + (int(0.4 * SR) - 320) // 160


def test_engine_surface(both_configs, monkeypatch):
    """The reference surface and its knobs: a window copy, display ring,
    recent accessors, a bad dispatch interval that warns and defaults."""
    monkeypatch.setattr(TConfig, "TPU_MIN_DISPATCH_INTERVAL", "50ms")
    rt = TRuntime(audio_source=DummyAudioSource(speech(1.5)), device="cpu")
    assert rt._min_dispatch_interval == 0.0
    rt.window[:] = 0.0
    assert bool(rt.pipeline._window.abs().sum() > 0)
    _run_to_eof(rt)
    e, z, v = rt.get_recent_processed()
    assert e.shape == z.shape == v.shape == (TConfig.MAX_DISPLAY_FRAMES,)
    audio = rt.get_recent_audio()
    assert audio.dtype == np.int16
    assert audio.size == TConfig.WAVEFORM_DISPLAY_LENGTH
    f0, conf = rt.get_recent_pitch()
    assert f0.size == conf.size == 0  # pitch is off by default


def test_engine_default_device_is_the_card(both_configs):
    src = DummyAudioSource(speech(0.1))
    if torch.cuda.is_available():
        assert TRuntime(audio_source=src).pipeline.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            TRuntime(audio_source=src)


# -- host copies ------------------------------------------------------------


def _upper_attrs(cls):
    return {k: v for k, v in vars(cls).items() if k.isupper()}


def test_config_attributes_equal_jax():
    assert _upper_attrs(TConfig) == _upper_attrs(JConfig)
    assert TConfig is not JConfig


@pytest.mark.parametrize("value", [
    (32, 256, 2048), [512, 64], "64,512", "8 32  128", "garbage", (0, 5), (),
])
def test_parse_buckets_equals_jax(value):
    assert t_parse_buckets(value) == j_parse_buckets(value)


def test_env_overrides_equal_jax(monkeypatch):
    env = {"RTP_FRAME_SIZE": "400", "RTP_TPU_STREAM_BUCKETS": "64,512",
           "RTP_TPU_LOW_LATENCY": "yes", "RTP_ENERGY_THRESHOLD": "2500.5",
           "RTP_ZCR_THRESHOLD": "0.25", "RTP_WINDOW_TYPE": "hanning"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for cls in (TConfig, JConfig):
        for k, v in _upper_attrs(cls).items():
            monkeypatch.setattr(cls, k, v)  # restored after the test
        cls.load_from_env()
    assert _upper_attrs(TConfig) == _upper_attrs(JConfig)
    assert TConfig.FRAME_SIZE == 400 and TConfig.TPU_STREAM_BUCKETS == (64, 512)
    assert TFeatureConfig.from_config(TConfig)._asdict() == (
        JFeatureConfig.from_config(JConfig)._asdict()
    )


def _write_wav(path, sr, data, channels=1):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.asarray(data, "<i2").tobytes())


def _read_all(src, chunk=1000):
    src.open()
    out = []
    while True:
        c = src.read(chunk)
        if len(c) == 0:
            break
        out.append(c)
    src.close()
    return np.concatenate(out) if out else np.zeros(0, np.int16)


@pytest.mark.parametrize("file_sr,target", [(16000, None), (8000, 16000),
                                            (22050, 16000)])
def test_file_sources_equal_jax(tmp_path, file_sr, target):
    data = speech(0.7, seed=2)[: int(0.7 * file_sr)]
    stereo = np.stack([data, data // 2], axis=1).reshape(-1)
    _write_wav(tmp_path / "a.wav", file_sr, data)
    _write_wav(tmp_path / "b.wav", file_sr, stereo, channels=2)
    for name in ("a.wav", "b.wav"):
        t = tsrc.FileAudioSource(str(tmp_path / name), sample_rate=target)
        j = jsrc.FileAudioSource(str(tmp_path / name), sample_rate=target)
        np.testing.assert_array_equal(_read_all(t), _read_all(j))
        assert t.sample_rate == j.sample_rate
    paths = [str(tmp_path / "a.wav"), str(tmp_path / "b.wav")]
    t = tsrc.PlaylistAudioSource(paths, sample_rate=target)
    j = jsrc.PlaylistAudioSource(paths, sample_rate=target)
    np.testing.assert_array_equal(_read_all(t, 777), _read_all(j, 777))
    assert t.exhausted and t.sample_rate == j.sample_rate


def test_device_resample_is_not_ported(monkeypatch):
    """(The name dates from when the device path raised NotImplementedError.)
    With TPU_DEVICE_RESAMPLE set, a whole-file resample goes to the device
    resampler and nowhere else: its default device is the card, so without
    one the call raises instead of quietly running on the host, and with
    the device call steered to the CPU it gives the host path's samples to
    one LSB. A short array (under the minimum seconds) takes the host path,
    as in the JAX package."""
    import functools

    from sspv_tpu_torch.ops import resample as tres

    arr = speech(2.0)
    monkeypatch.setattr(TConfig, "TPU_DEVICE_RESAMPLE", True)
    before = tres.CALLS["resample"]
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tsrc._resample_to(arr, 16000, 8000)
        assert tres.CALLS["resample"] == before
    monkeypatch.setattr(
        tres, "resample_to_rate_device",
        functools.partial(tres.resample_to_rate_device, device="cpu"))
    got = tsrc._resample_to(arr, 16000, 8000)
    assert tres.CALLS["resample"] == before + 1
    monkeypatch.setattr(TConfig, "TPU_DEVICE_RESAMPLE", False)
    want = tsrc._resample_to(arr, 16000, 8000)
    assert tres.CALLS["resample"] == before + 1
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert got.dtype == np.int16 and diff.max() <= 1 and (diff > 0).mean() < 1e-3
    monkeypatch.setattr(TConfig, "TPU_DEVICE_RESAMPLE", True)
    short = arr[:4000]
    np.testing.assert_array_equal(tsrc._resample_to(short, 16000, 8000),
                                  jsrc._resample_to(short, 16000, 8000))
    assert tres.CALLS["resample"] == before + 1


@pytest.mark.parametrize("frame,hop,n", [(320, 160, 5000), (400, 160, 5000),
                                         (400, 160, 399), (256, 100, 1000)])
def test_int16_framing_equals_jax(frame, hop, n):
    sig = speech(1.0)[:n]
    np.testing.assert_array_equal(frame_i16_to_f32(sig, frame, hop),
                                  j_frame_i16_to_f32(sig, frame, hop))
    w = np.hanning(frame).astype(np.float32)
    np.testing.assert_array_equal(frame_i16_to_f32(sig, frame, hop, w),
                                  j_frame_i16_to_f32(sig, frame, hop, w))


# (device, samples dispatch, pitch, frames) -> the graph route, at the
# default limit of 32 frames
GRAPH_ROUTES = {
    "card_samples_6": ("cuda", True, False, 6, True),
    "card_samples_32": ("cuda", True, False, 32, True),
    "card_samples_33": ("cuda", True, False, 33, False),
    "card_frames": ("cuda", False, False, 6, False),
    "card_pitch": ("cuda", True, True, 6, False),
    "cpu": ("cpu", True, False, 6, False),
}


@pytest.mark.parametrize("case", list(GRAPH_ROUTES))
def test_graph_route_decision(case):
    """A block replays a CUDA graph on the card, in the samples dispatch
    without pitch, up to the limit; every other block runs eagerly."""
    device, samples, pitch, n, want = GRAPH_ROUTES[case]
    assert tengine._replays(torch.device(device), samples, pitch, n, 32) is want


@pytest.mark.parametrize("buckets,low_latency,limit", [
    ((32, 256, 2048), 0, 32), ((32, 256, 2048), 1, 32), ((8, 16), 0, 8),
    ((64, 256), 0, 32)])
def test_graph_route_limit(both_configs, buckets, low_latency, limit):
    """The graph route's limit is the first configured bucket, at most 32
    frames; the low-latency 8 added before it does not lower it. On the
    CPU the engine holds no graphs."""
    both_configs("TPU_STREAM_BUCKETS", buckets)
    both_configs("TPU_LOW_LATENCY", low_latency)
    rt = TRuntime(audio_source=DummyAudioSource(speech(0.1)), device="cpu")
    assert rt._graph_frames == limit
    assert rt._graphs is None and rt._stream is None


def test_cpu_engine_replays_nothing(both_configs):
    """On the CPU the samples dispatch of graphed sizes, a block past the
    limit and a source reset publish the blocks and leave the state of a
    chain of eager ``process_signal_packed`` calls, bit for bit, and
    nothing replays."""
    pipe = FeaturePipeline(device="cpu")
    sig = engine_blocks.signal(seed=3)
    want, want_state = engine_blocks.eager_chain(pipe, sig)
    rt = TRuntime(audio_source=DummyAudioSource(sig), pipeline=pipe,
                  device="cpu")
    got, got_state = engine_blocks.engine_run(rt, sig)
    assert rt.graph_replays == 0
    assert rt.dispatch_count == len(engine_blocks.SIZES) == len(got)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"block {k}")
    np.testing.assert_array_equal(got_state, want_state)
    # the frame dicts after the reset are those blocks' rows
    tail = np.concatenate(want[engine_blocks.RESET_AT:]).view(np.float32)
    rows = list(rt.processed_data)
    assert rt.frames_processed == sum(engine_blocks.SIZES)
    assert [d["energy"] for d in rows] == tail[:, 0].tolist()
    assert [d["mfcc"] for d in rows] == tail[:, 5:].tolist()


@pytest.mark.parametrize("pitch", [0, 1])
@pytest.mark.parametrize("samples_dispatch", [1, 0])
def test_engine_hands_the_pipeline_device_tensors(both_configs, monkeypatch,
                                                  samples_dispatch, pitch):
    """Every dispatch of an engine, in either mode, with pitch off and on,
    over graphed sizes, a 40-frame block and a source reset, reaches the
    pipeline's upload with tensors already on its device and never a host
    array (that branch serves the offline programs); the published blocks
    and the state equal a chain of eager calls bit for bit."""
    both_configs("TPU_STREAM_SAMPLES_DISPATCH", samples_dispatch)
    both_configs("TPU_ENGINE_PITCH", pitch)
    pipe = FeaturePipeline(device="cpu")
    sig = engine_blocks.signal(seed=4)
    rt = TRuntime(audio_source=DummyAudioSource(sig), pipeline=pipe,
                  device="cpu")
    assert rt._samples_dispatch == bool(samples_dispatch)
    want, want_state = engine_blocks.eager_chain(
        pipe, sig, frames=not samples_dispatch,
        min_conf=rt._pitch_min_conf if pitch else None)
    seen = []
    upload = FeaturePipeline._upload

    def spy(self, a):
        seen.append((type(a), getattr(a, "device", None)))
        return upload(self, a)

    monkeypatch.setattr(FeaturePipeline, "_upload", spy)
    got, got_state = engine_blocks.engine_run(rt, sig)
    assert len(seen) >= len(engine_blocks.SIZES)
    assert set(seen) == {(torch.Tensor, pipe.device)}, set(seen)
    assert len(got) == len(want) == len(engine_blocks.SIZES)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"block {k}")
    np.testing.assert_array_equal(got_state, want_state)


# int32 last_voiced values whose float32 bits are NaN patterns (signaling
# and quiet, both signs), and an ordinary one
NAN_PATTERNS = [0x7F800001, 0x7FA00000, -8388607, -4, 57]


@pytest.mark.parametrize("last", NAN_PATTERNS)
@pytest.mark.parametrize("source", ["array", "tensor"])
def test_write_state_keeps_last_voiced_bits(last, source):
    """The state helper writes a packed state into the static buffer as
    raw bits: a NaN-pattern last_voiced comes back bit for bit."""
    packed = FeaturePipeline(device="cpu").initial_packed_state()
    packed.view(np.int32)[-1] = last
    src = packed if source == "array" else torch.from_numpy(packed.copy())
    buf = torch.full(packed.shape, float("nan"))
    tengine._write_state(buf, src)
    assert buf.numpy().view(np.int32)[-1] == last
    np.testing.assert_array_equal(buf.numpy().view(np.int32),
                                  packed.view(np.int32))


@pytest.mark.parametrize("last", NAN_PATTERNS)
def test_set_audio_source_keeps_nan_pattern_hangover(both_configs, last):
    """A source reset keeps a NaN-pattern last_voiced of the static state
    buffer bit for bit and clears the rest."""
    rt = TRuntime(audio_source=DummyAudioSource(speech(0.1)), device="cpu")
    rt._vad_state_packed.view(torch.int32)[-1] = last
    rt._vad_state_packed[:8] = 1.0
    rt.set_audio_source(DummyAudioSource(speech(0.1)))
    bits = rt._vad_state_packed.numpy().view(np.int32)
    assert bits[-1] == last and bits[-2] == 0 and not bits[:-2].any()


def test_idle_loop_waits_for_audio_without_polling(both_configs, monkeypatch):
    """The idle processing loop sleeps until the capture thread appends a
    chunk (it signals a condition), not in 1 ms polls: over a source that
    delivers a chunk every 10 ms it sleeps only while it drains at the
    end, and every frame is published."""
    counts = {"loop": 0}

    class Clock:
        def __getattr__(self, name):
            return getattr(time, name)

        @staticmethod
        def sleep(s):
            if "_process_loop" in threading.current_thread().name:
                counts["loop"] += 1
            time.sleep(s)

    monkeypatch.setattr(tengine, "time", Clock())
    sig = speech(0.5)
    rt = TRuntime(audio_source=DummyAudioSource(sig, read_delay_s=0.01),
                  device="cpu")
    _run_to_eof(rt)
    assert rt.frames_processed == 1 + (len(sig) - 320) // 160
    assert counts["loop"] < 10, counts  # 1 ms polls: ~100 here


@pytest.mark.parametrize("enabled", [True, False])
def test_collector_paused_nests(enabled):
    """Captures pause the garbage collector while any is under way, and
    leave it as they found it."""
    import gc

    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        with tengine._collector_paused():
            assert not gc.isenabled()
            with tengine._collector_paused():
                assert not gc.isenabled()
            assert not gc.isenabled()
        assert gc.isenabled() is enabled
    finally:
        (gc.enable if was else gc.disable)()
