#!/usr/bin/env python3
"""The port's example harnesses (``sspv_tpu_torch.examples``) on the CPU,
at small sizes, beside the JAX package's originals in ``examples/``.

NumPy-only code is copied (``_sources.py``, ``vad_eval``'s synthesis and
scoring) and held source-equal to the original; the harnesses run with
``--device cpu`` under the assertions of the originals' tests, and their
outputs are held to the JAX package's (run on its CPU backend) or to
``tests/oracle.py``.
"""

import importlib.util
import inspect
import json
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import oracle
from sspv_tpu_torch.examples import (
    _sources,
    generate_samples,
    latency_bench,
    multistream_bench,
    process_files,
    serve_bench,
    sharded_throughput,
    soak,
    vad_eval,
)
from sspv_tpu_torch.tools import deep_fuzz, length_probe, pitch_probe

REPO = Path(__file__).resolve().parents[1]
SR = 16000


def _original(name: str):
    """The JAX package's example ``examples/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_examples_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nmse(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / max(np.mean(want ** 2), 1e-12))


# -- _sources.py -------------------------------------------------------------


def test_sources_is_a_copy_of_the_original():
    ours = (REPO / "sspv_tpu_torch" / "examples" / "_sources.py").read_text()
    theirs = (REPO / "examples" / "_sources.py").read_text()
    assert ours.replace("sspv_tpu_torch", "sspv_tpu") == theirs


@pytest.mark.parametrize("seed,tone_hz", [(0, 150.0), (3, 240.0)])
def test_speech_signal_equals_the_original(seed, tone_hz):
    theirs = _original("_sources")
    a = _sources.speech_signal(0.7, SR, seed=seed, tone_hz=tone_hz)
    b = theirs.speech_signal(0.7, SR, seed=seed, tone_hz=tone_hz)
    assert a.dtype == b.dtype == np.int16 and np.array_equal(a, b)


def _drain(src, read_size: int, want: int, chunks: list) -> np.ndarray:
    src.open()
    got = 0
    while got < want and not src.exhausted:
        c = src.read(read_size)
        chunks.append(c)
        got += len(c)
    src.close()
    return np.concatenate(chunks) if chunks else np.zeros(0, np.int16)


@pytest.mark.parametrize("kind", ["ArraySource", "DueTimePacedSource",
                                  "WallClockPacedSource", "LoopingPacedSource"])
def test_sources_serve_the_originals_chunks(kind):
    theirs = _original("_sources")
    data = _sources.speech_signal(0.15, SR, seed=1)
    out = []
    for mod in (_sources, theirs):
        cls = getattr(mod, kind)
        if kind == "LoopingPacedSource":
            src = cls(SR)
        elif kind == "DueTimePacedSource":
            src = cls(data, SR, 600)
        else:
            src = cls(data, SR, chunk_samples=500)
        chunks: list = []
        stream = _drain(src, 512, len(data), chunks)
        out.append((stream, [len(c) for c in chunks if len(c)]))
    (a, sizes_a), (b, sizes_b) = out
    n = min(len(a), len(b))
    assert n >= len(data) - 512 and np.array_equal(a[:n], b[:n])
    if kind in ("ArraySource", "DueTimePacedSource"):  # no wall-clock caps
        assert sizes_a == sizes_b


# -- vad_eval ----------------------------------------------------------------

VAD_EVAL_HELPERS = ["make_noise", "synth_labeled", "_resonator",
                    "_glottal_train", "synth_formant_speech", "frame_labels",
                    "frame_class_info", "confusion_breakdown", "score",
                    "adaptive_threshold_trace", "gate_diagnostics"]


@pytest.mark.parametrize("name", VAD_EVAL_HELPERS)
def test_vad_eval_helpers_are_the_originals(name):
    theirs = _original("vad_eval")
    assert inspect.getsource(getattr(vad_eval, name)) == inspect.getsource(
        getattr(theirs, name))


@pytest.mark.parametrize("noise", ["white", "babble", "hum"])
def test_vad_eval_synthesis_equals_the_original(noise):
    theirs = _original("vad_eval")
    for name in ("synth_labeled", "synth_formant_speech"):
        a = getattr(vad_eval, name)(1.0, SR, 10.0, seed=7, noise=noise)
        b = getattr(theirs, name)(1.0, SR, 10.0, seed=7, noise=noise)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_vad_eval_decisions_match_the_jax_package_and_the_oracle():
    """4 s per condition on both proxies: every reference line matches the
    oracle on every frame, and the port's decisions equal the JAX
    package's except where the JAX decision differs from the oracle's."""
    from sspv_tpu.ops.pipeline import FeatureConfig as JConfig
    from sspv_tpu.ops.pipeline import FeaturePipeline as JPipeline
    from sspv_tpu_torch.config import Config
    from sspv_tpu_torch.ops.pipeline import FeatureConfig, FeaturePipeline

    lines = list(vad_eval.evaluate(4.0, "cpu"))
    runs = len(vad_eval.PROXIES) * len(vad_eval.CONDITIONS)
    ref = [r for r in lines if r["mode"] == "reference"]
    assert len(ref) == runs and len(lines) == 3 * runs
    assert all(r["oracle_match_pct"] == 100.0 for r in ref)
    assert {r["device"] for r in lines} == {"cpu"}

    cfg = FeatureConfig.from_config(Config)
    ours = FeaturePipeline(cfg, device="cpu")
    jax_pipe = JPipeline(JConfig(**cfg._asdict()))
    for _, synth in vad_eval.PROXIES:
        for _, snr, noise in vad_eval.CONDITIONS:
            sig, _, _ = synth(4.0, SR, snr, seed=7, noise=noise)
            got, _ = ours.process_signal_auto(sig)
            want, _ = jax_pipe.process_signal_auto(sig)
            j_vad = np.asarray(want.vad)
            j_ora, _ = oracle.EngineVadOracle().run_all(
                *(np.asarray(x) for x in (want.energy, want.zcr, want.entropy)))
            p_ora, _ = oracle.EngineVadOracle().run_all(
                *(x.numpy() for x in (got.energy, got.zcr, got.entropy)))
            p_vad = got.vad.numpy()
            assert np.array_equal(p_vad, p_ora)
            assert np.all((p_vad == j_vad) | (j_vad != j_ora))


# -- multistream_bench -------------------------------------------------------


def _json_out(capsys) -> dict:
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")][-1]


def test_multistream_flood_on_the_cpu(capsys):
    assert multistream_bench.main(["2", "4", "--device", "cpu"]) == 0
    r = _json_out(capsys)
    assert r["n_streams"] == 2
    assert r["aggregate_audio_x_realtime"] > 2  # faster than real time
    assert len(r["per_stream_finish_s"]) == 2
    assert r["device"] == "cpu" and r["total_dispatches"] >= 2
    assert r["k1_launches"] == 0  # the plain versions launch nothing


def test_multistream_streams_keep_their_own_frames():
    """One shared pipeline, two threads: each stream's frames equal the
    plain ``process_signal`` of its own signal."""
    from sspv_tpu_torch import FeaturePipeline

    _, engines = multistream_bench.run_flood(2, 3.0, "cpu")
    cpu = FeaturePipeline(device="cpu")
    for i, rt in enumerate(engines):
        rows = list(rt.processed_data)
        want, _ = cpu.process_signal(
            _sources.speech_signal(3.0, SR, seed=i, tone_hz=120 + 40 * i))
        n = want.vad.shape[0]
        assert rt.frames_processed == n and len(rows) == min(n, 100)
        tail = slice(n - len(rows), n)  # processed_data keeps the newest
        assert np.array_equal(np.array([d["zcr"] for d in rows], np.float32),
                              want.zcr.numpy()[tail])
        assert np.array_equal(np.array([d["vad"] for d in rows]),
                              want.vad.numpy()[tail])
        assert _nmse([d["energy"] for d in rows], want.energy.numpy()[tail]) < 1e-12


def test_multistream_paced_on_the_cpu(capsys):
    assert multistream_bench.main(["2", "6", "--paced", "--device", "cpu"]) == 0
    r = _json_out(capsys)
    assert r["mode"] == "paced"
    assert r["all_frames_after_drain"] is True
    # the paced source sleeps at real-time cadence, so the wall cannot
    # undershoot the audio duration; the upper bound is load-sensitive
    assert r["wall_s"] >= 5.0
    assert isinstance(r["realtime_ok"], bool)


# -- latency_bench -----------------------------------------------------------


@pytest.mark.parametrize("mode", ["default", "ll"])
def test_latency_bench_on_the_cpu_restores_the_config(mode):
    from sspv_tpu_torch.config import Config

    before = (Config.TPU_LOW_LATENCY, Config.PROCESSED_DATA_BUFFER_SIZE)
    r = latency_bench.run_once(mode, 1024, 2.0, 0.5, "cpu")
    assert (Config.TPU_LOW_LATENCY, Config.PROCESSED_DATA_BUFFER_SIZE) == before
    assert r["frames_published"] == r["frames_expected"] == 199
    assert r["frames"] > 0 and 0 < r["median_ms"] <= r["p90_ms"] <= r["max_ms"]
    assert r["buckets"][0] == (8 if mode == "ll" else 32)
    assert r["device"] == r["card"] == "cpu"


# -- serve_bench -------------------------------------------------------------


def test_serve_bench_on_the_cpu(capsys):
    assert serve_bench.main(["--clients", "1,2", "--seconds", "1",
                             "--requests", "2", "--fmt", "npz",
                             "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.strip()]
    assert [r["clients"] for r in lines] == [1, 2]
    for r in lines:
        assert r["errors"] == []
        assert r["requests"] == 2 * r["clients"]
        assert r["p50_ms"] and r["p50_ms"] > 0
        assert r["backend"] == "cpu"


# -- process_files and sharded_throughput ------------------------------------


def _write_wavs(folder: Path) -> None:
    folder.mkdir()
    for i, seconds in enumerate((1.3, 2.7, 0.9)):
        n = int(seconds * SR)
        t = np.arange(n) / SR
        rng = np.random.default_rng(i)
        x = (rng.normal(0, 1500, n) + 7000 * np.sin(2 * np.pi * (110 + 30 * i) * t)
             * (np.sin(2 * np.pi * 1.3 * t) > 0))
        with wave.open(str(folder / f"w{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes(np.clip(x, -32768, 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def jax_features(tmp_path_factory):
    """The JAX example's exports of three WAVs (its mesh-sharded branch:
    the JAX backend here has 8 CPU devices)."""
    import sspv_tpu.utils.cache as cache

    root = tmp_path_factory.mktemp("process_files")
    _write_wavs(root / "wavs")
    saved = cache.enable_persistent_cache
    cache.enable_persistent_cache = lambda *a, **k: None  # no compile cache
    try:
        assert _original("process_files").main(
            [str(root / "wavs"), str(root / "jax")]) == 0
    finally:
        cache.enable_persistent_cache = saved
    return root


@pytest.mark.parametrize("cpu_devices", [1, 4])
def test_process_files_equals_the_jax_example(jax_features, cpu_devices,
                                              capsys):
    out = jax_features / f"port_{cpu_devices}"
    assert process_files.main([str(jax_features / "wavs"), str(out),
                               "--device", "cpu", "--cpu-devices",
                               str(cpu_devices)]) == 0
    text = capsys.readouterr().out
    assert ("mesh-sharded" in text) == (cpu_devices > 1)
    names = sorted(p.name for p in (jax_features / "jax").glob("*.npz"))
    assert names == sorted(p.name for p in out.glob("*.npz")) and len(names) == 3
    for name in names:
        with np.load(jax_features / "jax" / name) as a, np.load(out / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                if k in ("zcrs", "vads", "vads_adaptive", "sample_rate",
                         "frame_size", "hop_size"):
                    assert np.array_equal(a[k], b[k]), (name, k)
                else:
                    assert _nmse(b[k], a[k]) <= 1e-10, (name, k)


def test_sharded_throughput_on_a_cpu_mesh(capsys):
    r = sharded_throughput.run(0.5, "cpu", cpu_devices=4)
    assert r["batch"] == 4 and r["frames"] == 49 and r["k3_launches"] == 0
    assert "devices=4" in capsys.readouterr().out


# -- generate_samples --------------------------------------------------------


def test_generate_samples_default_folder_is_under_build():
    assert Path(generate_samples.DEFAULT_OUTDIR) == REPO / "build" / "sample_outputs"
    assert "build/" in (REPO / ".gitignore").read_text().split()


def test_generate_samples_match_the_committed_samples(tmp_path):
    """The five samples on the CPU against the TPU-made files in
    ``examples/sample_outputs/``: the same keys and frame counts, the VAD
    fields equal, the float fields within NMSE 1e-5."""
    paths = generate_samples.generate(str(tmp_path), "cpu")
    assert len(paths) == len(generate_samples.SAMPLES) == 5
    for name, n in generate_samples.SAMPLES.items():
        fname = f"voice_processing_data_{name}.npz"
        with np.load(REPO / "examples" / "sample_outputs" / fname) as a, \
                np.load(tmp_path / fname) as b:
            assert sorted(a.files) == sorted(b.files)
            assert a["vads"].shape[0] == b["vads"].shape[0] == n
            for k in ("vads", "vads_adaptive", "sample_rate", "frame_size",
                      "hop_size"):
                assert np.array_equal(a[k], b[k]), (name, k)
            for k in ("energies", "zcrs", "spec_entropy"):
                assert _nmse(b[k], a[k]) <= 1e-5, (name, k)


# -- the default device ------------------------------------------------------

ENTRY_POINTS = {
    "latency_bench": (latency_bench.main, []),
    "multistream_bench": (multistream_bench.main, ["1", "1"]),
    "multistream_bench --paced": (multistream_bench.main, ["1", "1", "--paced"]),
    "serve_bench": (serve_bench.main, ["--seconds", "1"]),
    "process_files": (process_files.main, ["."]),
    "sharded_throughput": (sharded_throughput.main, []),
    "vad_eval": (vad_eval.main, []),
    "generate_samples": (generate_samples.main, ["does-not-exist"]),
    "soak": (soak.main, ["1"]),
    "length_probe": (length_probe.main, ["1"]),
    "pitch_probe": (pitch_probe.main, ["1"]),
    "deep_fuzz": (deep_fuzz.main, ["1", "1"]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_the_card(name, tmp_path, monkeypatch):
    """No --device: the card, and without one an error before any work."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    monkeypatch.chdir(tmp_path)
    fn, argv = ENTRY_POINTS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(argv)
    assert not (tmp_path / "does-not-exist").exists()
