#!/usr/bin/env python3
"""The port's corpus processor (``sspv_tpu_torch.batch``), its analyzer
(``sspv_tpu_torch.analyze``) and the shared export (``utils/export.py``),
on the CPU (``device="cpu"``).

The cases of ``tests/test_batch.py`` run on the port: masked batches equal
the single-file path, per-file npz/JSONL outputs land, the CLI runs end to
end (``--device cpu`` in a subprocess), resume keeps its semantics. Then the
port's ``process_corpus`` and ``analyze_file`` are held to the JAX
package's on the same WAV files, and the export copy to its original.
Tolerances against the JAX package: zcr and VAD EXACTLY equal,
energy/entropy/mfcc NMSE <= 1e-9, F0 identical, confidence NMSE <= 1e-9.
Within the port, the batch's frames (K3) and the single-file view path (K1)
agree to the same tolerances.
"""

import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest

from sspv_tpu_torch.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000


def _nmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


def _write_wav(path, duration_s, freq, noise=0.0, seed=0):
    """A tone in the middle half of the file (the JAX package's test
    corpus), with an optional noise floor over the whole file."""
    t = np.arange(int(duration_s * SR)) / SR
    sig = np.random.default_rng(seed).normal(0, noise, t.size) if noise \
        else np.zeros_like(t)
    lo, hi = len(t) // 4, 3 * len(t) // 4
    sig[lo:hi] += np.sin(2 * np.pi * freq * t[lo:hi]) * 8000
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(sig.astype("<i2").tobytes())
    return str(path)


def _corpus(tmp_path, noise=0.0):
    return [
        _write_wav(tmp_path / "a_short.wav", 0.7, 110.0, noise, 1),
        _write_wav(tmp_path / "b_mid.wav", 1.9, 160.0, noise, 2),
        _write_wav(tmp_path / "c_longer.wav", 3.1, 220.0, noise, 3),  # next bucket
        _write_wav(tmp_path / "d_tiny.wav", 0.3, 130.0, noise, 4),
    ]


def _decode(path):
    from sspv_tpu_torch.batch import _decode

    return _decode(path)


def process_corpus(files, **kw):
    from sspv_tpu_torch.batch import process_corpus as pc

    return pc(files, device="cpu", **kw)


def test_process_corpus_matches_single_file_path(tmp_path):
    from sspv_tpu_torch.ops.pipeline import FeatureConfig, FeaturePipeline

    files = _corpus(tmp_path)
    summaries = process_corpus(files, out_dir=str(tmp_path / "out"),
                               batch_size=3, want_pitch=True)
    assert [s["file"] for s in summaries] == files

    pipe = FeaturePipeline(FeatureConfig.from_config(Config), device="cpu")
    for path, s in zip(files, summaries):
        block, _, f0, conf = pipe.process_signal_pitch_auto(_decode(path))
        vad = block.vad.numpy()
        assert s["frames"] == vad.shape[0]
        assert s["voiced_frames"] == int(vad.sum())
        with np.load(s["npz"]) as z:
            np.testing.assert_array_equal(z["vads"], vad)
            np.testing.assert_array_equal(z["zcrs"], block.zcr.numpy())
            assert _nmse(z["energies"], block.energy) <= 1e-9
            assert _nmse(z["mfcc"], block.mfcc) <= 1e-9
            np.testing.assert_array_equal(z["f0"], f0)
            assert _nmse(z["pitch_confidence"], conf) <= 1e-9
            assert z["f0"].shape == vad.shape == z["pitch_confidence"].shape


def test_process_corpus_pitch_tracks_tones(tmp_path):
    files = [
        _write_wav(tmp_path / "t100.wav", 1.5, 100.0),
        _write_wav(tmp_path / "t200.wav", 1.5, 200.0),
    ]
    summaries = process_corpus(files, out_dir=None, want_pitch=True)
    assert abs(summaries[0]["median_f0_hz"] - 100.0) < 5
    assert abs(summaries[1]["median_f0_hz"] - 200.0) < 8


def test_process_corpus_pure_dp_mesh_matches(tmp_path):
    """dp=8 (every row its own device) gives the answers of the default
    dp=4/seq=2 mesh and of one device: results are mesh-shape-invariant."""
    from sspv_tpu_torch.parallel import make_mesh

    files = _corpus(tmp_path)
    a = process_corpus(files, out_dir=None, batch_size=8)
    b = process_corpus(files, out_dir=None, batch_size=8,
                       mesh=make_mesh(8, dp=8, device="cpu"))
    c = process_corpus(files, out_dir=None, batch_size=8,
                       mesh=make_mesh(8, device="cpu"))
    assert a == b == c


def test_collect_inputs_walks_and_dedupes(tmp_path):
    from sspv_tpu_torch.batch import collect_inputs

    files = _corpus(tmp_path)
    (tmp_path / "sub").mkdir()
    _write_wav(tmp_path / "sub" / "e.wav", 0.4, 150.0)
    (tmp_path / "notes.txt").write_text("not audio")
    got = collect_inputs([str(tmp_path), files[0]])
    assert len(got) == 5  # 4 + sub/e.wav, txt skipped, no dup of files[0]
    assert all(g.endswith(".wav") for g in got)
    with pytest.raises(FileNotFoundError):
        collect_inputs([str(tmp_path / "missing.wav")])


def test_batch_cli_end_to_end(tmp_path):
    files = _corpus(tmp_path)
    out = tmp_path / "cli_out"
    jsonl = tmp_path / "summaries.jsonl"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-m", "sspv_tpu_torch.batch", str(tmp_path),
         "--out-dir", str(out), "--jsonl", str(jsonl), "--batch", "2",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    lines = [json.loads(x) for x in r.stdout.splitlines() if x.strip()]
    assert len(lines) == len(files)
    agg = json.loads(r.stderr.splitlines()[-1])
    assert agg["files"] == len(files) and agg["errors"] == 0
    assert set(agg["seconds"]) == {"decode", "device", "write"}
    assert os.path.exists(out / "a_short.npz")
    assert len(jsonl.read_text().splitlines()) == len(files)


def test_batch_cli_defaults_to_the_card(tmp_path):
    """No CPU fallback: without a card the CLI's default device raises."""
    import torch

    from sspv_tpu_torch.batch import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    wav = _write_wav(tmp_path / "x.wav", 0.5, 150.0)
    with pytest.raises(RuntimeError):
        main([wav, "--no-npz"])


def test_npz_names_never_collide(tmp_path):
    """Same-named files in different directories must not overwrite each
    other's feature exports."""
    (tmp_path / "s1").mkdir()
    (tmp_path / "s2").mkdir()
    f1 = _write_wav(tmp_path / "s1" / "take.wav", 0.5, 100.0)
    f2 = _write_wav(tmp_path / "s2" / "take.wav", 0.5, 220.0)
    summaries = process_corpus([f1, f2], out_dir=str(tmp_path / "out"))
    paths = [s["npz"] for s in summaries]
    assert len(set(paths)) == 2
    assert all(os.path.exists(p) for p in paths)
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        assert not np.array_equal(a["zcrs"], b["zcrs"])


def test_windowed_passes_match_single_pass(tmp_path):
    files = _corpus(tmp_path)
    a = process_corpus(files, out_dir=None, files_per_pass=2)
    b = process_corpus(files, out_dir=None, files_per_pass=256)
    assert a == b


def test_undecodable_file_yields_error_summary(tmp_path):
    _write_wav(tmp_path / "good1.wav", 0.5, 150.0)
    (tmp_path / "bad.wav").write_bytes(b"RIFFgarbage-not-audio")
    _write_wav(tmp_path / "good2.wav", 0.4, 200.0)
    files = sorted(str(p) for p in tmp_path.glob("*.wav"))
    summaries = process_corpus(files, out_dir=None)
    by_name = {s["file"]: s for s in summaries}
    assert "error" in by_name[str(tmp_path / "bad.wav")]
    for good in ("good1.wav", "good2.wav"):
        s = by_name[str(tmp_path / good)]
        assert "error" not in s and s["frames"] > 0


def test_ragged_tails_share_one_shape(tmp_path, monkeypatch):
    """A batch pads only to its longest row and a ragged tail (5 files ->
    4 + 1 with batch_size=4) has only the rows it needs (one data device
    here); both take the VAD order of the JAX package's (B, bucket) shape,
    the 2 s bucket's 199 frames."""
    from sspv_tpu_torch.parallel import BatchPipeline

    for k in range(5):
        _write_wav(tmp_path / f"t{k}.wav", 0.3, 120.0 + 10 * k)
    files = sorted(str(p) for p in tmp_path.glob("*.wav"))
    shapes = []
    real = BatchPipeline._exact_batch

    def recording(self, signals, lengths, route_frames, band=None, **kw):
        shapes.append((signals.shape, tuple(int(x) for x in lengths),
                       route_frames))
        return real(self, signals, lengths, route_frames, band, **kw)

    monkeypatch.setattr(BatchPipeline, "_exact_batch", recording)
    summaries = process_corpus(files, out_dir=None, batch_size=4)
    assert all("error" not in s and s["frames"] > 0 for s in summaries)
    n = int(0.3 * SR)
    assert shapes == [((4, n), (n,) * 4, 199), ((1, n), (n,), 199)]


def test_oversized_files_take_the_single_file_path(tmp_path, monkeypatch):
    """A file past the largest bucket runs process_signal(_pitch)_auto on
    its own (buckets shrunk here so the file stays small)."""
    from sspv_tpu_torch.ops.pipeline import FeatureConfig, FeaturePipeline

    monkeypatch.setattr(FeaturePipeline, "SIGNAL_BUCKET_SECONDS", (1, 2))
    files = [_write_wav(tmp_path / "big.wav", 3.3, 150.0, 50.0),
             _write_wav(tmp_path / "small.wav", 0.9, 150.0, 50.0)]
    summaries = process_corpus(files, out_dir=str(tmp_path / "o"),
                               want_pitch=True)
    pipe = FeaturePipeline(FeatureConfig.from_config(Config), device="cpu")
    block, _, f0, _ = pipe.process_signal_pitch_auto(_decode(files[0]))
    with np.load(summaries[0]["npz"]) as z:
        np.testing.assert_array_equal(z["vads"], block.vad.numpy())
        np.testing.assert_array_equal(z["energies"], block.energy.numpy())
        np.testing.assert_array_equal(z["f0"], f0)
    assert summaries[1]["frames"] == 1 + (int(0.9 * SR) - 320) // 160


def _count_decodes(monkeypatch):
    import sspv_tpu_torch.batch as batch_mod

    calls = []
    orig = batch_mod._decode
    monkeypatch.setattr(
        batch_mod, "_decode", lambda p: (calls.append(p), orig(p))[1]
    )
    return calls


def test_resume_skips_completed_files(tmp_path, monkeypatch):
    files = _corpus(tmp_path)
    manifest = str(tmp_path / "manifest.jsonl")
    out_dir = str(tmp_path / "out")
    first = process_corpus(files, out_dir=out_dir, manifest=manifest)
    assert all("error" not in s for s in first)
    mtimes = {s["npz"]: os.path.getmtime(s["npz"]) for s in first}

    calls = _count_decodes(monkeypatch)
    second = process_corpus(files, out_dir=out_dir, manifest=manifest,
                            resume=True)
    assert calls == []  # nothing re-decoded
    for a, b in zip(first, second):
        assert b.pop("resumed") is True
        assert a == b
    for p, m in mtimes.items():
        assert os.path.getmtime(p) == m  # exports untouched


def test_resume_retries_errors_and_lost_npz(tmp_path, monkeypatch):
    good = _write_wav(tmp_path / "good.wav", 0.5, 150.0)
    other = _write_wav(tmp_path / "other.wav", 0.6, 200.0)
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"RIFFgarbage")
    files = sorted([good, other, bad])
    manifest = str(tmp_path / "m.jsonl")
    out_dir = str(tmp_path / "out")
    first = process_corpus(files, out_dir=out_dir, manifest=manifest)
    assert sum("error" in s for s in first) == 1

    _write_wav(bad, 0.4, 120.0)  # the operator fixed the corrupt file
    lost = next(s["npz"] for s in first if s["file"] == good)
    os.remove(lost)

    calls = _count_decodes(monkeypatch)
    second = process_corpus(files, out_dir=out_dir, manifest=manifest,
                            resume=True)
    assert sorted(calls) == sorted([bad, good])
    by = {s["file"]: s for s in second}
    assert "error" not in by[bad] and not by[bad].get("resumed")
    assert os.path.exists(by[good]["npz"])  # re-exported
    assert by[other].get("resumed") is True


def test_resume_tolerates_torn_manifest_line(tmp_path):
    files = _corpus(tmp_path)[:2]
    manifest = str(tmp_path / "m.jsonl")
    process_corpus(files, out_dir=None, manifest=manifest)
    with open(manifest) as f:
        lines = f.read().splitlines()
    with open(manifest, "w") as f:
        f.write(lines[0] + "\n" + lines[1][: len(lines[1]) // 2])
    out = process_corpus(files, out_dir=None, manifest=manifest, resume=True)
    assert out[0].get("resumed") is True
    assert "resumed" not in out[1] and out[1]["frames"] > 0


def test_resume_reprocesses_for_pitch_upgrade(tmp_path):
    files = _corpus(tmp_path)[:2]
    manifest = str(tmp_path / "m.jsonl")
    process_corpus(files, out_dir=None, manifest=manifest)
    out = process_corpus(files, out_dir=None, manifest=manifest, resume=True,
                         want_pitch=True)
    assert all("median_f0_hz" in s and not s.get("resumed") for s in out)


def test_resume_requires_manifest():
    with pytest.raises(ValueError, match="manifest"):
        process_corpus(["x.wav"], resume=True)


# -- against the JAX package ----------------------------------------------------


def _assert_npz_match(got_path, want_path):
    with np.load(got_path) as g, np.load(want_path) as w:
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        for k in ("zcrs", "vads", "vads_adaptive", "f0", "sample_rate",
                  "frame_size", "hop_size"):
            if k in w.files:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        for k in ("energies", "spec_entropy", "mfcc", "pitch_confidence"):
            if k in w.files:
                assert _nmse(g[k], w[k]) <= 1e-9, k


def _assert_summaries_match(got, want):
    got = {k: v for k, v in got.items() if k != "npz"}
    want = {k: v for k, v in want.items() if k != "npz"}
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k == "mean_energy":
            assert got[k] == pytest.approx(v, rel=1e-6)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("want_pitch", [False, True])
def test_process_corpus_matches_jax(tmp_path, want_pitch):
    """The port's corpus run and the JAX package's (its 8-device mesh) on
    the same WAV files (noise floor, tones, five lengths over two buckets)
    give the same summaries and npz files."""
    from sspv_tpu.batch import process_corpus as jax_process_corpus

    files = _corpus(tmp_path, noise=60.0) + [
        _write_wav(tmp_path / "e_full.wav", 2.0, 175.0, 60.0, 5)]
    got = process_corpus(files, out_dir=str(tmp_path / "port"),
                         want_pitch=want_pitch, batch_size=4)
    want = jax_process_corpus(files, out_dir=str(tmp_path / "jax"),
                              want_pitch=want_pitch, batch_size=4)
    for g, w in zip(got, want):
        _assert_summaries_match(g, w)
        _assert_npz_match(g["npz"], w["npz"])
    if want_pitch:
        assert abs(got[2]["median_f0_hz"] - 220.0) < 8


def test_analyze_matches_jax(tmp_path):
    from sspv_tpu.analyze import analyze_file as jax_analyze_file
    from sspv_tpu_torch.analyze import analyze_file

    wav = _write_wav(tmp_path / "a.wav", 2.6, 140.0, 60.0, 7)
    got = analyze_file(wav, npz=str(tmp_path / "port.npz"),
                       png=str(tmp_path / "port.png"), device="cpu")
    want = jax_analyze_file(wav, npz=str(tmp_path / "jax.npz"))
    assert got.pop("png") == str(tmp_path / "port.png")
    assert os.path.getsize(tmp_path / "port.png") > 0
    _assert_summaries_match(got, want)
    _assert_npz_match(got["npz"], want["npz"])
    assert abs(got["median_f0_hz"] - 140.0) < 5


def test_analyze_cli(tmp_path):
    wav = _write_wav(tmp_path / "a.wav", 1.2, 180.0, 60.0, 8)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-m", "sspv_tpu_torch.analyze", wav, "--npz",
         str(tmp_path / "a.npz"), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert r.returncode == 0, r.stderr
    summary = json.loads(r.stdout.splitlines()[-1])
    assert summary["frames"] == 1 + (int(1.2 * SR) - 320) // 160
    assert os.path.exists(summary["npz"])


EXPORT_EXTRAS = {"none": (), "f0": ("f0",),
                 "f0_confidence": ("f0", "pitch_confidence")}


@pytest.mark.parametrize("extras", list(EXPORT_EXTRAS))
def test_export_copy_equals_jax(tmp_path, extras):
    """``sspv_tpu_torch.utils.export`` is a copy of the JAX package's: the
    same summary dict and the same npz keys, dtypes and values."""
    from sspv_tpu.utils import export as jexport
    from sspv_tpu_torch.utils import export as texport

    rng = np.random.default_rng(3)
    n = 57
    sl = {"energy": rng.random(n).astype(np.float32) * 1e6,
          "zcr": rng.random(n).astype(np.float32),
          "entropy": rng.random(n).astype(np.float32),
          "mfcc": rng.normal(0, 10, (n, 13)).astype(np.float32),
          "vad": (rng.random(n) > 0.5).astype(np.int32),
          "vad_adaptive": (rng.random(n) > 0.5).astype(np.int32),
          "f0": np.where(rng.random(n) > 0.5, 120.0, 0.0).astype(np.float32),
          "pitch_confidence": rng.random(n).astype(np.float32)}
    for k in ("f0", "pitch_confidence"):
        if k not in EXPORT_EXTRAS[extras]:
            del sl[k]
    assert (texport.summarize_features("x.wav", 9999, sl, SR)
            == jexport.summarize_features("x.wav", 9999, sl, SR))
    empty = {k: v[:0] for k, v in sl.items()}
    assert (texport.summarize_features("y.wav", 10, empty, SR)
            == jexport.summarize_features("y.wav", 10, empty, SR))
    got = texport.export_features_npz(str(tmp_path / "t.npz"), sl, SR, 320, 160)
    want = jexport.export_features_npz(str(tmp_path / "j.npz"), sl, SR, 320, 160)
    with np.load(got) as g, np.load(want) as w:
        assert g.files == w.files
        for k in w.files:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
