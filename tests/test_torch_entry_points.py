#!/usr/bin/env python3
"""The port's small entry points and helpers: ``demo``, ``test_system``,
``utils.npz_io`` and ``utils.profiling``, each beside its JAX counterpart.

``npz_io`` is NumPy only and source-equal to the original
(``tests/test_torch_import.py``); here a session written by the port's
exporter loads through both copies with equal fields.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sspv_tpu.utils import npz_io as jnpz
from sspv_tpu.utils.profiling import RealTimeFactor as JRealTimeFactor
from sspv_tpu_torch import SignalProcessing
from sspv_tpu_torch import demo as tdemo
from sspv_tpu_torch import test_system as tsystem
from sspv_tpu_torch.utils import (
    RealTimeFactor,
    SessionData,
    device_trace,
    export_features_npz,
    load_session,
    validate_session,
)

REPO = Path(__file__).resolve().parents[1]


def _run(module, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)


@pytest.mark.parametrize("module", ["sspv_tpu_torch.test_system",
                                    "sspv_tpu_torch.demo"])
def test_entry_points_run_on_the_cpu_when_asked(module):
    out = _run(module, "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "TPU" not in out.stdout and "tpu" not in out.stdout
    if module.endswith("test_system"):
        assert "self-test: ALL PASS" in out.stdout
        assert "[FAIL]" not in out.stdout
        assert out.stdout.count("[PASS]") == 15
    else:
        assert "demo complete" in out.stdout and "on cpu" in out.stdout


@pytest.mark.parametrize("module", ["sspv_tpu_torch.test_system",
                                    "sspv_tpu_torch.demo"])
def test_entry_points_default_to_the_card(module):
    """No --device: the card, and without one a failure, not a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    out = _run(module)
    assert out.returncode != 0
    assert "ALL PASS" not in out.stdout and "demo complete" not in out.stdout


def test_self_test_in_process_leaves_the_facade_device_alone(capsys):
    before = SignalProcessing.device
    assert tsystem.main(["--device", "cpu"]) == 0
    assert SignalProcessing.device == before == "cuda"
    assert "ALL PASS" in capsys.readouterr().out


def test_demo_in_process_returns_its_results(capsys, monkeypatch):
    monkeypatch.setattr(SignalProcessing, "device", "cpu")
    np.random.seed(0)
    out = tdemo.demo_signal_processing(device="cpu")
    n = 1 + int(np.ceil((2 * 16000 - 320) / 160))
    assert out["energies"].shape == out["zcrs"].shape == out["vads"].shape == (n,)
    # the tone is found; the noise is not voice for a fixed low-ZCR gate
    assert 20 <= out["vads"].sum() <= 60 and out["accuracy"] > 60.0
    text = capsys.readouterr().out
    assert "real-time" in text and "TPU" not in text


def test_npz_round_trip_through_both_loaders(tmp_path):
    rng = np.random.default_rng(0)
    n = 50
    feats = {
        "energy": rng.random(n).astype(np.float32),
        "zcr": rng.random(n).astype(np.float32),
        "entropy": rng.random(n).astype(np.float32),
        "vad": (rng.random(n) > 0.5).astype(np.int32),
        "vad_adaptive": (rng.random(n) > 0.5).astype(np.int32),
        "mfcc": rng.random((n, 13)).astype(np.float32),
        "f0": rng.random(n).astype(np.float32),
        "pitch_confidence": rng.random(n).astype(np.float32),
    }
    path = str(tmp_path / "s.npz")
    export_features_npz(path, feats, 16000, 320, 160)
    got, want = load_session(path), jnpz.load_session(path)
    assert isinstance(got, SessionData) and got._fields == want._fields
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got.num_frames == n and got.duration_seconds == n * 160 / 16000
    assert validate_session(got) == [] == jnpz.validate_session(want)
    bad = got._replace(vads=got.vads * 2, sample_rate=0, f0=got.f0[:-1])
    assert validate_session(bad) == jnpz.validate_session(
        jnpz.SessionData(*bad))
    assert len(validate_session(bad)) == 3 and bad.duration_seconds == 0.0
    np.savez(str(tmp_path / "short.npz"), energies=np.zeros(3))
    with pytest.raises(ValueError, match="missing keys"):
        load_session(str(tmp_path / "short.npz"))


@pytest.mark.parametrize("audio,elapsed", [(2.0, 0.5), (0.0, 0.5), (2.0, 0.0),
                                           (0.0, 0.0)])
def test_real_time_factor_equals_jax(audio, elapsed):
    got, want = RealTimeFactor(audio), JRealTimeFactor(audio)
    got.elapsed = want.elapsed = elapsed
    assert got.factor == want.factor and got.speedup == want.speedup
    with got:
        pass
    assert got.elapsed >= 0.0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with device_trace(log_dir) as prof:
        x = torch.ones(64, 64)
        (x @ x).sum().item()
    assert os.path.getsize(os.path.join(log_dir, "trace.json")) > 0
    names = {e.key for e in prof.key_averages()}
    assert any("mm" in n or "matmul" in n for n in names)
