#!/usr/bin/env python3
"""The port's application entry point (``sspv_tpu_torch/main.py``) in
process, as ``tests/test_main_entry.py`` drives the JAX package's: env-driven
source selection (``RTP_INPUT_FILE`` / ``RTP_INPUT_DIR``), a headless UI run
to the end of the input and the snapshot export, with ``--device cpu``."""

import os
import wave

import numpy as np
import pytest
import torch

from sspv_tpu_torch import main as main_mod
from sspv_tpu_torch.config import Config


def _write_wav(path, seconds=0.3, freq=220.0):
    sr = Config.SAMPLE_RATE
    t = np.arange(int(seconds * sr)) / sr
    sig = (np.sin(2 * np.pi * freq * t) * 11000).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(sig.tobytes())
    return str(path)


def _headless(monkeypatch, tmp_path, **env):
    snap = str(tmp_path / "snap.png")
    monkeypatch.setenv("RTP_HEADLESS", "1")
    monkeypatch.setenv("RTP_SNAPSHOT", snap)
    monkeypatch.setenv("RTP_DURATION", "60")  # upper bound; EOF stops earlier
    for k in ("RTP_INPUT_FILE", "RTP_INPUT_DIR"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return snap


def test_main_headless_single_file(monkeypatch, tmp_path):
    snap = _headless(monkeypatch, tmp_path,
                     RTP_INPUT_FILE=_write_wav(tmp_path / "tone.wav"))
    main_mod.main(["--device", "cpu"])
    assert os.path.exists(snap) and os.path.getsize(snap) > 0


def test_main_headless_playlist_dir(monkeypatch, tmp_path):
    for name in ("a.wav", "b.wav"):
        _write_wav(tmp_path / name, seconds=0.2)
    snap = _headless(monkeypatch, tmp_path, RTP_INPUT_DIR=str(tmp_path))
    main_mod.main(["--device", "cpu"])
    assert os.path.exists(snap) and os.path.getsize(snap) > 0


def test_main_defaults_to_the_card(monkeypatch, tmp_path):
    """Without ``--device`` the engine is built on the card: without one,
    ``main`` raises instead of falling back to the CPU."""
    _headless(monkeypatch, tmp_path,
              RTP_INPUT_FILE=_write_wav(tmp_path / "tone.wav"))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        main_mod.main([])
