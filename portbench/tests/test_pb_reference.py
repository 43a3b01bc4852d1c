"""The plain reference against the port's plain (CPU) versions at a small
size, for both configurations."""

import numpy as np
import pytest
import torch

from portbench.harness.audio import speech
from portbench.harness.core import load
from portbench.reference.features import features, mel_filterbank, window
from portbench.reference.pitch import pitch
from portbench.reference.vad import hangover, vad

CONFIGS = ("sspv-default", "whisper-frontend")


def _signal(seed: int, seconds: float = 6.0) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return speech(int(seconds * 16000), 16000, gen)


def _port(cfg: dict, pcm: torch.Tensor):
    from sspv_tpu_torch.ops.pipeline import FeatureConfig, FeaturePipeline

    pipe = FeaturePipeline(FeatureConfig(**cfg), device="cpu")
    block, _ = pipe.process_signal_device(pcm.numpy())
    return pipe, {k: getattr(block, k).numpy() for k in block._fields}


def _nmse(p, r):
    return float(((np.asarray(p, np.float64) - r) ** 2).sum() / (r ** 2).sum())


@pytest.mark.parametrize("name", CONFIGS)
def test_features_match_the_port(name):
    cfg = load("configs", name)["feature_config"]
    pcm = _signal(7)
    _, got = _port(cfg, pcm)
    ref = features(pcm, cfg)
    assert len(ref["energy"]) == len(got["energy"]) == \
        1 + (len(pcm) - cfg["frame_size"]) // cfg["hop_size"]
    np.testing.assert_array_equal(got["zcr"], ref["zcr"].astype(np.float32))
    for k in ("energy", "entropy", "mfcc"):
        # float32 against float64: rounding alone, far under the 1e-9 limit
        assert _nmse(got[k], ref[k]) < 1e-11, k


@pytest.mark.parametrize("name", CONFIGS)
def test_vad_over_the_ports_features_is_exact(name):
    cfg = load("configs", name)["feature_config"]
    _, got = _port(cfg, _signal(11))
    want = vad(got["energy"], got["zcr"], got["entropy"], cfg)
    np.testing.assert_array_equal(got["vad"], want["vad"])
    np.testing.assert_array_equal(got["vad_adaptive"], want["vad_adaptive"])
    assert 0 < got["vad"].sum() < len(got["vad"])


def test_pitch_matches_the_port():
    cfg = load("configs", "sspv-default")["feature_config"]
    band = load("configs", "sspv-default")["pitch"]
    pcm = _signal(13)
    pipe, _ = _port(cfg, pcm)
    block, _, f0, conf = pipe.process_signal_pitch_auto(
        pcm.numpy(), fmin=band["fmin"], fmax=band["fmax"],
        min_confidence=band["min_confidence"])
    ref = pitch(pcm, block.vad.numpy(), cfg, band)
    np.testing.assert_array_equal(f0, ref["f0"])
    assert np.abs(conf - ref["confidence"]).max() < 1e-5
    assert (f0 > 0).sum() > 50


def test_hangover_automaton():
    # a voiced frame holds ON frames, then OFF - 1 more before release; the
    # cold start outputs 1 for the first OFF - 1 frames
    on, off = 3, 2
    x = np.zeros(12, bool)
    x[4] = True
    assert hangover(x, on, off).tolist() == [1, 0, 0, 0, 1, 1, 1, 1, 1, 0,
                                               0, 0]


def test_tables():
    cfg = load("configs", "sspv-default")["feature_config"]
    w = window(cfg)
    assert w[0] == pytest.approx(0.08) and w[-1] == pytest.approx(0.08)
    fb = mel_filterbank(cfg)
    assert fb.shape == (26, 257) and (fb.sum(axis=1) > 0).all()
    whisper = load("configs", "whisper-frontend")["feature_config"]
    assert window(whisper)[0] == 0 and mel_filterbank(whisper).shape == (80, 201)
