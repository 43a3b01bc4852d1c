#!/usr/bin/env python3
"""Device dispatch of the port, and its CUDA kernels on the card.

This file imports neither jax nor sspv_tpu, so it also runs where only
PyTorch is installed. Tests marked ``cuda`` need an NVIDIA GPU and skip
without one; on a machine with the card, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: kernel vs plain version, both float32 on the same card, differ
only in summation order: zcr EXACTLY equal, energy/entropy/mfcc and pitch
confidence NMSE <= 1e-9, F0 equal on >= 99.9 % of frames (an argmax flips
only where two lags tie to rounding).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from sspv_tpu_torch.ops import _build
from sspv_tpu_torch.ops import view_kernels as vk
from sspv_tpu_torch.ops.pipeline import FeatureConfig, FeaturePipeline

REPO = Path(__file__).resolve().parents[1]


def _nmse(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device(name)


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _pitch_kwargs(pipe):
    merged, nyq_b, inv_live, inv_nyq = pipe._acf_bases(319)
    return dict(merged=merged, nyq_b=nyq_b, inv_live=inv_live,
                inv_nyq=inv_nyq, lag_min=40, lag_max=319, sample_rate=16000)


UNSUPPORTED = {
    "frame_not_2hop": dict(frame_size=300, hop_size=160),
    "hop_not_multiple_of_4": dict(frame_size=324, hop_size=162),
    "odd_n_fft": dict(n_fft=511, entropy_n_fft=511),
    "separate_entropy_spectrum": dict(entropy_n_fft=256),
    "window_with_zeros": dict(window_type="hanning"),
}


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("name", list(UNSUPPORTED))
def test_unsupported_geometry_raises(device, name):
    """Geometries the view kernels do not take need the frames path, which
    is not ported yet: the pipeline refuses them, on every device."""
    with pytest.raises(NotImplementedError):
        FeaturePipeline(FeatureConfig(**UNSUPPORTED[name]),
                        device=_device(device))


def test_wrappers_refuse_devices_without_a_kernel():
    """No quiet CPU run for a tensor elsewhere: a device with neither a
    kernel nor the plain path raises."""
    pipe = FeaturePipeline(device="cpu")
    rows = torch.zeros((5, 160), device="meta")
    with pytest.raises(ValueError):
        vk.fused_view_features(rows, **pipe._view_consts)
    with pytest.raises(ValueError):
        vk.fused_view_pitch(rows, **_pitch_kwargs(pipe))


def test_cpu_tensors_launch_nothing():
    pipe = FeaturePipeline(device="cpu")
    before = dict(vk.LAUNCHES)
    pipe.process_signal_pitch_auto(
        np.random.default_rng(0).normal(0, 1000, 16000).astype(np.float32)
    )
    assert vk.LAUNCHES == before


def test_build_recipe():
    """sm_90a, IEEE math (no fast-math), a plain-C library in build/kernels
    of the checkout, and a note on every kernel source."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert _build.BUILD_DIR == REPO / "build" / "kernels"
    for name in ("view_features.cu", "view_pitch.cu"):
        src = (REPO / "sspv_tpu_torch" / "csrc" / name).read_text()
        assert "Replaces: sspv_tpu/ops/pallas_view.py:" in src
        assert "What bounds it on the H100" in src
        assert 'extern "C" int sspv_' in src


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, 1023, 1025])
def test_kernels_match_plain_versions(n):
    dev = _device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    pipe = FeaturePipeline(device=dev)
    rows = torch.from_numpy(
        np.random.default_rng(n).normal(0, 1000, (n + 1, 160)).astype(np.float32)
    ).to(dev)
    before = dict(vk.LAUNCHES)
    got = vk.fused_view_features(rows, **pipe._view_consts)
    want = vk.view_features_plain(rows, **pipe._view_consts)
    torch.cuda.synchronize()
    assert torch.equal(got["zcr"], want["zcr"])
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(got[k].cpu(), want[k].cpu()) <= 1e-9, k
    f0, conf = vk.fused_view_pitch(rows, **_pitch_kwargs(pipe))
    pf0, pconf = vk.view_pitch_plain(rows, **_pitch_kwargs(pipe))
    assert (f0 == pf0).float().mean().item() >= 0.999
    assert _nmse(conf.cpu(), pconf.cpu()) <= 1e-9
    assert vk.LAUNCHES["view_features"] == before["view_features"] + 1
    assert vk.LAUNCHES["view_pitch"] == before["view_pitch"] + 1


@pytest.mark.cuda
def test_kernels_reject_what_they_cannot_take():
    dev = _device("cuda")
    pipe = FeaturePipeline(device=dev)
    with pytest.raises(NotImplementedError):  # hop % 4 != 0
        vk.fused_view_features(torch.zeros((5, 162), device=dev),
                               **pipe._view_consts)
    cpu_consts = FeaturePipeline(device="cpu")._view_consts
    with pytest.raises(ValueError):  # constants on another device
        vk.fused_view_features(torch.zeros((5, 160), device=dev), **cpu_consts)


@pytest.mark.cuda
def test_pipeline_on_cuda_matches_cpu():
    """The whole signal path on the card (kernels) against the same path on
    the CPU (plain versions): zcr, VAD and F0 equal, features to NMSE."""
    dev = _device("cuda")
    rng = np.random.default_rng(3)
    t = np.arange(5 * 16000) / 16000
    sig = np.where(((t * 4).astype(int) % 2) == 1,
                   6000 * np.sin(2 * np.pi * 130 * t),
                   rng.normal(0, 300, t.size)).astype(np.float32)
    gpu = FeaturePipeline(device=dev).process_signal_pitch_auto(sig)
    cpu = FeaturePipeline(device="cpu").process_signal_pitch_auto(sig)
    gblock, cblock = gpu[0], cpu[0]
    assert torch.equal(gblock.zcr.cpu(), cblock.zcr)
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(getattr(gblock, k).cpu(), getattr(cblock, k)) <= 1e-9, k
    assert torch.equal(gblock.vad.cpu(), cblock.vad)
    assert np.mean(gpu[2] == cpu[2]) >= 0.999
