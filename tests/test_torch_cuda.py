#!/usr/bin/env python3
"""Device dispatch of the port, and its CUDA kernels on the card.

This file imports neither jax nor sspv_tpu, so it also runs where only
PyTorch is installed. Tests marked ``cuda`` need an NVIDIA GPU and skip
without one; on a machine with the card, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: kernel vs plain version, both float32 on the same card, differ
only in summation order: zcr EXACTLY equal, energy/entropy/mfcc and pitch
confidence NMSE <= 1e-9, F0 equal on >= 99.9 % of frames (an argmax flips
only where two lags tie to rounding). The VAD kernel's decisions and new
state EQUAL the plain version's (float64 window sums of float32 inputs).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from sspv_tpu_torch.ops import _build
from sspv_tpu_torch.ops import frame_kernels as fk
from sspv_tpu_torch.ops import vad as tvad
from sspv_tpu_torch.ops import vad_kernels
from sspv_tpu_torch.ops import view_kernels as vk
from sspv_tpu_torch.ops.pipeline import FeatureConfig, FeaturePipeline

import engine_blocks
import vad_inputs

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
    "n_fft_not_a_power_of_two": dict(n_fft=640, entropy_n_fft=640),
    "odd_n_fft": dict(n_fft=511, entropy_n_fft=511),
    "separate_entropy_spectrum": dict(entropy_n_fft=256),
}


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("name", list(UNSUPPORTED))
def test_unsupported_geometry_raises(device, name):
    """View geometries (frame == 2*hop, positive window) that the view
    features kernel does not take (its FFT serves neither transform, and it
    has no second entropy spectrum), which the JAX package serves with its
    XLA view path: the view routes do not raise but run K3 on the frames formed
    on the device, so process_signal_device gives exactly the frames path's
    block (process_signal), launching K3 and no view kernel; the engine's
    samples dispatch stays on, as in the JAX package."""
    pipe = FeaturePipeline(FeatureConfig(**UNSUPPORTED[name]),
                           device=_device(device))
    sig = np.random.default_rng(0).normal(0, 1000, 4000).astype(np.float32)
    before = dict(vk.LAUNCHES)
    got, got_state = pipe.process_signal_device(sig)
    if device == "cuda":
        torch.cuda.synchronize()
        assert vk.LAUNCHES["frame_features"] == before["frame_features"] + 1
        assert vk.LAUNCHES["view_features"] == before["view_features"]
    assert pipe.supports_samples_dispatch()
    block, state = pipe.process_signal(sig)
    assert block.energy.shape == (1 + (4000 - pipe.cfg.frame_size)
                                  // pipe.cfg.hop_size,)
    for a, b in zip(got, block):
        assert torch.equal(a, b)
    assert torch.equal(got_state.count, state.count)


def test_wrappers_refuse_devices_without_a_kernel():
    """No quiet CPU run for a tensor elsewhere: a device with neither a
    kernel nor the plain path raises."""
    pipe = FeaturePipeline(device="cpu")
    rows = torch.zeros((5, 160), device="meta")
    with pytest.raises(ValueError):
        vk.fused_view_features(rows, **pipe._view_consts)
    with pytest.raises(ValueError):
        vk.fused_view_pitch(rows, **_pitch_kwargs(pipe))
    with pytest.raises(ValueError):
        fk.fused_features(torch.zeros((5, 320), device="meta"),
                          **pipe._frame_consts)


def test_cpu_tensors_launch_nothing():
    pipe = FeaturePipeline(device="cpu")
    before = dict(vk.LAUNCHES)
    sig = np.random.default_rng(0).normal(0, 1000, 16000).astype(np.float32)
    pipe.process_signal_pitch_auto(sig)
    pipe.process_signal(sig)
    assert vk.LAUNCHES == before


def test_build_recipe():
    """sm_90a, IEEE math (no fast-math), a plain-C library in build/kernels
    of the checkout, and a note on every kernel source."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert _build.BUILD_DIR == REPO / "build" / "kernels"
    for name, tpu in (("view_features.cu", "pallas_view.py:169"),
                      ("view_pitch.cu", "pallas_view.py:476"),
                      ("frame_features.cu", "pallas_kernels.py:43"),
                      ("vad.cu", "vad.py:401")):
        src = (REPO / "sspv_tpu_torch" / "csrc" / name).read_text()
        assert f"Replaces: sspv_tpu/ops/{tpu}" in src
        assert "What bounds it on the H100" in src
        assert 'extern "C" int sspv_' in src
    # K1, K2 and K3's FFT route share the device FFT, whose twiddles come from
    # the host-built table: no sine or cosine is computed in any kernel; K1
    # and K3's FFT route share their tail
    csrc = REPO / "sspv_tpu_torch" / "csrc"
    for name in ("view_features.cu", "frame_features.cu", "view_pitch.cu"):
        assert '#include "fft.cuh"' in (csrc / name).read_text()
    for name in ("view_features.cu", "frame_features.cu"):
        assert "sspv::spectral_tail<N>(" in (csrc / name).read_text()
    assert "dft_power" not in "".join(
        p.read_text() for p in csrc.iterdir())  # no dense K1 left
    for path in csrc.iterdir():
        code = "\n".join(line.split("//")[0]
                         for line in path.read_text().splitlines())
        assert "sincos" not in code and "cosf(" not in code \
            and "sinf(" not in code, path.name


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
@pytest.mark.parametrize("n", [1, 17, 1025])
def test_pitch_kernel_takes_any_hop(n):
    """K2 at 322/161 (hop % 4 != 0: one-float sample reads) against its
    plain version, and through pitch_track_signal."""
    from sspv_tpu_torch.ops.pitch import pitch_track_signal

    dev = _device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    pipe = FeaturePipeline(FeatureConfig(frame_size=322, hop_size=161),
                           device=dev)
    merged, nyq_b, inv_live, inv_nyq = pipe._acf_bases(320)
    kw = dict(merged=merged, nyq_b=nyq_b, inv_live=inv_live, inv_nyq=inv_nyq,
              lag_min=40, lag_max=320, sample_rate=16000)
    rows = torch.from_numpy(
        np.random.default_rng(n).normal(0, 1000, (n + 1, 161)).astype(np.float32)
    ).to(dev)
    before = vk.LAUNCHES["view_pitch"]
    f0, conf = vk.fused_view_pitch(rows, **kw)
    pf0, pconf = vk.view_pitch_plain(rows, **kw)
    torch.cuda.synchronize()
    assert vk.LAUNCHES["view_pitch"] == before + 1
    assert (f0 == pf0).float().mean().item() >= 0.999
    assert _nmse(conf.cpu(), pconf.cpu()) <= 1e-9
    vad = torch.ones(n, dtype=torch.int32, device=dev)
    tf0, tconf = pitch_track_signal(rows, vad, 322, 161,
                                    min_confidence=float("-inf"))
    assert vk.LAUNCHES["view_pitch"] == before + 2
    assert torch.equal(tf0, f0) and torch.equal(tconf, conf)


def _frame_consts(dev, frame: int, window: str = "hamming",
                  entropy_n_fft: int = 512, n_fft: int = 512,
                  num_filters: int = 26) -> dict:
    """K3's arguments, from a pipeline of that geometry (26 filters unless
    said, 13 cepstra)."""
    cfg = FeatureConfig(frame_size=frame, window_type=window, n_fft=n_fft,
                        entropy_n_fft=entropy_n_fft, num_filters=num_filters)
    return FeaturePipeline(cfg, device=dev)._frame_consts


# (frame_size, window, entropy_n_fft, n_fft[, num_filters]): the engine's
# and the ASR front end's framing, a window with zeros, a separate entropy
# spectrum (all on K3's FFT route at N = 512), a frame longer than n_fft
# with one-float loads (1030 % 4 == 2; dense route), the FFT route at
# N = 1024 (513 bins), the dense route with one column tile of 17 bins, and
# Whisper's framing (a 400-point DFT, Hann, 80 mel bands; dense route).
K3_CASES = {
    "hamming_320": (320, "hamming", 512, 512),
    "hamming_400": (400, "hamming", 512, 512),
    "hann_400": (400, "hanning", 512, 512),
    "entropy_1024": (400, "hamming", 1024, 512),
    "hamming_1030": (1030, "hamming", 512, 512),
    "n_fft_1024": (400, "hamming", 1024, 1024),
    "n_fft_32": (64, "hamming", 32, 32),
    "whisper_400_of_400": (400, "hanning", 400, 400, 80),
}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 8, 255, 257])
@pytest.mark.parametrize("case", list(K3_CASES))
def test_frame_kernel_matches_plain_version(case, n):
    dev = _device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    frame, window, ent, n_fft, *nf = K3_CASES[case]
    consts = _frame_consts(dev, frame, window, ent, n_fft, *nf)
    frames = torch.from_numpy(
        np.random.default_rng(n).normal(0, 1000, (n, frame)).astype(np.float32)
    ).to(dev)
    before = fk.LAUNCHES["frame_features"]
    got = fk.fused_features(frames, **consts)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["frame_features"] == before + 1
    want = fk.frame_features_plain(frames, **consts)
    assert got["mfcc"].shape == (n, 13)
    assert torch.equal(got["zcr"], want["zcr"])
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(got[k].cpu(), want[k].cpu()) <= 1e-9, k


# K3's two kernels: (frame_size, n_fft, the route the wrapper must take)
K3_ROUTES = {
    "fft_400_of_512": (400, 512, "fft"),
    "fft_322_of_512_one_float_reads": (322, 512, "fft"),
    "fft_200_of_256": (200, 256, "fft"),
    "fft_1500_of_2048": (1500, 2048, "fft"),
    "dense_odd_n_fft": (400, 511, "dense"),
    "dense_n_fft_480": (400, 480, "dense"),
    "dense_frame_longer_than_n_fft": (1030, 512, "dense"),
    "dense_n_fft_400": (400, 400, "dense"),
    "dense_n_fft_640": (320, 640, "dense"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K3_ROUTES))
def test_frame_kernel_routes(case):
    """Each geometry launches the K3 kernel the wrapper chose for it, once,
    and that kernel equals the plain version."""
    dev = _device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    frame, n_fft, route = K3_ROUTES[case]
    consts = _frame_consts(dev, frame, "hamming", n_fft, n_fft)
    assert fk.kernel_route(frame, n_fft // 2 + 1, consts["n_fft"]) == route
    frames = torch.from_numpy(
        np.random.default_rng(frame).normal(0, 1000, (300, frame))
        .astype(np.float32)).to(dev)
    before = dict(fk.ROUTES)
    got = fk.fused_features(frames, **consts)
    torch.cuda.synchronize()
    other = "dense" if route == "fft" else "fft"
    assert fk.ROUTES["frame_features_" + route] == \
        before["frame_features_" + route] + 1
    assert fk.ROUTES["frame_features_" + other] == \
        before["frame_features_" + other]
    want = fk.frame_features_plain(frames, **consts)
    assert torch.equal(got["zcr"], want["zcr"])
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(got[k].cpu(), want[k].cpu()) <= 1e-9, k
    # the same bases without the pipeline's word for them: the dense kernel
    unvouched = fk.fused_features(frames, **dict(consts, n_fft=None))
    assert fk.ROUTES["frame_features_dense"] == \
        before["frame_features_dense"] + 1 + (route == "dense")
    assert torch.equal(unvouched["zcr"], want["zcr"])
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(unvouched[k].cpu(), want[k].cpu()) <= 1e-9, k


@pytest.mark.cuda
def test_dense_route_reads_the_bases_load_constants_brings():
    """Bases loaded through load_constants (another window folded in) are
    packed again on the card, and the dense route computes THEIR spectrum:
    equal to the plain version on the loaded bases, not to the old ones;
    the pipeline's own bases back restore the FFT route."""
    dev = _device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    pipe = FeaturePipeline(FeatureConfig(frame_size=400, hop_size=160),
                           device=dev)
    own = pipe.constants()
    other = FeaturePipeline(FeatureConfig(frame_size=400, hop_size=160,
                                          window_type="hanning"),
                            device="cpu").constants()
    frames = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1000, (300, 400)).astype(np.float32)).to(dev)
    before = fk.fused_features(frames, **pipe._frame_consts)
    pipe.load_constants({"wc": other["wc"], "ws": other["ws"]})
    consts = pipe._frame_consts
    assert consts["n_fft"] is None
    assert consts["dense_bases"].device == consts["wc"].device
    assert torch.equal(consts["dense_bases"].cpu(), fk.pack_dense_bases(
        torch.from_numpy(other["wc"]), torch.from_numpy(other["ws"])))
    routes = dict(fk.ROUTES)
    got = fk.fused_features(frames, **consts)
    torch.cuda.synchronize()
    assert fk.ROUTES["frame_features_dense"] == \
        routes["frame_features_dense"] + 1
    want = fk.frame_features_plain(frames, **consts)
    assert torch.equal(got["zcr"], want["zcr"])
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(got[k].cpu(), want[k].cpu()) <= 1e-9, k
    assert _nmse(got["mfcc"].cpu(), before["mfcc"].cpu()) > 1e-6
    pipe.load_constants(own)
    assert pipe._frame_consts["dense_bases"] is None
    assert fk.kernel_route(400, 257, pipe._frame_consts["n_fft"]) == "fft"


@pytest.mark.cuda
def test_pitch_kernel_refuses_a_transform_past_the_largest():
    """frame + n_lags - 1 > 2048 has no FFT size: K2 raises (no dense
    second route, no quiet plain run)."""
    dev = _device("cuda")
    pipe = FeaturePipeline(FeatureConfig(frame_size=2048, hop_size=1024,
                                         n_fft=2048, entropy_n_fft=2048),
                           device=dev)
    merged, nyq_b, inv_live, inv_nyq = pipe._acf_bases(320)
    rows = torch.zeros((4, 1024), device=dev)
    with pytest.raises(NotImplementedError):
        vk.fused_view_pitch(rows, merged=merged, nyq_b=nyq_b,
                            inv_live=inv_live, inv_nyq=inv_nyq, lag_min=40,
                            lag_max=320, sample_rate=16000)


@pytest.mark.cuda
def test_frame_kernel_zero_frames_are_finite():
    """Bucket padding: all-zero frames give energy 0, zcr 0 and finite
    entropy and mfcc, equal to the plain version's."""
    dev = _device("cuda")
    consts = _frame_consts(dev, 320)
    zeros = torch.zeros((40, 320), device=dev)
    got = fk.fused_features(zeros, **consts)
    want = fk.frame_features_plain(zeros, **consts)
    assert not got["energy"].any() and not got["zcr"].any()
    for k in got:
        assert bool(torch.isfinite(got[k]).all()), k
        assert _nmse(got[k].cpu(), want[k].cpu()) <= 1e-9, k


@pytest.mark.cuda
def test_kernels_reject_what_they_cannot_take():
    dev = _device("cuda")
    pipe = FeaturePipeline(device=dev)
    consts = pipe._view_consts
    # hop % 4 != 0 runs (one-float loads); the 320-sample window does not fit
    with pytest.raises(ValueError):
        vk.fused_view_features(torch.zeros((5, 162), device=dev), **consts)
    rows = torch.zeros((5, 160), device=dev)
    with pytest.raises(NotImplementedError):  # bases nobody vouched for
        vk.fused_view_features(rows, **dict(consts, n_fft=None))
    for gap in (dict(n_fft=640, entropy_n_fft=640),  # no FFT of that size
                dict(n_fft=256, entropy_n_fft=256)):  # shorter than the frame
        gap_consts = FeaturePipeline(FeatureConfig(**gap), device=dev)._view_consts
        with pytest.raises(NotImplementedError):
            vk.fused_view_features(rows, **gap_consts)
    cpu_consts = FeaturePipeline(device="cpu")._view_consts
    with pytest.raises(ValueError):  # constants on another device
        vk.fused_view_features(rows, **cpu_consts)


# (frame_size, hop, n_fft): one-float loads (hop % 4 != 0) at two hops, a
# frame that fills its transform, and the 1024- and 2048-point transforms.
K1_GEOMETRIES = {"322_161": (322, 161, 512), "324_162": (324, 162, 512),
                 "256_128_of_256": (256, 128, 256),
                 "640_320_of_1024": (640, 320, 1024),
                 "2048_1024_of_2048": (2048, 1024, 2048)}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, 1025])
@pytest.mark.parametrize("case", list(K1_GEOMETRIES))
def test_view_features_kernel_takes_any_hop(case, n):
    """K1 against its plain version off the default geometry, and through
    process_signal_device (one K1 launch, no K3)."""
    dev = _device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    frame, hop, n_fft = K1_GEOMETRIES[case]
    pipe = FeaturePipeline(FeatureConfig(frame_size=frame, hop_size=hop,
                                         n_fft=n_fft, entropy_n_fft=n_fft),
                           device=dev)
    assert pipe._view_kernel_ok
    rows = torch.from_numpy(
        np.random.default_rng(n).normal(0, 1000, (n + 1, hop)).astype(np.float32)
    ).to(dev)
    before = dict(vk.LAUNCHES)
    got = vk.fused_view_features(rows, **pipe._view_consts)
    want = vk.view_features_plain(rows, **pipe._view_consts)
    torch.cuda.synchronize()
    assert vk.LAUNCHES["view_features"] == before["view_features"] + 1
    assert torch.equal(got["zcr"], want["zcr"])
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(got[k].cpu(), want[k].cpu()) <= 1e-9, k
    block, _ = pipe.process_signal_device(rows)
    assert vk.LAUNCHES["view_features"] == before["view_features"] + 2
    assert vk.LAUNCHES["frame_features"] == before["frame_features"]
    for k in got:
        assert torch.equal(getattr(block, k), got[k]), k


@pytest.mark.cuda
def test_view_features_kernel_zero_rows_are_finite():
    """Bucket padding: all-zero rows give energy 0, zcr 0 and finite entropy
    and mfcc, equal to the plain version's."""
    dev = _device("cuda")
    consts = FeaturePipeline(device=dev)._view_consts
    zeros = torch.zeros((41, 160), device=dev)
    got = vk.fused_view_features(zeros, **consts)
    want = vk.view_features_plain(zeros, **consts)
    assert not got["energy"].any() and not got["zcr"].any()
    for k in got:
        assert bool(torch.isfinite(got[k]).all()), k
        assert _nmse(got[k].cpu(), want[k].cpu()) <= 1e-9, k


@pytest.mark.cuda
@pytest.mark.parametrize("hop", [160, 161])
def test_view_features_kernel_ignores_the_pointer(hop):
    """A rows view that starts at a misaligned address (a signal cut at an
    odd sample) gives the bits of the same rows at an aligned one, and a
    view cut at a row boundary the bits of the whole."""
    dev = _device("cuda")
    consts = FeaturePipeline(FeatureConfig(frame_size=2 * hop, hop_size=hop),
                             device=dev)._view_consts
    n = 300
    flat = torch.from_numpy(np.random.default_rng(hop).normal(
        0, 1000, (n + 1) * hop + 1).astype(np.float32)).to(dev)
    shifted = flat[1:].view(n + 1, hop)
    assert shifted.data_ptr() % 16
    aligned = shifted.clone()
    assert aligned.data_ptr() % 16 == 0
    got = vk.fused_view_features(shifted, **consts)
    want = vk.fused_view_features(aligned, **consts)
    tail = vk.fused_view_features(aligned[100:], **consts)
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(tail[k], want[k][100:]), k


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


class _MemorySource:
    """In-memory int16 source with the AudioSource contract."""

    def __init__(self, signal):
        self.sample_rate, self.channels = 16000, 1
        self._data, self._pos, self.exhausted = signal, 0, False

    def open(self):
        self._pos, self.exhausted = 0, False

    def read(self, num_frames):
        chunk = self._data[self._pos : self._pos + num_frames]
        self._pos += len(chunk)
        self.exhausted = self._pos >= len(self._data)
        return chunk

    def close(self):
        pass


@pytest.mark.cuda
@pytest.mark.parametrize("samples_dispatch,kernel",
                         [(1, "view_features"), (0, "frame_features")])
def test_engine_on_cuda_matches_cpu(monkeypatch, samples_dispatch, kernel):
    """One engine run per dispatch mode on the card: its kernel launches,
    and the frames equal a CPU run's (zcr and VAD exactly, the rest NMSE)."""
    import time

    from sspv_tpu_torch import AudioRuntime, Config

    dev = _device("cuda")
    monkeypatch.setattr(Config, "PROCESSED_DATA_BUFFER_SIZE", 10_000)
    monkeypatch.setattr(Config, "TPU_STREAM_SAMPLES_DISPATCH", samples_dispatch)
    rng = np.random.default_rng(5)
    t = np.arange(3 * 16000) / 16000
    sig = np.where(((t * 4).astype(int) % 2) == 1,
                   6000 * np.sin(2 * np.pi * 130 * t),
                   rng.normal(0, 300, t.size)).astype(np.int16)

    def run(device):
        rt = AudioRuntime(audio_source=_MemorySource(sig), device=device)
        rt.auto_stop_on_eof = True
        rt.start()
        t0 = time.monotonic()
        while rt.is_running and time.monotonic() - t0 < 120:
            time.sleep(0.005)
        rt.stop()
        assert rt.last_error is None and not rt.is_running
        rows = list(rt.processed_data)
        return {k: np.array([d[k] for d in rows]) for k in
                ("energy", "zcr", "spec_entropy", "mfcc", "vad")}

    before = vk.LAUNCHES[kernel]
    got = run(dev)
    assert vk.LAUNCHES[kernel] > before
    want = run("cpu")
    assert got["energy"].shape == (1 + (sig.size - 320) // 160,)
    np.testing.assert_array_equal(got["zcr"], want["zcr"])
    np.testing.assert_array_equal(got["vad"], want["vad"])
    for k in ("energy", "spec_entropy", "mfcc"):
        assert _nmse(got[k], want[k]) <= 1e-9, k


def _launch_counts():
    return dict(_build.LAUNCHES), dict(_build.ROUTES)


def _launch_delta(before):
    return ({k: v - before[0][k] for k, v in _build.LAUNCHES.items()},
            {k: v - before[1][k] for k, v in _build.ROUTES.items()})


@pytest.mark.cuda
def test_engine_graph_replays_equal_the_eager_dispatch():
    """An engine's samples dispatch on the card over graphed sizes (6, 7,
    1, 32, repeated), an eager block of 40 frames and a source reset
    publishes blocks, and leaves a state, bit-identical to a chain of eager
    ``process_signal_packed`` calls on the same blocks; each size after its
    first replays a graph, and the replays count the launches and routes
    the eager chain counts."""
    from sspv_tpu_torch import AudioRuntime

    dev = _device("cuda")
    pipe = FeaturePipeline(device=dev)
    sig = engine_blocks.signal(seed=1)
    before = _launch_counts()
    want, want_state = engine_blocks.eager_chain(pipe, sig)
    torch.cuda.synchronize()
    eager = _launch_delta(before)
    rt = AudioRuntime(audio_source=_MemorySource(sig), pipeline=pipe,
                      device=dev)
    before = _launch_counts()
    got, got_state = engine_blocks.engine_run(rt, sig)
    assert _launch_delta(before) == eager
    assert eager[0]["view_features"] == eager[0]["vad"] == len(got)
    assert rt.graph_replays == engine_blocks.expected_replays() > 0
    assert rt.dispatch_count == len(engine_blocks.SIZES)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"block {k}")
    np.testing.assert_array_equal(got_state, want_state)


@pytest.mark.cuda
def test_engines_capture_concurrently():
    """Three engines over one pipeline, each in its own thread, capture
    their graphs while the others dispatch: every engine's blocks and state
    equal its eager chain bit for bit, and the launches of the three runs
    are three times one chain's."""
    import threading

    from sspv_tpu_torch import AudioRuntime

    dev = _device("cuda")
    pipe = FeaturePipeline(device=dev)
    sigs = [engine_blocks.signal(seed=s) for s in (2, 3, 4)]
    before = _launch_counts()
    want = [engine_blocks.eager_chain(pipe, sig) for sig in sigs]
    torch.cuda.synchronize()
    eager = _launch_delta(before)
    engines = [AudioRuntime(audio_source=_MemorySource(sig), pipeline=pipe,
                            device=dev) for sig in sigs]
    got, errors = [None] * 3, []
    start = threading.Barrier(3)

    def run(i):
        try:
            start.wait()
            got[i] = engine_blocks.engine_run(engines[i], sigs[i])
        except Exception as e:  # reported below, in the test's thread
            errors.append(e)

    before = _launch_counts()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    assert _launch_delta(before) == eager
    for rt, (g, g_state), (w, w_state) in zip(engines, got, want):
        assert rt.graph_replays == engine_blocks.expected_replays()
        for k, (a, b) in enumerate(zip(g, w)):
            np.testing.assert_array_equal(a, b, err_msg=f"block {k}")
        np.testing.assert_array_equal(g_state, w_state)


@pytest.mark.cuda
def test_engines_hold_streams_of_their_own():
    """More live engines than PyTorch's pool has streams (32 a priority):
    no two hold one stream (one's eager work would join the other's
    capture); those left without one run eagerly on the current stream,
    with no graphs, and still equal the eager chain bit for bit."""
    import gc

    from sspv_tpu_torch import AudioRuntime

    dev = _device("cuda")
    pipe = FeaturePipeline(device=dev)
    sig = engine_blocks.signal(seed=5)
    want, want_state = engine_blocks.eager_chain(pipe, sig)
    engines = [AudioRuntime(audio_source=_MemorySource(sig), pipeline=pipe,
                            device=dev) for _ in range(40)]
    spare = []
    try:
        held = [rt._stream.cuda_stream for rt in engines
                if rt._stream is not None]
        assert len(held) == len(set(held))
        spare = [rt for rt in engines if rt._stream is None]
        assert spare and all(rt._graphs is None for rt in spare)
        got, got_state = engine_blocks.engine_run(spare[0], sig)
        assert spare[0].graph_replays == 0
        for k, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w, err_msg=f"block {k}")
        np.testing.assert_array_equal(got_state, want_state)
    finally:
        engines.clear()
        spare.clear()
        gc.collect()  # the engines give their streams back


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4])
def test_mesh_programs_on_cuda(d):
    """The mesh programs on the card, the card named d times: the shard
    route launches K1/K2 once per shard and is bit-identical to the
    single-device calls; a masked batch launches K3 once and equals a CPU
    run (zcr and VAD exactly, the rest NMSE)."""
    from sspv_tpu_torch.ops.pitch import pitch_track_signal_gated
    from sspv_tpu_torch.parallel import BatchPipeline, Mesh

    dev = _device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(d)
    sig = rng.normal(0, 3000, 160 * 1202 + 320).astype(np.float32)
    bp = BatchPipeline(Mesh([dev] * d))
    before = dict(vk.LAUNCHES)
    block, state, f0, conf = bp.process_long_pitch(sig)
    torch.cuda.synchronize()
    for k in ("view_features", "view_pitch"):
        assert vk.LAUNCHES[k] == before[k] + d, k
    one, _ = bp.pipe.process_signal_device(sig)
    for a, b in zip(block, one):
        assert torch.equal(a, b)
    f0_1, conf_1 = pitch_track_signal_gated(
        torch.from_numpy(sig).to(dev), one.vad, 0.3,
        **bp.pipe._pitch_kwargs(50.0, 400.0))
    assert torch.equal(f0, f0_1) and torch.equal(conf, conf_1)
    lengths = [16000, 8000, 319, 0]
    sigs = np.zeros((4, 16000), np.int16)
    for i, n in enumerate(lengths):
        sigs[i, :n] = rng.normal(0, 3000, n)
    before = vk.LAUNCHES["frame_features"]
    got = bp.process_batch_masked(sigs, lengths)
    assert vk.LAUNCHES["frame_features"] == before + 1
    want = BatchPipeline(Mesh([torch.device("cpu")])).process_batch_masked(
        sigs, lengths)
    gb, wb = got[0], want[0]
    assert torch.equal(gb.zcr.cpu(), wb.zcr) and torch.equal(gb.vad.cpu(), wb.vad)
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(getattr(gb, k).cpu(), getattr(wb, k)) <= 1e-9, k
    assert torch.equal(got[1].count.cpu(), want[1].count)


# -- K5, the rows resampler of the batch programs --------------------------
#
# K5 against its plain version (float64 sums both: they differ only in the
# order of each output's sum, so an int16 output may differ by one LSB where
# the sum lies within rounding of a truncation boundary): equal on at least
# 1 - 1e-6 of the outputs, none further than one LSB, zero past each row's
# own output length.

K5_RATIOS = {"48k_to_16k": (48000, 16000), "44k1_to_16k": (44100, 16000),
             "8k_to_16k": (8000, 16000)}


def _k5_rows(src: int, seed: int):
    """Eight int16 rows of 2 s at ``src``: speech-like tones and noise, with
    unequal lengths (whole, odd, not a multiple of down, shorter than the
    filter, empty)."""
    rng = np.random.default_rng(seed)
    n = 2 * src
    t = np.arange(n) / src
    x = rng.normal(0, 40, (8, n)) + 6000 * np.sin(
        2 * np.pi * rng.uniform(80, 300, (8, 1)) * t * np.arange(1, 9)[:, None]
        ) / np.arange(1, 9)[:, None]
    x = np.clip(x, -32768, 32767).astype(np.int16)
    lengths = np.array([n, n - 1, n - 7, n // 3 + 1, 1001, 37, 1, 0])
    x[np.arange(n)[None, :] >= lengths[:, None]] = 0
    return x, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("ratio", list(K5_RATIOS))
def test_resample_kernel_matches_plain_version(ratio):
    from sspv_tpu_torch.ops import resample as tres

    dev = _device("cuda")
    src, dst = K5_RATIOS[ratio]
    up, down = tres._reduce_ratio(dst, src)
    for seed in range(3):
        x, lengths = _k5_rows(src, seed)
        before = _build.LAUNCHES["resample"]
        got = tres.resample_rows_int16(torch.from_numpy(x).to(dev), lengths,
                                       up, down)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["resample"] == before + 1
        want = tres.plain_resample_rows_int16(torch.from_numpy(x), lengths,
                                              up, down)
        diff = (got.cpu().to(torch.int32) - want.to(torch.int32)).abs()
        assert got.shape == want.shape
        assert int(diff.max()) <= 1
        assert int((diff > 0).sum()) <= 1e-6 * diff.numel()
        own = -(-lengths * up // down)
        past = torch.arange(got.shape[1])[None, :] >= torch.from_numpy(own)[:, None]
        assert not got.cpu()[past].any()


@pytest.mark.cuda
def test_resample_kernel_refuses_what_it_cannot_take():
    from sspv_tpu_torch.ops import resample as tres

    dev = _device("cuda")
    x = torch.zeros((2, 300), dtype=torch.int16, device=dev)
    with pytest.raises(ValueError):
        tres.resample_rows_int16(x.float(), [300, 300], 1, 3)
    with pytest.raises(ValueError):
        tres.resample_rows_int16(x, [300, 301], 1, 3)
    with pytest.raises(ValueError):
        tres.resample_rows_int16(x, torch.zeros(3, dtype=torch.int32,
                                                device=dev), 1, 3)
    with pytest.raises(ValueError):
        tres.resample_rows_int16(x, [300, 300], 3, 3)


@pytest.mark.cuda
def test_batch_program_resamples_on_the_card():
    """``process_batch_masked(_pitch)`` and ``_exact_batch`` at 48 kHz on the
    card: one K5 launch a call, and bit for bit the same call on the rows K5
    gives at 16 kHz; at 16 kHz (or no source rate) no K5 launch."""
    from sspv_tpu_torch.ops import resample as tres
    from sspv_tpu_torch.parallel import BatchPipeline, make_mesh

    dev = _device("cuda")
    cfg = FeatureConfig(frame_size=400, hop_size=160, n_fft=400,
                        entropy_n_fft=400, num_filters=80, window_type="hann")
    bp = BatchPipeline(make_mesh(1), cfg)
    x, lengths = _k5_rows(48000, 7)
    rows = tres.resample_rows_int16(torch.from_numpy(x).to(dev), lengths, 1, 3)
    out_lengths = -(-lengths // 3)
    calls = {
        "masked": (lambda s, n, **kw: bp.process_batch_masked(s, n, **kw)),
        "pitch": (lambda s, n, **kw: bp.process_batch_masked_pitch(s, n, **kw)),
        "exact": (lambda s, n, **kw: bp._exact_batch(s, n, 512, (50.0, 400.0),
                                                     **kw)),
    }
    for name, call in calls.items():
        before = _build.LAUNCHES["resample"]
        got = call(x, lengths, source_rate=48000)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["resample"] == before + 1, name
        want = call(rows, out_lengths)
        want_none = call(rows, out_lengths, source_rate=16000)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["resample"] == before + 1, name
        for g, w, w2 in zip(got, want, want_none):
            for a, b, c in zip(*(t if isinstance(t, tuple) else (t,)
                                 for t in (g, w, w2))):
                assert torch.equal(a, b) and torch.equal(a, c), name


# -- the L1 ops, the facade, the frontend modules and the resampler ---------
#
# Each on the card against itself on the CPU. Gates: framing, pre-emphasis,
# ZCR (a true division on both) and the fixed VAD EQUAL; float sums NMSE
# <= 1e-9; discrete pitch picks equal on >= 99.9 % of frames; the int16
# resampler >= 99.9 % of samples equal to the host SciPy path and none
# further than one LSB.

def _speech(seconds, seed=0, sr=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    tone = (6000 * np.sin(2 * np.pi * 130 * t) + 2000 * np.sin(2 * np.pi * 260 * t)
            + 900 * np.sin(2 * np.pi * 390 * t))
    gate = ((t * 4).astype(int) % 2) == 1
    return (np.where(gate, tone, 0.0) + rng.normal(0, 200, t.size)).astype(np.float32)


def _l1_outputs(dev, frame, hop):
    """Every L1 op on one signal, on ``dev``, as host arrays."""
    from sspv_tpu_torch import ops

    sig = torch.from_numpy(_speech(4.0, seed=frame)).to(dev)
    frames = ops.framing(sig, frame, hop, "hamming")
    raw = ops.frame_signal(sig, frame, hop)
    energy = ops.calculate_short_time_energy(frames)
    zcr = ops.calculate_zero_crossing_rate(raw)
    out = {
        "framing": frames, "preemphasis": ops.preemphasis(sig, 0.97),
        "energy": energy, "zcr": zcr,
        "acf": ops.calculate_short_time_autocorrelation(raw, 200),
        "amdf": ops.calculate_average_magnitude_difference(raw, 200, 40),
        "power": ops.power_spectrum(frames, 512),
        "mfcc": ops.compute_mfcc(frames, 16000),
        "entropy": ops.calculate_spectral_entropy(frames),
        "vad": ops.voice_activity_detection(energy, zcr, 1e6, 0.1),
        "vad_adaptive": ops.adaptive_voice_activity_detection(
            energy, zcr, [2e5] * 40, [0.2] * 40),
    }
    for name, fn in (("direct", lambda: ops.pitch_from_frames(raw)),
                     ("dft", lambda: ops.pitch_from_frames(raw, acf_impl="dft")),
                     ("amdf_pitch", lambda: ops.pitch_from_frames_amdf(raw))):
        out["f0_" + name], out["conf_" + name] = fn()
    smooth, _ = ops.hangover_smooth_scan(out["vad"], 0, 0, 3, 2)
    assert smooth.device == out["vad"].device
    out["smooth"] = smooth
    return {k: v.cpu().numpy() for k, v in out.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("frame,hop", [(320, 160), (400, 160), (322, 161)])
def test_l1_ops_on_cuda_match_cpu(frame, hop):
    got = _l1_outputs(_device("cuda"), frame, hop)
    want = _l1_outputs(torch.device("cpu"), frame, hop)
    for k in ("framing", "preemphasis", "zcr", "vad", "smooth"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("energy", "acf", "amdf", "power", "mfcc", "entropy",
              "conf_direct", "conf_dft", "conf_amdf_pitch"):
        assert _nmse(got[k], want[k]) <= 1e-9, k
    for k in ("f0_direct", "f0_dft", "f0_amdf_pitch", "vad_adaptive"):
        assert np.mean(got[k] == want[k]) >= 0.999, k


@pytest.mark.cuda
def test_facade_on_cuda_matches_cpu():
    """SignalProcessing.device left at its default runs on the card."""
    from sspv_tpu_torch import SignalProcessing
    from sspv_tpu_torch.signal_processing import on_device

    _device("cuda")
    assert SignalProcessing.device == "cuda"
    sig = _speech(3.0, seed=1)

    def run():
        frames = SignalProcessing.framing(sig, 400, 160)
        return {
            "frames": frames,
            "energy": SignalProcessing.calculate_short_time_energy(frames),
            "zcr": SignalProcessing.calculate_zero_crossing_rate(frames),
            "mfcc": SignalProcessing.compute_mfcc(frames, 16000, lifter=22),
            "entropy": SignalProcessing.calculate_spectral_entropy(frames),
            "acf": SignalProcessing.calculate_short_time_autocorrelation(
                frames, 50),
        }

    got = run()
    with on_device("cpu"):
        want = run()
    assert all(isinstance(v, np.ndarray) for v in got.values())
    np.testing.assert_array_equal(got["frames"], want["frames"])
    np.testing.assert_array_equal(got["zcr"], want["zcr"])
    for k in ("energy", "mfcc", "entropy", "acf"):
        assert _nmse(got[k], want[k]) <= 1e-9, k


@pytest.mark.cuda
@pytest.mark.parametrize("frame,hop", [(320, 160), (400, 160)])
def test_frontend_modules_on_cuda_match_cpu(frame, hop):
    from sspv_tpu_torch import models

    dev = _device("cuda")
    sig = _speech(3.0, seed=2)
    kw = dict(frame_size=frame, hop_size=hop)
    got = models.SpeechFrontend(**kw).from_signal(sig)   # default: the card
    want = models.SpeechFrontend(device="cpu", **kw).from_signal(sig)
    assert got["mfcc"].device.type == dev.type
    assert torch.equal(got["zcr"].cpu(), want["zcr"])
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(got[k].cpu(), want[k]) <= 1e-9, k
    for method in ("acf", "amdf"):
        f0, conf = models.Pitch(method=method, **kw).from_signal(sig)
        cf0, cconf = models.Pitch(method=method, device="cpu", **kw).from_signal(sig)
        assert (f0.cpu() == cf0).float().mean().item() >= 0.999
        assert _nmse(conf.cpu(), cconf) <= 1e-9
    vad = models.VADModel(energy_threshold=1e6, zcr_threshold=0.1, **kw)
    cvad = models.VADModel(energy_threshold=1e6, zcr_threshold=0.1,
                           device="cpu", **kw)
    assert (vad.from_signal(sig).cpu() == cvad.from_signal(sig)).float().mean() \
        >= 0.999


def _int16_gate(got, want):
    assert got.dtype == np.int16 and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (
        diff.max(), (diff > 0).mean())


@pytest.mark.cuda
@pytest.mark.parametrize("src", [8000, 22050, 44100, 48000])
def test_resampler_on_cuda_matches_host(src):
    from sspv_tpu_torch.ops import resample
    from sspv_tpu_torch.runtime.audio_source import _resample_to

    _device("cuda")
    pcm = _speech(20.0, seed=src, sr=src).astype(np.int16)
    before = resample.CALLS["resample"]
    got = resample.resample_to_rate_device(pcm, src, 16000)
    assert resample.CALLS["resample"] == before + 1
    _int16_gate(got, _resample_to(pcm, src, 16000))
    back = resample.resample_to_rate_device(got, 16000, src)
    _int16_gate(back, _resample_to(got, 16000, src))


@pytest.mark.cuda
def test_tf32_switched_on_changes_nothing():
    """With the process-wide matmul precision at "medium" and cuDNN's TF32
    switch on, the L1 ops, the frontend modules and the resampler still
    meet their float32 gates, and the settings are as the caller left them
    afterwards ("medium", not merely some TF32 setting)."""
    from sspv_tpu_torch import models, ops
    from sspv_tpu_torch.ops import resample
    from sspv_tpu_torch.runtime.audio_source import _resample_to

    dev = _device("cuda")
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("medium")
    torch.backends.cudnn.allow_tf32 = True
    try:
        sig = _speech(3.0, seed=3)
        frames = ops.framing(torch.from_numpy(sig).to(dev), 400, 160)
        want = ops.compute_mfcc(frames.cpu(), 16000)
        assert _nmse(ops.compute_mfcc(frames, 16000).cpu(), want) <= 1e-9
        raw = ops.frame_signal(torch.from_numpy(sig).to(dev), 320, 160)
        _, conf = ops.pitch_from_frames(raw, acf_impl="dft")
        _, cconf = ops.pitch_from_frames(raw.cpu(), acf_impl="dft")
        assert _nmse(conf.cpu(), cconf) <= 1e-9
        fe = models.SpeechFrontend(frame_size=400, hop_size=160)
        cfe = models.SpeechFrontend(frame_size=400, hop_size=160, device="cpu")
        got, ref = fe.from_signal(sig), cfe.from_signal(sig)
        for k in ("energy", "entropy", "mfcc"):
            assert _nmse(got[k].cpu(), ref[k]) <= 1e-9, k
        pcm = _speech(10.0, seed=4, sr=44100).astype(np.int16)
        host = _resample_to(pcm, 44100, 16000)
        _int16_gate(resample.resample_to_rate_device(pcm, 44100, 16000), host)
        assert torch.get_float32_matmul_precision() == "medium"
        assert torch.backends.cudnn.allow_tf32
        # and set through the boolean switch, flipped between calls
        torch.set_float32_matmul_precision("highest")
        for flag in (True, False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            _, conf = ops.pitch_from_frames(raw, acf_impl="dft")
            assert _nmse(conf.cpu(), cconf) <= 1e-9
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


@pytest.mark.cuda
def test_device_resample_routes_to_the_card_without_a_fallback(monkeypatch):
    from sspv_tpu_torch import Config
    from sspv_tpu_torch.ops import resample
    from sspv_tpu_torch.runtime import audio_source

    _device("cuda")
    pcm = _speech(5.0, seed=5, sr=48000).astype(np.int16)
    host = audio_source._resample_to(pcm, 48000, 16000)
    monkeypatch.setattr(Config, "TPU_DEVICE_RESAMPLE", True)
    before = resample.CALLS["resample"]
    _int16_gate(audio_source._resample_to(pcm, 48000, 16000), host)
    assert resample.CALLS["resample"] == before + 1
    audio_source._resample_to(pcm[:4000], 48000, 16000)  # short: the host
    assert resample.CALLS["resample"] == before + 1

    def broken(*args, **kwargs):
        raise RuntimeError("no device today")

    monkeypatch.setattr(resample, "_correlate", broken)
    with pytest.raises(RuntimeError, match="no device today"):
        audio_source._resample_to(pcm, 48000, 16000)


@pytest.mark.cuda
def test_entry_points_and_trace_on_the_card(tmp_path, capsys):
    from sspv_tpu_torch import demo, test_system
    from sspv_tpu_torch.utils import device_trace

    dev = _device("cuda")
    assert test_system.main([]) == 0
    assert demo.main([]) == 0
    out = capsys.readouterr().out
    assert "ALL PASS" in out and "demo complete" in out and "on cuda" in out
    with device_trace(str(tmp_path)) as prof:
        x = torch.ones((512, 512), device=dev)
        (x @ x).sum().item()
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0


# -- K4: the streaming VAD on the card ----------------------------------------
#
# K4 against the plain version on the same card and inputs: decisions,
# adaptive decisions and every field of the new state EQUAL.


def _vad_same(got, want):
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype == torch.int32 and torch.equal(g, w)
    for name, g, w in zip(tvad.VadState._fields, got[2], want[2]):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


def _vad_both(dev, e, z, h, state, valid=None, **kw):
    """K4 (through its wrapper: one launch, its route counted) and the
    plain version; K4's outputs."""
    before, routes = dict(vk.LAUNCHES), dict(_build.ROUTES)
    got = vad_kernels.fused_streaming_vad(e, z, h, state, valid=valid, **kw)
    if e.shape[-1]:
        assert vk.LAUNCHES["vad"] == before["vad"] + 1
        blocked = kw.get("trailing_impl") == "blocked" and \
            e.shape[-1] % kw.get("history_len", 256) == 0
        route = "vad_blocked" if blocked else "vad_direct"
        assert _build.ROUTES[route] == routes[route] + 1
    want = tvad.streaming_vad(e, z, h, state, valid=valid, **kw)
    torch.cuda.synchronize(dev)
    _vad_same(got, want)
    return got


VAD_CARD_CASES = [
    (b, f, impl, mask)
    for b, f in [(1, 1), (3, 255), (8, 256), (3, 257), (8, 4096),
                 (2, 400_128), (1, 399_999)]
    for impl in ("conv", "blocked")
    for mask in ("none", "prefix", "holes")
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,impl,mask", VAD_CARD_CASES,
                         ids=["-".join(map(str, c)) for c in VAD_CARD_CASES])
def test_vad_kernel_matches_plain_on_cuda(b, f, impl, mask):
    """Rows with their own states and masks, then a second call on the new
    states."""
    dev = _device("cuda")
    e, z, h, state = vad_inputs.vad_rows(b, f, seed=b + f, device=dev)
    valid = vad_inputs.row_mask(mask, b, f, seed=f, device=dev)
    kw = dict(vad_inputs.GATES, trailing_impl=impl)
    _, _, state2 = _vad_both(dev, e, z, h, state, valid, **kw)
    _vad_both(dev, e.flip(-1), z, h, state2, valid, **kw)
    # one row alone is the 1-D call
    _vad_both(dev, e[0], z[0], h[0], tvad.unstack_states(state2)[0],
              None if valid is None else valid[0], **kw)


VAD_LENGTH_CARD_CASES = [
    (b, f, kind, route)
    for b, f in [(1, 255), (3, 1000), (8, 4097), (1, 359_999)]
    for kind in ("int", "rows")
    for route in ("blocked", "direct")
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,kind,route", VAD_LENGTH_CARD_CASES,
                         ids=["-".join(map(str, c))
                              for c in VAD_LENGTH_CARD_CASES])
def test_vad_kernel_lengths_on_cuda(b, f, kind, route):
    """K4's lengths path: ragged rows (one length for all, or an int32 per
    row on the card), the blocked order asked for at a frame count that is
    no multiple of the history and the direct order, twice (the state
    carried): EQUAL to the plain version, on the route asked for."""
    from sspv_tpu_torch.ops.vad_kernels import plain_streaming_vad

    dev = _device("cuda")
    e, z, h, state = vad_inputs.vad_rows(b, f, seed=b * 3 + f, device=dev)
    rng = np.random.default_rng(f)
    lengths = f - 3 if kind == "int" else torch.tensor(
        ([0, f, f // 2] + list(rng.integers(1, f, b)))[:b],
        dtype=torch.int32, device=dev)
    rf = -(-f // 256) * 256 + (0 if route == "blocked" else 1)
    kw = dict(vad_inputs.GATES, trailing_impl="blocked", lengths=lengths,
              route_frames=rf)
    for _ in range(2):
        before = _build.ROUTES["vad_" + route]
        got = vad_kernels.fused_streaming_vad(e, z, h, state, **kw)
        assert _build.ROUTES["vad_" + route] == before + 1
        want = plain_streaming_vad(e, z, h, state, **kw)
        torch.cuda.synchronize(dev)
        _vad_same(got, want)
        state, e = got[2], e.flip(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["conv", "blocked"])
@pytest.mark.parametrize("tie", sorted(vad_inputs.TIES))
def test_vad_kernel_decides_ties_on_cuda(tie, impl):
    """The float32 threshold ties: K4 decides them as the plain version,
    whole and split in two calls that carry the state."""
    dev = _device("cuda")
    e, z, h = (torch.from_numpy(x).to(dev) for x in vad_inputs.TIES[tie]())
    kw = dict(vad_inputs.GATES, trailing_impl=impl)
    whole = _vad_both(dev, e, z, h, tvad.initial_vad_state(device=dev), **kw)
    _, _, s = _vad_both(dev, e[:4], z[:4], h[:4],
                        tvad.initial_vad_state(device=dev), **kw)
    tail = _vad_both(dev, e[4:], z[4:], h[4:], s, **kw)
    assert torch.equal(tail[0], whole[0][4:])


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["conv", "blocked"])
def test_vad_kernel_keeps_frame_46_on_cuda(impl):
    """``synth_signal``'s features on the card (a float32 trailing mean
    would flip frame 46): K4 exact length and padded to 256 under a mask,
    as the pipeline's two VAD calls run them."""
    from sspv_tpu_torch.utils.synth import synth_signal

    dev = _device("cuda")
    pipe = FeaturePipeline(FeatureConfig(vad_trailing_impl=impl), device=dev)
    block, _ = pipe.process_signal_device(synth_signal(2.0))
    e, z, h = block.energy, block.zcr, block.entropy
    n = e.shape[0]
    kw = pipe._vad_kwargs()
    got = _vad_both(dev, e, z, h, pipe.initial_state(), **kw)
    assert torch.equal(got[0], block.vad)
    pad = lambda x: torch.nn.functional.pad(x, (0, 256 - n))  # noqa: E731
    padded = _vad_both(dev, pad(e), pad(z), pad(h), pipe.initial_state(),
                       torch.arange(256, device=dev) < n, **kw)
    assert torch.equal(padded[0][:n], block.vad)


@pytest.mark.cuda
def test_vad_kernel_has_no_fallback(monkeypatch):
    """On a CUDA tensor a library that does not load, or a launch that
    fails, raises: no plain version takes over."""
    dev = _device("cuda")
    e, z, h, state = vad_inputs.vad_rows(2, 300, seed=3, device=dev)

    def no_library():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(_build, "library", no_library)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        vad_kernels.fused_streaming_vad(e, z, h, state, **vad_inputs.GATES)

    class Refusing:
        def sspv_streaming_vad(self, *args):
            return 1

        def sspv_error_string(self, err):
            return b"refused"

    monkeypatch.setattr(_build, "library", Refusing)
    before = vk.LAUNCHES["vad"]
    with pytest.raises(RuntimeError, match="vad kernel launch failed"):
        vad_kernels.fused_streaming_vad(e, z, h, state, **vad_inputs.GATES)
    assert vk.LAUNCHES["vad"] == before


@pytest.mark.cuda
def test_pipeline_and_batch_launch_the_vad_kernel():
    """The view path launches K4 once per call; a masked batch on a mesh
    with two "data" rows once per row of the mesh, not once per signal,
    and equals the CPU's batch program."""
    from sspv_tpu_torch.parallel import BatchPipeline, Mesh

    dev = _device("cuda")
    sig = np.random.default_rng(1).normal(0, 3000, 48000).astype(np.float32)
    pipe = FeaturePipeline(device=dev)
    before = vk.LAUNCHES["vad"]
    block, _ = pipe.process_signal_device(sig)
    assert vk.LAUNCHES["vad"] == before + 1
    want, _ = FeaturePipeline(device="cpu").process_signal_device(sig)
    assert torch.equal(block.vad.cpu(), want.vad)
    lengths = [16000, 8000, 319, 0, 12000, 16000]
    sigs = np.zeros((6, 16000), np.int16)
    rng = np.random.default_rng(2)
    for i, n in enumerate(lengths):
        sigs[i, :n] = rng.normal(0, 3000, n)
    before = vk.LAUNCHES["vad"]
    got = BatchPipeline(Mesh([[dev], [dev]])).process_batch_masked(
        sigs, lengths)
    assert vk.LAUNCHES["vad"] == before + 2
    want = BatchPipeline(Mesh([[torch.device("cpu")], [torch.device("cpu")]])
                         ).process_batch_masked(sigs, lengths)
    for k in ("vad", "vad_adaptive", "zcr"):
        assert torch.equal(getattr(got[0], k).cpu(), getattr(want[0], k)), k
    # the state's buffers are copies of the features: zcr exact, energy
    # to K3's tolerance against its plain version
    for name in ("zcr_buf", "count", "last_voiced"):
        assert torch.equal(getattr(got[1], name).cpu(),
                           getattr(want[1], name)), name
    assert _nmse(got[1].energy_buf.cpu(), want[1].energy_buf) <= 1e-9
