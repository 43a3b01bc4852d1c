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
from sspv_tpu_torch.ops import frame_kernels as fk
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
                      ("frame_features.cu", "pallas_kernels.py:43")):
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
                  entropy_n_fft: int = 512, n_fft: int = 512) -> dict:
    """K3's arguments, from a pipeline of that geometry (26 filters, 13
    cepstra)."""
    cfg = FeatureConfig(frame_size=frame, window_type=window, n_fft=n_fft,
                        entropy_n_fft=entropy_n_fft)
    return FeaturePipeline(cfg, device=dev)._frame_consts


# (frame_size, window, entropy_n_fft, n_fft): the engine's and the ASR front
# end's framing, a window with zeros, a separate entropy spectrum (all on
# K3's FFT route at N = 512), a frame longer than n_fft and than the dense
# kernel's shared-memory chunk with a scalar tail (1030 % 4 == 2; dense
# route), the FFT route at N = 1024 (513 bins), and the dense route with
# tail bins only (17 bins).
K3_CASES = {
    "hamming_320": (320, "hamming", 512, 512),
    "hamming_400": (400, "hamming", 512, 512),
    "hann_400": (400, "hanning", 512, 512),
    "entropy_1024": (400, "hamming", 1024, 512),
    "hamming_1030": (1030, "hamming", 512, 512),
    "n_fft_1024": (400, "hamming", 1024, 1024),
    "n_fft_32": (64, "hamming", 32, 32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 8, 255, 257])
@pytest.mark.parametrize("case", list(K3_CASES))
def test_frame_kernel_matches_plain_version(case, n):
    dev = _device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    frame, window, ent, n_fft = K3_CASES[case]
    consts = _frame_consts(dev, frame, window, ent, n_fft)
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
