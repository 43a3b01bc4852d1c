#!/usr/bin/env python3
"""The CUDA kernel sources, compiled for the CPU and run against the plain
versions.

There is no ``nvcc`` and no card here, but ``sspv_tpu_torch/csrc`` is plain
C++ apart from its launches: this file compiles it with the host compiler
against ``tests/cuda_cpu_stub/cuda_runtime.h`` (every thread of a block a
host thread; ``__syncwarp`` and the shuffles as barriers; ``k<<<...>>>(...)``
rewritten to a function call), loads the library with the port's own
``ctypes`` declarations and calls the same C entry points the wrappers call.
It runs the device code as written, index math, swizzle, tables and all,
so a fault in a kernel shows here before a run on the card. It says nothing
about what ``nvcc`` accepts or how fast anything is. Skips without ``g++``.

Tolerances are the kernels' gates on the card: zcr EXACTLY equal (K1's of
the raw samples, K3's of the windowed ones),
energy/entropy/mfcc and pitch confidence NMSE <= 1e-9, F0 equal on >= 99.9 %
of frames (all of them on these inputs).
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from sspv_tpu_torch.ops import _build, fft_tables
from sspv_tpu_torch.ops import frame_kernels as fk
from sspv_tpu_torch.ops import view_kernels as vk
from sspv_tpu_torch.ops.pipeline import FeatureConfig, FeaturePipeline

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "sspv_tpu_torch" / "csrc"
STUB = REPO / "tests" / "cuda_cpu_stub"
LAUNCH = re.compile(r"(\w+)<<<([^>]+)>>>\(")
CPU = torch.device("cpu")


def _nmse(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel sources for the CPU")
    work = tmp_path_factory.mktemp("kernels_on_cpu")
    units = []
    for path in sorted(CSRC.iterdir()):
        text = path.read_text().replace("extern __shared__ float4 smem4[];", "")
        text = LAUNCH.sub(r"emu_launch(\1, \2, ", text)
        out = work / (path.stem + ".cpp" if path.suffix == ".cu" else path.name)
        out.write_text(text)
        if path.suffix == ".cu":
            units.append(str(out))
    (work / "main.cpp").write_text('#define EMU_MAIN\n#include "cuda_runtime.h"\n')
    so = work / "libsspv_kernels_cpu.so"
    res = subprocess.run(
        ["g++", "-std=c++17", "-O1", "-w", "-fPIC", "-shared", "-pthread",
         f"-I{STUB}", f"-I{work}", "-o", str(so), str(work / "main.cpp"), *units],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return _build._declare(ctypes.CDLL(str(so)))


def _k3(lib, frames: torch.Tensor, consts: dict, route: str) -> dict:
    """``frame_kernels._launch`` against the CPU library."""
    f, frame = frames.shape
    fb_t, dct = consts["fb_t"], consts["dct"]
    (n_bins, nf), nc = fb_t.shape, dct.shape[1]
    out = {k: torch.full((f,), np.nan) for k in ("energy", "zcr", "entropy")}
    out["mfcc"] = torch.full((f, nc), np.nan)
    if route == "fft":
        n_fft = consts["n_fft"]
        spectrum = (fft_tables.device_twiddles(n_fft, CPU).data_ptr(), n_fft,
                    fb_t.data_ptr(), consts["mel_ranges"].data_ptr())
        kernel = lib.sspv_frame_features_fft
    else:
        spectrum = (consts["wc"].data_ptr(), consts["ws"].data_ptr(), n_bins,
                    fb_t.data_ptr())
        kernel = lib.sspv_frame_features
    err = kernel(frames.data_ptr(), f, frame, consts["window"].data_ptr(),
                 *spectrum, nf, dct.data_ptr(), consts["lifter"].data_ptr(), nc,
                 float(np.float32(np.log(n_bins))),
                 int(consts["entropy_bases"][0] is None),
                 out["energy"].data_ptr(), out["zcr"].data_ptr(),
                 out["entropy"].data_ptr(), out["mfcc"].data_ptr(), None)
    assert err == 0
    return out


def _frames(n: int, frame: int, seed: int) -> torch.Tensor:
    """Noise, a tone over the noise in every third frame, silent frames."""
    rng = np.random.default_rng(seed)
    t = np.arange(frame) / 16000
    x = rng.normal(0, 1000, (n, frame))
    x[1::3] += 5000 * np.sin(2 * np.pi * 130 * t + rng.uniform(0, 6, (len(x[1::3]), 1)))
    x[2::5] = 0.0
    return torch.from_numpy(x.astype(np.float32))


# (frame_size, window, n_fft, entropy_n_fft, route): 16-byte and one-float
# loads (400 vs 322 and 401), a window with zeros, every FFT size, a separate
# entropy spectrum (the kernel writes zeros), and the dense kernel.
K3_CASES = {
    "fft_320_of_512": (320, "hamming", 512, 512, "fft"),
    "fft_400_of_512": (400, "hamming", 512, 512, "fft"),
    "fft_400_hann": (400, "hanning", 512, 512, "fft"),
    "fft_322_one_float_loads": (322, "hamming", 512, 512, "fft"),
    "fft_401_odd_frame": (401, "hamming", 512, 512, "fft"),
    "fft_512_full_frame": (512, "hamming", 512, 512, "fft"),
    "fft_200_of_256": (200, "hamming", 256, 256, "fft"),
    "fft_400_of_1024": (400, "hamming", 1024, 1024, "fft"),
    "fft_1500_of_2048": (1500, "hamming", 2048, 2048, "fft"),
    "fft_separate_entropy": (400, "hamming", 512, 1024, "fft"),
    "dense_odd_n_fft": (400, "hamming", 511, 511, "dense"),
    "dense_n_fft_480": (320, "hamming", 480, 480, "dense"),
}


@pytest.mark.parametrize("n", [1, 21])
@pytest.mark.parametrize("case", list(K3_CASES))
def test_frame_kernels_on_cpu_match_plain(lib, case, n):
    frame, window, n_fft, ent, route = K3_CASES[case]
    pipe = FeaturePipeline(FeatureConfig(
        frame_size=frame, hop_size=160, window_type=window, n_fft=n_fft,
        entropy_n_fft=ent), device="cpu")
    consts = pipe._frame_consts
    assert fk.kernel_route(frame, n_fft // 2 + 1, consts["n_fft"]) == route
    frames = _frames(n, frame, seed=n)
    got = _k3(lib, frames, consts, route)
    want = fk.frame_features_plain(frames, **consts)
    if ent != n_fft:  # the wrapper fills the entropy in; the kernel writes 0
        want["entropy"] = torch.zeros(n)
    assert torch.equal(got["zcr"], want["zcr"])
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(got[k], want[k]) <= 1e-9, k
    # position independence: a frame alone gives the bits it gives in a batch
    if n > 1:
        alone = _k3(lib, frames[7:8].clone(), consts, route)
        for k in got:
            assert torch.equal(alone[k][0], got[k][7]), k


# (frame_size, hop): 16-byte loads, one-float loads, and the smallest and
# largest transforms (256 and 2048 points).
K2_CASES = {"320_160": (320, 160), "322_161": (322, 161), "128_64": (128, 64),
            "1000_500": (1000, 500)}


@pytest.mark.parametrize("n", [1, 150])
@pytest.mark.parametrize("case", list(K2_CASES))
def test_pitch_kernel_on_cpu_matches_plain(lib, case, n):
    frame, hop = K2_CASES[case]
    pipe = FeaturePipeline(FeatureConfig(
        frame_size=frame, hop_size=hop,
        n_fft=max(512, 1 << (frame - 1).bit_length())), device="cpu")
    lag_min, lag_max = 40, min(frame - 1, 320)
    merged, nyq_b, inv_live, inv_nyq = pipe._acf_bases(lag_max)
    rng = np.random.default_rng(n)
    t = np.arange((n + 1) * hop) / 16000
    sig = (rng.normal(0, 1000, t.size)
           + 3000 * np.sin(2 * np.pi * 130 * t) * (np.sin(2 * np.pi * 3 * t) > 0))
    rows = torch.from_numpy(sig.astype(np.float32)).reshape(n + 1, hop).clone()
    if n > 8:
        rows[5:8] = 0.0  # frames 5 and 6 are all zeros (bucket padding)
    n_fft = fft_tables.acf_fft_size(frame, lag_max + 1)
    table = fft_tables.device_twiddles(n_fft, CPU)
    f0, conf = torch.full((n,), np.nan), torch.full((n,), np.nan)
    err = lib.sspv_view_pitch(rows.data_ptr(), n, hop, table.data_ptr(), n_fft,
                              lag_min, lag_max, 16000.0, f0.data_ptr(),
                              conf.data_ptr(), None)
    assert err == 0
    pf0, pconf = vk.view_pitch_plain(
        rows, merged=merged, nyq_b=nyq_b, inv_live=inv_live, inv_nyq=inv_nyq,
        lag_min=lag_min, lag_max=lag_max, sample_rate=16000)
    assert _nmse(conf, pconf) <= 1e-9
    same = f0 == pf0
    if n > 8:
        # frames 4 and 7 are half zeros: the lags past their live half are
        # rounding noise around 0 in any implementation, and may win the band
        same[[4, 7]] = True
    assert same.float().mean().item() >= 0.999
    if n > 8:
        want = np.float32(16000) / np.float32(lag_min)
        assert f0[5] == f0[6] == want and not conf[5:7].any()


def _k1(lib, rows: torch.Tensor, consts: dict) -> dict:
    """``view_kernels.fused_view_features``'s launch against the CPU
    library."""
    n, hop = rows.shape[0] - 1, rows.shape[1]
    fb_t, dct, n_fft = consts["fb_t"], consts["dct"], consts["n_fft"]
    (n_bins, nf), nc = fb_t.shape, dct.shape[1]
    out = {k: torch.full((n,), np.nan) for k in ("energy", "zcr", "entropy")}
    out["mfcc"] = torch.full((n, nc), np.nan)
    err = lib.sspv_view_features(
        rows.data_ptr(), n, hop, consts["window"].data_ptr(),
        fft_tables.device_twiddles(n_fft, CPU).data_ptr(), n_fft,
        fb_t.data_ptr(), consts["mel_ranges"].data_ptr(), nf, dct.data_ptr(),
        consts["lifter"].data_ptr(), nc, float(np.float32(np.log(n_bins))),
        out["energy"].data_ptr(), out["zcr"].data_ptr(),
        out["entropy"].data_ptr(), out["mfcc"].data_ptr(), None)
    assert err == 0
    return out


def _rows(n: int, hop: int, seed: int) -> torch.Tensor:
    """Noise with a tone over part of it, samples that are exactly zero, a
    silent stretch, and sign flips and zeros right at row boundaries."""
    rng = np.random.default_rng(seed)
    t = np.arange((n + 1) * hop) / 16000
    sig = (rng.normal(0, 1000, t.size)
           + 4000 * np.sin(2 * np.pi * 130 * t) * (np.sin(2 * np.pi * 2 * t) > 0))
    sig[rng.integers(0, t.size, t.size // 50)] = 0.0
    rows = sig.astype(np.float32).reshape(n + 1, hop)
    for r in range(0, n, 2):  # a sign flip across every other row boundary
        rows[r, -1], rows[r + 1, 0] = 700.0, -300.0
    if n > 8:
        rows[3, -1] = 0.0  # a zero on one side of a boundary, then on both
        rows[5, -1] = rows[6, 0] = 0.0
        rows[12:15] = 0.0  # frames 12 and 13 are all zeros (bucket padding)
        # samples whose product with the window underflows to zero keep
        # their sign in the count: ZCR is that of the raw samples
        rows[16, :8] = np.float32(1e-45) * np.array([1, -1] * 4, np.float32)
    return torch.from_numpy(rows)


# (frame_size, hop, n_fft): 16-byte loads, one-float loads, a frame that
# fills the transform, and a 1024-point transform.
K1_CASES = {"320_160_of_512": (320, 160, 512),
            "322_161_one_float_loads": (322, 161, 512),
            "256_128_of_256_full_frame": (256, 128, 256),
            "640_320_of_1024": (640, 320, 1024)}


@pytest.mark.parametrize("n", [1, 21])
@pytest.mark.parametrize("case", list(K1_CASES))
def test_view_features_kernel_on_cpu_matches_plain(lib, case, n):
    """K1 at n = 1 and at a count that is no multiple of the warps per
    block: zcr EXACTLY equal (zeros and boundary flips included), the rest
    to NMSE; all-zero frames give energy 0, zcr 0 and finite features."""
    frame, hop, n_fft = K1_CASES[case]
    pipe = FeaturePipeline(FeatureConfig(
        frame_size=frame, hop_size=hop, n_fft=n_fft, entropy_n_fft=n_fft),
        device="cpu")
    assert pipe._view_kernel_ok
    consts = pipe._view_consts
    rows = _rows(n, hop, seed=n)
    got = _k1(lib, rows, consts)
    want = vk.view_features_plain(rows, **consts)
    assert torch.equal(got["zcr"], want["zcr"])
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(got[k], want[k]) <= 1e-9, k
    if n > 8:
        assert not got["energy"][12:14].any() and not got["zcr"][12:14].any()
        for k in got:
            assert bool(torch.isfinite(got[k]).all()), k


@pytest.mark.parametrize("case", ["320_160_of_512", "322_161_one_float_loads"])
def test_view_features_kernel_on_cpu_ignores_the_split(lib, case):
    """Position independence: a rows view split in two, the first part with
    its seam row (the second part's first row), gives every frame the bits
    the whole view gives it, as the shard route needs."""
    frame, hop, n_fft = K1_CASES[case]
    consts = FeaturePipeline(FeatureConfig(frame_size=frame, hop_size=hop),
                             device="cpu")._view_consts
    rows = _rows(21, hop, seed=3)
    whole = _k1(lib, rows, consts)
    head, tail = _k1(lib, rows[:11], consts), _k1(lib, rows[10:], consts)
    for k in whole:
        assert torch.equal(torch.cat([head[k], tail[k]]), whole[k]), k


def test_entry_points_refuse_geometries_without_a_kernel(lib):
    """The C entry points return an error (which the wrappers raise) for a
    transform size that has no instantiation and for a frame longer than
    the transform."""
    z = torch.zeros(4096)
    p = z.data_ptr()
    assert lib.sspv_view_pitch(p, 1, 160, p, 640, 40, 319, 16000.0, p, p,
                               None) != 0
    assert lib.sspv_view_pitch(p, 1, 400, p, 1024, 40, 319, 16000.0, p, p,
                               None) != 0
    assert lib.sspv_frame_features_fft(p, 1, 600, p, p, 512, p, p, 26, p, p,
                                       13, 1.0, 1, p, p, p, p, None) != 0
    assert lib.sspv_frame_features_fft(p, 1, 400, p, p, 500, p, p, 26, p, p,
                                       13, 1.0, 1, p, p, p, p, None) != 0
    assert lib.sspv_view_features(p, 1, 160, p, p, 640, p, p, 26, p, p, 13,
                                  1.0, p, p, p, p, None) != 0
    assert lib.sspv_view_features(p, 1, 300, p, p, 512, p, p, 26, p, p, 13,
                                  1.0, p, p, p, p, None) != 0
