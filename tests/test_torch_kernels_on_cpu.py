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
of frames (all of them on these inputs); K4's decisions, adaptive
decisions and new state EXACTLY equal.
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
from sspv_tpu_torch.ops import vad as tvad
from sspv_tpu_torch.ops import vad_kernels as vk4
from sspv_tpu_torch.ops import view_kernels as vk
from sspv_tpu_torch.ops.pipeline import FeatureConfig, FeaturePipeline
from sspv_tpu_torch.utils.synth import synth_signal

import oracle
import vad_inputs
from vad_inputs import row_mask, vad_rows

REPO = Path(__file__).resolve().parents[1]
GATES_K4 = vad_inputs.GATES
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
        spectrum = (fft_tables.device_twiddles(n_fft, CPU).data_ptr(), n_fft)
        kernel = lib.sspv_frame_features_fft
    else:
        packed = fk.pack_dense_bases(consts["wc"], consts["ws"])
        spectrum = (packed.data_ptr(), n_bins, *fk.dense_plan(frame, n_bins, f))
        kernel = lib.sspv_frame_features_dense
    err = kernel(frames.data_ptr(), f, frame, consts["window"].data_ptr(),
                 *spectrum, fb_t.data_ptr(), consts["mel_ranges"].data_ptr(),
                 nf, dct.data_ptr(), consts["lifter"].data_ptr(), nc,
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


# (frame_size, window, n_fft, entropy_n_fft, route[, num_filters]): 16-byte
# and one-float loads (400 vs 322 and 401), a window with zeros, every FFT
# size, a separate entropy spectrum (the kernel writes zeros), and the dense
# kernel: an odd n_fft, a non-power-of-two one, Whisper's framing (a
# 400-point DFT, Hann, 80 mel bands), a frame longer than n_fft (one-float
# loads, 1030 % 4 == 2), one whose block of 32 frames does not fit shared
# memory (1600: staged in chunks), and a 64-point DFT (9 column tiles: the
# last step takes 2 a warp; Whisper's 3 and 512's 1).
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
    "dense_whisper_400_hann_80_mel": (400, "hanning", 400, 400, "dense", 80),
    "dense_frame_1030_of_512": (1030, "hamming", 512, 512, "dense"),
    "dense_frame_1600_chunked": (1600, "hamming", 512, 512, "dense"),
    "dense_n_fft_64_two_tiles_a_warp": (64, "hamming", 64, 64, "dense"),
}
DENSE_CASES = [k for k, v in K3_CASES.items() if v[4] == "dense"]


def _k3_case(case: str, n: int):
    """The case's constants and ``n`` frames of it."""
    frame, window, n_fft, ent, route, *nf = K3_CASES[case]
    pipe = FeaturePipeline(FeatureConfig(
        frame_size=frame, hop_size=160, window_type=window, n_fft=n_fft,
        entropy_n_fft=ent, num_filters=(nf or [26])[0]), device="cpu")
    consts = pipe._frame_consts
    assert fk.kernel_route(frame, n_fft // 2 + 1, consts["n_fft"]) == route
    return consts, _frames(n, frame, seed=n)


@pytest.mark.parametrize("n", [1, 21])
@pytest.mark.parametrize("case", list(K3_CASES))
def test_frame_kernels_on_cpu_match_plain(lib, case, n):
    frame, _, n_fft, ent, route, *_ = K3_CASES[case]
    consts, frames = _k3_case(case, n)
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


@pytest.mark.parametrize("n", [7, 65])
@pytest.mark.parametrize("case", DENSE_CASES)
def test_dense_kernel_on_cpu_matches_plain(lib, case, n):
    """The dense kernel in blocks of 16 frames (7) and of 32 with a last
    block of one frame (65): zcr EXACTLY equal, the rest to NMSE; the last
    frame alone gives the bits it gives in the batch (1600 samples: in
    chunks in blocks of 32, all at once in blocks of 16)."""
    consts, frames = _k3_case(case, n)
    got = _k3(lib, frames, consts, "dense")
    want = fk.frame_features_plain(frames, **consts)
    assert torch.equal(got["zcr"], want["zcr"])
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(got[k], want[k]) <= 1e-9, k
    alone = _k3(lib, frames[-1:].clone(), consts, "dense")
    for k in got:
        assert torch.equal(alone[k][0], got[k][-1]), k


def test_dense_plan_stages_in_chunks_only_where_it_must():
    """The plans the cases above run: blocks of 32 frames (16 for up to 16
    frames), every sample staged at once, except a 1600-sample frame
    (chunks of 1440, a multiple of 32, staged again for each column
    step)."""
    assert fk.dense_plan(400, 201, 65) == (32, 400)
    assert fk.dense_plan(400, 256, 7) == (16, 400)
    assert fk.dense_plan(1030, 257, 65) == (32, 1040)
    assert fk.dense_plan(1600, 257, 21) == (32, 1440)
    assert fk.dense_plan(1600, 257, 7) == (16, 1600)


MMA_TILE = r"""
#include <cstdint>
#include "mma_tf32.cuh"

// One m16n8k8 tile: A (16 x 8) and B (8 x 8, [k][n]) row-major in memory,
// each lane loading the elements the PTX layout gives it; mode 0 rounds both
// to tf32 (one product), mode 1 splits both (3xTF32).
__global__ void tile_kernel(const float* a_mem, const float* b_mem,
                            const float* c_mem, float* d_mem, int mode) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const float a[4] = {a_mem[g * 8 + t], a_mem[(g + 8) * 8 + t],
                      a_mem[g * 8 + t + 4], a_mem[(g + 8) * 8 + t + 4]};
  const float b[2] = {b_mem[t * 8 + g], b_mem[(t + 4) * 8 + g]};
  const int at[4] = {g * 8 + 2 * t, g * 8 + 2 * t + 1, (g + 8) * 8 + 2 * t,
                     (g + 8) * 8 + 2 * t + 1};
  float d[4];
  for (int i = 0; i < 4; ++i) d[i] = c_mem[at[i]];
  uint32_t a_hi[4], a_lo[4], b_hi[2], b_lo[2];
  for (int i = 0; i < 4; ++i) sspv::split_tf32(a[i], a_hi[i], a_lo[i]);
  for (int i = 0; i < 2; ++i) sspv::split_tf32(b[i], b_hi[i], b_lo[i]);
  if (mode == 0)
    sspv::mma_tf32_m16n8k8(d, a_hi, b_hi);
  else
    sspv::mma_3xtf32_m16n8k8(d, a_hi, a_lo, b_hi, b_lo);
  for (int i = 0; i < 4; ++i) d_mem[at[i]] = d[i];
}

extern "C" void run_tile(const float* a, const float* b, const float* c,
                         float* d, int mode) {
  tile_kernel<<<1, 32, 0, nullptr>>>(a, b, c, d, mode);
}

extern "C" void split(const float* x, float* hi, float* lo, int n) {
  for (int i = 0; i < n; ++i) {
    uint32_t h, l;
    sspv::split_tf32(x[i], h, l);
    hi[i] = sspv::bits_float(h);
    lo[i] = sspv::bits_float(l);
  }
}
"""


@pytest.fixture(scope="module")
def mma_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel sources for the CPU")
    work = tmp_path_factory.mktemp("mma_tile")
    src = work / "tile.cpp"
    src.write_text(LAUNCH.sub(r"emu_launch(\1, \2, ", MMA_TILE))
    (work / "main.cpp").write_text('#define EMU_MAIN\n#include "cuda_runtime.h"\n')
    so = work / "libtile.so"
    res = subprocess.run(
        ["g++", "-std=c++17", "-O1", "-w", "-fPIC", "-shared", "-pthread",
         f"-I{STUB}", f"-I{CSRC}", "-o", str(so), str(work / "main.cpp"),
         str(src)], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.run_tile.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    lib.split.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    return lib


def _split(mma_lib, x: np.ndarray):
    """``split_tf32`` of every value of ``x``."""
    x = np.ascontiguousarray(x, np.float32)
    hi, lo = np.empty_like(x), np.empty_like(x)
    mma_lib.split(x.ctypes.data, hi.ctypes.data, lo.ctypes.data, x.size)
    return hi, lo


def test_tf32_rounding_is_cvt_rna(mma_lib):
    """Round to nearest, ties AWAY from zero (not to even), 10 mantissa
    bits kept: as ``cvt.rna.tf32.f32`` does, and as
    ``frame_kernels._tf32`` rounds the packed bases, for every finite
    value (a carry rounds into the exponent, up to infinity)."""
    bits = np.array([0x3F801000, 0xBF801000, 0x3F803000, 0x3F800FFF,
                     0x3F801001, 0x00000000, 0x3F7FF000, 0x7F7FF000,
                     0x00001000, 0x80001000], np.uint32)
    want = np.array([0x3F802000, 0xBF802000, 0x3F804000, 0x3F800000,
                     0x3F802000, 0x00000000, 0x3F800000, 0x7F800000,
                     0x00002000, 0x80002000], np.uint32)
    hi, _ = _split(mma_lib, bits.view(np.float32))
    np.testing.assert_array_equal(hi.view(np.uint32), want)
    np.testing.assert_array_equal(fk._tf32(bits.view(np.float32)).view(
        np.uint32), want)
    x = np.random.default_rng(0).normal(0, 1000, 4096).astype(np.float32)
    x = np.concatenate([x, x * 1e-40, x * 1e30])
    np.testing.assert_array_equal(_split(mma_lib, x)[0], fk._tf32(x))


def test_tf32_split_recovers_fp32(mma_lib):
    """hi + lo carries x to about 2^-22 of its magnitude; hi alone to
    2^-11."""
    x = np.random.default_rng(1).normal(0, 1000, 4096).astype(np.float32)
    hi, lo = _split(mma_lib, x)
    x64 = x.astype(np.float64)
    assert np.all(np.abs(hi - x64) <= 2.0**-11 * np.abs(x64))
    assert np.all(np.abs(hi + lo.astype(np.float64) - x64)
                  <= 2.0**-22 * np.abs(x64))
    assert np.abs(hi + lo.astype(np.float64) - x64).max() > 0  # not exact


@pytest.mark.parametrize("mode", ["tf32", "3xtf32"])
def test_mma_tile_emulation_matches_numpy(mma_lib, mode):
    """One 16 x 8 x 8 tile with C, operands that differ in every element:
    one TF32 product equals numpy's of the tf32-rounded operands (exact
    products, one rounding of the sum); the 3xTF32 product is within
    2^-20 of the float64 product's scale (the fp32 one's order)."""
    rng = np.random.default_rng(2)
    a = rng.normal(0, 1, (16, 8)).astype(np.float32)
    b = rng.normal(0, 1, (8, 8)).astype(np.float32)
    c = rng.normal(0, 1, (16, 8)).astype(np.float32)
    d = np.full((16, 8), np.nan, np.float32)
    mma_lib.run_tile(a.ctypes.data, b.ctypes.data, c.ctypes.data,
                     d.ctypes.data, int(mode == "3xtf32"))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    if mode == "tf32":
        want = (c + fk._tf32(a).astype(np.float64) @ fk._tf32(b)).astype(
            np.float32)
        np.testing.assert_array_equal(d, want)
        assert np.abs(d - (c + a64 @ b64)).max() > 1e-4  # TF32 alone is not
    else:
        scale = np.abs(a64) @ np.abs(b64) + np.abs(c)
        err = np.abs(d - (c + a64 @ b64))
        assert np.all(err <= 2.0**-20 * scale)


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
    # the dense kernel: a block size it has no instance for, a chunk that is
    # no multiple of 16, a plan past a block's shared memory
    for bm, chunk, n_bins in ((48, 400, 257), (64, 100, 257),
                              (64, 400, 2049)):
        assert lib.sspv_frame_features_dense(
            p, 1, 400, p, p, n_bins, bm, chunk, p, p, 26, p, p, 13, 1.0, 1,
            p, p, p, p, None) != 0


# -- K4: the streaming VAD ----------------------------------------------------
#
# Held EXACTLY equal to the plain version: decisions, adaptive decisions and
# every field of the new state. The window sums are float64 in both; where
# their orders differ (the direct form) the sums agree to the last bit or
# far below float32 resolution, and these inputs decide the same.

H = 256


def _k4(lib, e, z, h, state, valid=None, **kw):
    """``vad_kernels.launch`` (the wrapper's own launch) against the CPU
    library."""
    err, route, out = vk4.launch(lib, e, z, h, state, None, valid=valid, **kw)
    assert err == 0 and route is not None
    return out


def _k4_and_plain(lib, e, z, h, state, valid=None, **kw):
    """K4 and the plain version on the same inputs, held equal; K4's
    outputs."""
    got = _k4(lib, e, z, h, state, valid, **kw)
    want = tvad.streaming_vad(e, z, h, state, valid=valid, **kw)
    assert torch.equal(got[0], want[0]) and got[0].dtype == torch.int32
    assert torch.equal(got[1], want[1]) and got[1].dtype == torch.int32
    for name, g, w in zip(tvad.VadState._fields, got[2], want[2]):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    return got


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("mode", ["one call", "valid mask", "split at 4",
                                  "split at 256"])
@pytest.mark.parametrize("impl", ["conv", "blocked"])
@pytest.mark.parametrize("tie", ["zcr_tie", "energy_tie", "full_history_tie"])
def test_vad_kernel_on_cpu_decides_ties_as_plain(lib, tie, impl, mode):
    """The float32 threshold ties of ``test_torch_vad_gate``
    (``vad_inputs.TIES``): K4 decides them as the plain version and
    ``EngineVadOracle`` do, in one call, under a valid mask and split in
    two calls that carry the state."""
    e, z, h = vad_inputs.TIES[tie]()
    kw = dict(vad_inputs.GATES, trailing_impl=impl)
    init = tvad.initial_vad_state(device=CPU)
    n = e.size
    if mode == "one call":
        v, a, _ = _k4_and_plain(lib, _t(e), _t(z), _t(h), init, **kw)
    elif mode == "valid mask":
        pad = lambda x: _t(np.concatenate([x, np.zeros(256, np.float32)]))
        v, a, _ = _k4_and_plain(lib, pad(e), pad(z), pad(h), init,
                                torch.arange(n + 256) < n, **kw)
        v, a = v[:n], a[:n]
    else:
        cut = int(mode.split()[-1])
        v1, a1, s = _k4_and_plain(lib, _t(e[:cut]), _t(z[:cut]), _t(h[:cut]),
                                  init, **kw)
        v2, a2, _ = _k4_and_plain(lib, _t(e[cut:]), _t(z[cut:]), _t(h[cut:]),
                                  s, **kw)
        v, a = torch.cat([v1, v2]), torch.cat([a1, a2])
    want_v, want_a = oracle.EngineVadOracle().run_all(e, z, h)
    np.testing.assert_array_equal(v.numpy(), want_v)
    np.testing.assert_array_equal(a.numpy(), want_a)


@pytest.mark.parametrize("impl", ["conv", "blocked"])
def test_vad_kernel_on_cpu_keeps_frame_46(lib, impl):
    """``synth_signal``'s features, frame 46 among them (a float32 mean
    would flip it): exact length and padded to 256 under a mask, as the
    pipeline's two VAD calls run them."""
    pipe = FeaturePipeline(FeatureConfig(vad_trailing_impl=impl), device="cpu")
    block, _ = pipe.process_signal_device(synth_signal(2.0))
    e, z, h = block.energy, block.zcr, block.entropy
    kw = dict(pipe._vad_kwargs(), trailing_impl=impl)
    init = pipe.initial_state()
    v, a, _ = _k4_and_plain(lib, e, z, h, init, **kw)
    want_v, want_a = oracle.EngineVadOracle().run_all(e.numpy(), z.numpy(),
                                                      h.numpy())
    np.testing.assert_array_equal(v.numpy(), want_v)
    np.testing.assert_array_equal(a.numpy(), want_a)
    n = e.shape[0]
    pad = lambda x: torch.nn.functional.pad(x, (0, 256 - n))  # noqa: E731
    v, a, _ = _k4_and_plain(lib, pad(e), pad(z), pad(h), init,
                            torch.arange(256) < n, **kw)
    np.testing.assert_array_equal(v[:n].numpy(), want_v)


# (rows, frames, trailing sums, mask): every size class of the callers (one
# frame, less than a block, a block, past a block, a long call) under each
# mask, both sums where they differ (f a multiple of 256), and 4,096 frames
# once each way (the emulated barriers make long calls slow here)
VAD_CASES = [
    (b, f, impl, mask)
    for b, f in [(1, 1), (3, 255), (8, 256), (3, 257)]
    for impl in (["conv", "blocked"] if f % 256 == 0 else ["conv"])
    for mask in ("none", "prefix", "holes")
] + [(1, 4096, "blocked", "prefix"), (1, 4096, "conv", "holes"),
     (8, 4096, "blocked", "prefix")]


@pytest.mark.parametrize("b,f,impl,mask", VAD_CASES,
                         ids=["-".join(map(str, c)) for c in VAD_CASES])
def test_vad_kernel_on_cpu_matches_plain(lib, b, f, impl, mask):
    """Batched rows with their own states and masks, then a second call on
    the new states: K4 equals the plain version exactly, and (up to 257
    frames) a 1-D call of row 0 alone its batched row."""
    e, z, h, state = vad_rows(b, f, seed=b * 1000 + f)
    valid = row_mask(mask, b, f, seed=f)
    kw = dict(GATES_K4, trailing_impl=impl)
    _, _, state2 = _k4_and_plain(lib, e, z, h, state, valid, **kw)
    got = _k4_and_plain(lib, e.flip(-1), z, h, state2, valid, **kw)
    if f > 257:
        return
    one = _k4_and_plain(lib, e[0].flip(-1), z[0], h[0],
                        tvad.unstack_states(state2)[0],
                        None if valid is None else valid[0], **kw)
    assert torch.equal(one[0], got[0][0]) and torch.equal(one[1], got[1][0])
    for a, b_ in zip(one[2], tvad.unstack_states(got[2])[0]):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("knobs", [dict(adaptive_margin=1.5),
                                   dict(composite_mode="and"),
                                   dict(use_adaptive=False),
                                   dict(hangover_on=0, release_off=0),
                                   dict(hangover_on=5, release_off=7),
                                   dict(history_len=100)])
def test_vad_kernel_on_cpu_takes_every_knob(lib, knobs):
    """The opt-in margin and "and" composite, the fixed gate alone, other
    hangovers and another history length (blocked at 500 frames: a
    multiple of 100)."""
    hl = knobs.get("history_len", H)
    f = 500 if hl == 100 else 512
    e, z, h, _ = vad_rows(2, f, seed=7)
    state = tvad.initial_states(2, hl, device=CPU)
    for impl in ("conv", "blocked"):
        kw = dict(GATES_K4, trailing_impl=impl, **knobs)
        _, _, s = _k4_and_plain(lib, e, z, h, state, **kw)
        _k4_and_plain(lib, e, z, h, s, row_mask("prefix", 2, f, seed=1), **kw)


def test_vad_entry_point_refuses_what_it_does_not_take(lib):
    """A mask without its counts, no frame, no row, a history whose staged
    windows do not fit a block's shared memory. Blocked sums of a frame
    count that is no multiple of the history run (a ragged last block)."""
    z = torch.zeros(4096)
    i = torch.zeros(4096, dtype=torch.int32)
    p, q = z.data_ptr(), i.data_ptr()

    def call(rows, f, hl, flags, valid=None, n_valid=None, n_len=None):
        return lib.sspv_streaming_vad(
            p, p, p, valid, n_valid, f if n_len is None else n_len, p, p, q,
            q, rows, f, hl, 1.0, 0.3, 0.6, 0.5, 0.5, 1e-6, 0.5, 1.0, flags, 5,
            q, q, q, p, p, q, q, None)

    assert call(1, 100, 64, 0) == 0
    assert call(1, 100, 64, 4) == 0
    assert call(1, 128, 64, 4, n_len=37) == 0
    assert call(1, 100, 64, 0, valid=p) != 0
    assert call(1, 0, 64, 0) != 0 and call(0, 100, 64, 0) != 0
    assert call(1, 100, 40_000, 0) != 0


# (history_len, rows, frames) for the per-block scans: one frame a block, a
# block that does not divide the 256-frame tile, the default, a block longer
# than a tile; frames never a multiple of the history (a ragged last block)
SCAN_CASES = [(1, 2, 300), (7, 3, 300), (256, 3, 700), (300, 2, 700)]


def _row_lengths(kind: str, b: int, f: int, seed: int):
    """Every row's valid frames: all of them ("none": no lengths), one int
    for all ("int"), or an int32 per row ("rows": 0 and f among them)."""
    if kind == "none":
        return None
    if kind == "int":
        return f - 3
    rng = np.random.default_rng(seed)
    n = ([0, f, f // 2] + list(rng.integers(1, f, b)))[:b]
    return torch.tensor(n, dtype=torch.int32)


@pytest.mark.parametrize("route", ["blocked", "direct"])
@pytest.mark.parametrize("kind", ["none", "int", "rows"])
@pytest.mark.parametrize("hl,b,f", SCAN_CASES,
                         ids=["-".join(map(str, c)) for c in SCAN_CASES])
def test_vad_kernel_on_cpu_lengths_and_block_scans(lib, hl, b, f, kind, route):
    """K4's lengths path and its per-block scans: rows of ragged lengths
    (one for all, or one each), the blocked order asked for at a frame
    count that is no multiple of the history, then a second call on the
    state the first left. Decisions, adaptive decisions and the state
    EQUAL to the plain version (which pads to a multiple of the history
    under the mask the lengths stand for), and each row equal to its own
    1-D call at its exact length."""
    e, z, h, state = vad_rows(b, f, seed=hl * 10 + f, history_len=hl)
    lengths = _row_lengths(kind, b, f, seed=hl)
    # the padded call's frame count: a multiple of the history, or (where
    # the history is longer than one frame) not; at H = 1 the direct order
    # is the "conv" configuration's
    rf = -(-f // hl) * hl + (0 if route == "blocked" or hl == 1 else 1)
    impl = "conv" if route == "direct" and hl == 1 else "blocked"
    kw = dict(GATES_K4, trailing_impl=impl, history_len=hl, route_frames=rf)

    def both(e, z, h, state, lengths):
        err, got_route, got = vk4.launch(lib, e, z, h, state, None,
                                         lengths=lengths, **kw)
        assert err == 0
        assert got_route == ("vad_" + route if e.shape[-1] else None)
        want = vk4.plain_streaming_vad(e, z, h, state, lengths=lengths, **kw)
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == torch.int32 and torch.equal(g, w)
        for name, g, w in zip(tvad.VadState._fields, got[2], want[2]):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert torch.equal(g, w), name
        return got

    _, _, state2 = both(e, z, h, state, lengths)
    got = both(e.flip(-1), z, h, state2, lengths)
    ns = ([f] * b if lengths is None else [lengths] * b
          if isinstance(lengths, int) else lengths.tolist())
    for r, n in enumerate(ns):
        one = both(e[r].flip(-1)[:n].contiguous(), z[r, :n].contiguous(),
                   h[r, :n].contiguous(), tvad.unstack_states(state2)[r], None)
        assert torch.equal(one[0], got[0][r, :n])
        assert torch.equal(one[1], got[1][r, :n])
        for a, b_ in zip(one[2], tvad.unstack_states(got[2])[r]):
            assert torch.equal(a, b_)


@pytest.mark.parametrize("impl", ["conv", "blocked"])
@pytest.mark.parametrize("tie", ["zcr_tie", "energy_tie", "full_history_tie"])
def test_vad_kernel_on_cpu_decides_ties_at_exact_length(lib, tie, impl):
    """The float32 threshold ties again, at an exact length of 300 frames
    with the order of a padded call of 512 (blocked where the
    configuration asks for it) and with lengths in place of the mask: the
    engine oracle's decisions."""
    e, z, h = (x[:300] for x in vad_inputs.TIES[tie]())
    kw = dict(vad_inputs.GATES, trailing_impl=impl, route_frames=512)
    init = tvad.initial_vad_state(device=CPU)
    err, _, got = vk4.launch(lib, _t(e), _t(z), _t(h), init, None,
                             lengths=300, **kw)
    assert err == 0
    want = vk4.plain_streaming_vad(_t(e), _t(z), _t(h), init, lengths=300,
                                   **kw)
    for g, w in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        assert torch.equal(g, w)
    want_v, want_a = oracle.EngineVadOracle().run_all(e, z, h)
    np.testing.assert_array_equal(got[0].numpy(), want_v)
    np.testing.assert_array_equal(got[1].numpy(), want_a)
