#!/usr/bin/env python3
"""The frames-path kernel's wrapper on CPU tensors (its plain PyTorch
version) against the JAX package and the NumPy oracle.

Cases: the 320/160 engine framing and the 400/160 ASR framing with a
Hamming window, 400 with a Hann window (zeros at both ends, so the ZCR of
the windowed frame differs from the raw frame's), and 400 with a separate
1024-point entropy spectrum.

Tolerances, each with its reason:

- vs the JAX Pallas kernel ``fused_features`` in interpret mode (as
  ``tests/test_pallas_fused.py`` runs it): zcr within 1 ulp (the kernel may
  divide where the port multiplies by the reciprocal), energy/entropy/mfcc
  NMSE <= 1e-9 (both float32, different summation order: observed ~1e-13).
- vs the jitted JAX ``FeaturePipeline.features`` (XLA, float32 on the
  CPU): zcr EXACTLY equal (the same integer count times the same float32
  reciprocal), energy/entropy/mfcc NMSE <= 1e-9.
- vs the float64 NumPy oracle: NMSE <= 1e-7, the JAX suite's gate.
"""

import numpy as np
import pytest
import torch

from sspv_tpu.ops.pallas_kernels import fused_features as j_fused_features
from sspv_tpu.ops.pipeline import FeatureConfig as JConfig
from sspv_tpu.ops.pipeline import FeaturePipeline as JPipeline
from sspv_tpu_torch.ops import frame_kernels as fk
from sspv_tpu_torch.ops.pipeline import FeatureConfig as TConfig
from sspv_tpu_torch.ops.pipeline import FeaturePipeline as TPipeline

import oracle

CASES = {
    "hamming_320": dict(frame_size=320, hop_size=160),
    "hamming_400": dict(frame_size=400, hop_size=160),
    "hann_400": dict(frame_size=400, hop_size=160, window_type="hanning"),
    "entropy_1024": dict(frame_size=400, hop_size=160, entropy_n_fft=1024),
}
SIZES = (1, 3, 8, 257)


def _nmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


@pytest.fixture(scope="module")
def pipes():
    return {k: (JPipeline(JConfig(**g)), TPipeline(TConfig(**g), device="cpu"))
            for k, g in CASES.items()}


def _frames(n, frame, seed):
    """Noise, a 130 Hz tone over the noise in every third frame, and a few
    silent frames. (A pure tone under a Hann window leaves bands whose
    power lies below float32 rounding of the DFT, where the log spectrum
    is noise in any implementation: the noise floor keeps every band
    well-conditioned.)"""
    rng = np.random.default_rng(seed)
    t = np.arange(frame) / 16000
    x = rng.normal(0, 1000, (n, frame))
    phase = rng.uniform(0, 6, (len(x[1::3]), 1))
    x[1::3] += 5000 * np.sin(2 * np.pi * 130 * t + phase)
    x[2::5] = 0.0
    return x.astype(np.float32)


def _port(tp, frames):
    out = fk.fused_features(torch.from_numpy(frames), **tp._frame_consts)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_pallas_kernel(pipes, case, n):
    jp, tp = pipes[case]
    frames = _frames(n, jp.cfg.frame_size, seed=n)
    got = _port(tp, frames)
    want = j_fused_features(
        frames, wc=jp._wc, ws=jp._ws, fb_t=jp._fb_t, dct=jp._dct,
        lifter=jp._lifter, window=jp._window,
        entropy_bases=(jp._wc_ent, jp._ws_ent),
    )
    want = {k: np.asarray(v) for k, v in want.items()}
    assert got["mfcc"].shape == (n, 13) and got["energy"].shape == (n,)
    ulp = np.spacing(np.float32(1.0))
    assert np.all(np.abs(got["zcr"] - want["zcr"]) <= ulp)
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(got[k], want[k]) <= 1e-9, k


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_features_jitted(pipes, case, n):
    jp, tp = pipes[case]
    frames = _frames(n, jp.cfg.frame_size, seed=10 + n)
    got = tp.features(frames)
    want = {k: np.asarray(v) for k, v in jp.features(frames).items()}
    np.testing.assert_array_equal(got["zcr"].numpy(), want["zcr"])
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(got[k].numpy(), want[k]) <= 1e-9, k


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_numpy_oracle(pipes, case):
    _, tp = pipes[case]
    c = tp.cfg
    raw = _frames(64, c.frame_size, seed=7)
    got = _port(tp, raw)
    windowed = (raw * tp._window.numpy()).astype(np.float32)
    want = {
        "energy": oracle.short_time_energy(windowed),
        "zcr": oracle.zero_crossing_rate(windowed),
        "entropy": oracle.spectral_entropy(windowed, c.entropy_n_fft),
        "mfcc": oracle.mfcc(windowed, 16000, lifter=22),
    }
    for k, w in want.items():
        assert _nmse(got[k], w) <= 1e-7, k


def test_hann_zcr_counts_the_windowed_frame(pipes):
    """A Hann window's zeros at both ends change the sign-change count of
    the windowed frame against the raw one: the port counts x*w, as the
    JAX kernel does."""
    _, tp = pipes["hann_400"]
    x = np.full((1, 400), -100.0, np.float32)  # no sign change at all
    assert oracle.zero_crossing_rate(x)[0] == 0.0
    # the window's zeros at both ends: sign 0 -> -1 and -1 -> 0
    zcr = _port(tp, x)["zcr"][0]
    assert zcr == np.float32(2) * (np.float32(1) / np.float32(400))


def test_zero_frames_are_finite(pipes):
    """Bucket padding: all-zero frames give energy 0, zcr 0 and finite
    entropy and mfcc (the mel clamp and the 1e-12 entropy floor)."""
    for _, tp in pipes.values():
        out = _port(tp, np.zeros((5, tp.cfg.frame_size), np.float32))
        assert not out["energy"].any() and not out["zcr"].any()
        assert all(np.isfinite(v).all() for v in out.values())


def test_separate_entropy_spectrum(pipes):
    """With entropy_n_fft != n_fft the entropy comes from the separate
    spectrum (the kernel zero-fills its own and the wrapper computes it):
    not the n_fft spectrum's entropy; the other features are unchanged."""
    _, tp = pipes["entropy_1024"]
    frames = torch.from_numpy(_frames(9, 400, seed=3))
    consts = dict(tp._frame_consts)
    wce, wse = consts.pop("entropy_bases")
    shared = fk.frame_features_plain(frames, **consts)
    got = fk.fused_features(frames, **tp._frame_consts)
    np.testing.assert_array_equal(
        got["entropy"].numpy(), fk._separate_entropy(frames, wce, wse).numpy()
    )
    assert not np.allclose(got["entropy"].numpy(), shared["entropy"].numpy())
    for k in ("energy", "zcr", "mfcc"):
        assert torch.equal(got[k], shared[k])


def test_plain_blocks_equal_one_block(pipes):
    """The plain version's frame blocking (bounded intermediates) leaves
    every frame's value as it was, up to the summation order BLAS picks for
    another number of rows (NMSE <= 1e-12; zcr exact)."""
    _, tp = pipes["hamming_400"]
    frames = torch.from_numpy(_frames(700, 400, seed=9))
    one = fk.frame_features_plain(frames, **tp._frame_consts)
    many = fk.frame_features_plain(frames, **tp._frame_consts, block_frames=256)
    assert torch.equal(many["zcr"], one["zcr"])
    for k in ("energy", "entropy", "mfcc"):
        assert _nmse(many[k], one[k]) <= 1e-12, k


# -- which K3 kernel a CUDA tensor would take ---------------------------------

ROUTE_CASES = {
    "engine_320_of_512": (dict(frame_size=320, hop_size=160), "fft"),
    "asr_400_of_512": (dict(frame_size=400, hop_size=160), "fft"),
    "hann_400_of_512": (dict(frame_size=400, hop_size=160,
                             window_type="hanning"), "fft"),
    "odd_frame_322_of_512": (dict(frame_size=322, hop_size=161), "fft"),
    "n_fft_256": (dict(frame_size=200, hop_size=80, n_fft=256,
                       entropy_n_fft=256), "fft"),
    "n_fft_2048": (dict(frame_size=1500, hop_size=500, n_fft=2048,
                        entropy_n_fft=2048), "fft"),
    "separate_entropy": (dict(frame_size=400, hop_size=160,
                              entropy_n_fft=1024), "fft"),
    "odd_n_fft": (dict(n_fft=511, entropy_n_fft=511), "dense"),
    "n_fft_not_power_of_two": (dict(frame_size=400, hop_size=160, n_fft=480,
                                    entropy_n_fft=480), "dense"),
    "frame_longer_than_n_fft": (dict(frame_size=1030, hop_size=515), "dense"),
    "n_fft_below_smallest": (dict(frame_size=64, hop_size=32, n_fft=128,
                                  entropy_n_fft=128), "dense"),
    "n_fft_above_largest": (dict(frame_size=400, hop_size=160, n_fft=4096,
                                 entropy_n_fft=4096), "dense"),
    "whisper_400_of_400": (dict(frame_size=400, hop_size=160, n_fft=400,
                                entropy_n_fft=400, window_type="hanning",
                                num_filters=80), "dense"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_kernel_route_by_geometry(case):
    """The wrapper's route is a function of the geometry the pipeline
    states: power-of-two standard bases no shorter than the frame take the
    FFT kernel, everything else the dense one."""
    geometry, want = ROUTE_CASES[case]
    tp = TPipeline(TConfig(**geometry), device="cpu")
    consts = tp._frame_consts
    assert consts["n_fft"] == tp.cfg.n_fft  # the pipeline built these bases
    assert fk.kernel_route(tp.cfg.frame_size, consts["fb_t"].shape[0],
                           consts["n_fft"]) == want
    ranges = consts["mel_ranges"]
    assert ranges.dtype == torch.int32
    assert ranges.shape == (tp.cfg.num_filters, 2)


def test_arbitrary_bases_take_the_dense_route():
    """Bases the pipeline did not build (here: a DFT pair with another
    window folded in) are not vouched for, so no FFT stands in for them;
    loading the pipeline's own bases back restores the FFT route."""
    tp = TPipeline(TConfig(frame_size=400, hop_size=160), device="cpu")
    own = tp.constants()
    other = TPipeline(TConfig(frame_size=400, hop_size=160,
                              window_type="hanning"), device="cpu").constants()
    tp.load_constants({"wc": other["wc"], "ws": other["ws"]})
    assert tp._frame_consts["n_fft"] is None
    assert fk.kernel_route(400, 257, tp._frame_consts["n_fft"]) == "dense"
    tp.load_constants({"window": other["window"]})  # now Hann throughout,
    assert tp._frame_consts["n_fft"] is None        # but the config says Hamming
    tp.load_constants(own)
    assert tp._frame_consts["n_fft"] == 512
    # a filterbank of another size than n_fft // 2 + 1 bins never takes the FFT
    assert fk.kernel_route(400, 200, 512) == "dense"


def test_cpu_frames_launch_no_kernel_on_either_route():
    tp = TPipeline(TConfig(frame_size=400, hop_size=160), device="cpu")
    before = dict(fk.LAUNCHES), dict(fk.ROUTES)
    frames = torch.from_numpy(_frames(9, 400, seed=0))
    with_fft = fk.fused_features(frames, **tp._frame_consts)
    dense = dict(tp._frame_consts, n_fft=None, mel_ranges=None)
    without = fk.fused_features(frames, **dense)
    assert (dict(fk.LAUNCHES), dict(fk.ROUTES)) == before
    for k in with_fft:  # the plain version reads neither keyword
        assert torch.equal(with_fft[k], without[k])


# -- the dense kernel's operand and plan --------------------------------------


def test_kernel_route_refuses_what_no_kernel_takes():
    """Past the dense kernel's plan (the power rows of 16 frames over a
    block's shared memory: n_fft 8192 has 4,097 bins) kernel_route raises
    with a message; the CPU pipeline still serves the geometry (its plain
    version) and builds no packed bases for it."""
    assert fk.dense_plan(400, 4097) is None
    with pytest.raises(NotImplementedError, match="4097 bins"):
        fk.kernel_route(400, 4097, None)
    tp = TPipeline(TConfig(frame_size=400, hop_size=160, n_fft=8192,
                           entropy_n_fft=8192), device="cpu")
    assert tp._frame_consts["dense_bases"] is None
    out = tp.features(_frames(3, 400, seed=0))
    assert out["mfcc"].shape == (3, 13)


@pytest.mark.parametrize("frame,n_bins", [(400, 201), (401, 256), (64, 17),
                                          (1030, 257)])
def test_pack_dense_bases_layout(frame, n_bins):
    """The packed operand: [kb, tile, 4 g + t] holds (hi, hi, lo, lo) of rows
    8 kb + 2t and 8 kb + 2t + 1 of column 8 tile + g of the interleaved
    (wc_k, ws_k) pair, zero past the frame (to a multiple of 16 samples) and
    past 2 n_bins columns (to a multiple of 256); hi = tf32(b),
    lo = tf32(b - hi), and hi + lo is b to 2^-22."""
    rng = np.random.default_rng(frame)
    wc = rng.normal(0, 1, (frame, n_bins)).astype(np.float32)
    ws = rng.normal(0, 1, (frame, n_bins)).astype(np.float32)
    packed = fk.pack_dense_bases(torch.from_numpy(wc), torch.from_numpy(ws))
    kp = -(-frame // fk.DENSE_DEPTH) * fk.DENSE_DEPTH
    step = fk.DENSE_STEP_TILES
    tiles = -(-(-(-2 * n_bins // 8)) // step) * step
    assert packed.shape == (kp // 8, tiles, 32, 4)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    b = np.zeros((kp, 8 * tiles), np.float32)
    b[:frame, 0:2 * n_bins:2], b[:frame, 1:2 * n_bins:2] = wc, ws
    p = packed.numpy()
    for kb, tile, g, t in [(0, 0, 0, 0), (kp // 8 - 1, tiles - 1, 7, 3),
                           (kp // 8 // 2, 3, 5, 2)]:
        rows, col = [8 * kb + 2 * t, 8 * kb + 2 * t + 1], 8 * tile + g
        hi = fk._tf32(b[rows, col])
        lo = fk._tf32(b[rows, col] - hi)
        np.testing.assert_array_equal(p[kb, tile, 4 * g + t], [*hi, *lo])
    hi, lo = p[..., :2], p[..., 2:]
    np.testing.assert_array_equal(hi, fk._tf32(hi))  # 13 low bits zero
    np.testing.assert_array_equal(lo, fk._tf32(lo))
    whole = (hi.astype(np.float64) + lo).transpose(0, 3, 1, 2).reshape(
        kp // 8, 2, tiles, 8, 4).transpose(0, 4, 1, 2, 3).reshape(kp, -1)
    assert np.all(np.abs(whole - b) <= 2.0**-22 * np.abs(b))
    assert not whole[frame:].any() and not whole[:, 2 * n_bins:].any()


def test_pipeline_packs_the_bases_the_dense_route_reads():
    """The pipeline packs wc/ws once where K3 takes the dense route (none
    where the FFT route serves the geometry), and packs again when
    load_constants brings other bases; its own bases back restore the FFT
    route and drop the pack."""
    whisper = TPipeline(TConfig(**ROUTE_CASES["whisper_400_of_400"][0]),
                        device="cpu")
    consts = whisper._frame_consts
    assert torch.equal(consts["dense_bases"],
                       fk.pack_dense_bases(consts["wc"], consts["ws"]))
    tp = TPipeline(TConfig(frame_size=400, hop_size=160), device="cpu")
    assert tp._frame_consts["dense_bases"] is None
    own = tp.constants()
    other = TPipeline(TConfig(frame_size=400, hop_size=160,
                              window_type="hanning"), device="cpu").constants()
    tp.load_constants({"wc": other["wc"], "ws": other["ws"]})
    packed = tp._frame_consts["dense_bases"]
    assert torch.equal(packed, fk.pack_dense_bases(
        torch.from_numpy(other["wc"]), torch.from_numpy(other["ws"])))
    tp.load_constants(own)
    assert tp._frame_consts["n_fft"] == 512
    assert tp._frame_consts["dense_bases"] is None
