#!/usr/bin/env python3
"""The device FFT's tables and schedule, rehearsed on the CPU.

``csrc/fft.cuh`` cannot run without the card, so this file runs ITS
schedule step by step in float32 PyTorch from the tables of
``sspv_tpu_torch.ops.fft_tables``: the even/odd packing into the swizzled
buffer, every radix-8 / radix-4 Stockham stage with its table twiddles, the
pairwise untangling, the ranged mel sum and the two-FFT ACF. The emulation
is test code, not a route of the port: it pins the index math and the
tables, and shows that an FFT-built spectrum stays inside the gates the
kernels are held to against the dense-basis plain versions.

Tolerances: float32 FFT vs float64 ``torch.fft.rfft`` and vs the dense
float32 basis product, NMSE <= 1e-10 (both are rounding-level); the ACF's
confidence against ``view_pitch_plain`` NMSE <= 1e-9 and F0 equal on
>= 99.9 % of frames, the kernels' own gates.
"""

import math

import numpy as np
import pytest
import torch

from sspv_tpu_torch.ops import bases, fft_tables
from sspv_tpu_torch.ops import view_kernels as vk
from sspv_tpu_torch.ops.pipeline import FeatureConfig, FeaturePipeline

SQRT_HALF = float(np.float32(math.sqrt(0.5)))


def _nmse(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


# -- the kernel's schedule, one step per function -------------------------------


def phys(i):
    """Position of element ``i`` in a buffer (``fft.cuh`` ``phys``): an XOR
    swizzle inside each run of 32, so every stage reads and writes 32
    different banks."""
    return i ^ (((i >> 5) & 7) | (((i >> 6) & 3) << 3))


def pack(x: torch.Tensor, n_fft: int):
    """Frames ``(F, n <= n_fft)`` zero-padded and packed as
    ``z[n] = x[2n] + i x[2n+1]`` into swizzled ``(F, n_fft/2)`` buffers."""
    m = n_fft // 2
    padded = torch.zeros((x.shape[0], n_fft), dtype=torch.float32)
    padded[:, : x.shape[1]] = x
    idx = torch.from_numpy(phys(np.arange(m)))
    re = torch.empty((x.shape[0], m), dtype=torch.float32)
    im = torch.empty_like(re)
    re[:, idx] = padded[:, 0::2]
    im[:, idx] = padded[:, 1::2]
    return re, im


def _mul_neg_i(a):
    return a[1], -a[0]


def _add(a, b):
    return a[0] + b[0], a[1] + b[1]


def _sub(a, b):
    return a[0] - b[0], a[1] - b[1]


def dft4(x):
    """Forward 4-point DFT in natural order (``fft.cuh`` ``dft4``)."""
    s0, s1 = _add(x[0], x[2]), _sub(x[0], x[2])
    s2, s3 = _add(x[1], x[3]), _mul_neg_i(_sub(x[1], x[3]))
    return [_add(s0, s2), _add(s1, s3), _sub(s0, s2), _sub(s1, s3)]


def dft8(a):
    """Forward 8-point DFT in natural order (``fft.cuh`` ``dft8``): one
    radix-2 split, then two 4-point DFTs."""
    u = [_add(a[k], a[k + 4]) for k in range(4)]
    d = [_sub(a[k], a[k + 4]) for k in range(4)]
    v = [
        d[0],
        ((d[1][0] + d[1][1]) * SQRT_HALF, (d[1][1] - d[1][0]) * SQRT_HALF),
        _mul_neg_i(d[2]),
        ((d[3][1] - d[3][0]) * SQRT_HALF, -(d[3][0] + d[3][1]) * SQRT_HALF),
    ]
    even, odd = dft4(u), dft4(v)
    return [even[0], odd[0], even[1], odd[1], even[2], odd[2], even[3], odd[3]]


def stage(re, im, m_total: int, n_left: int, s: int, r: int, tw):
    """One Stockham stage (``fft.cuh`` ``fft_stage``): butterfly ``t`` reads
    elements ``t + b*k`` (``b = m_total / r``), transforms them, multiplies
    output ``j`` by ``exp(-2 pi i p j / n_left)`` from the stage's table
    section ``tw``, and writes element ``q + s*(r*p + j)`` of the other
    buffer, with ``q = t % s``, ``p = t / s``."""
    b, m = m_total // r, n_left // r
    t = np.arange(b)
    q, p = t % s, t // s
    a = [(re[:, phys(t + b * k)], im[:, phys(t + b * k)]) for k in range(r)]
    out = dft8(a) if r == 8 else dft4(a)
    new_re, new_im = torch.empty_like(re), torch.empty_like(im)
    for j in range(r):
        xr, xi = out[j]
        if j and m > 1:
            c = tw[(j - 1) * m + p]
            sn = tw[(r - 1) * m + (j - 1) * m + p]
            xr, xi = xr * c + xi * sn, xi * c - xr * sn
        dst = phys(q + s * (r * p + j))
        new_re[:, dst], new_im[:, dst] = xr, xi
    return new_re, new_im


def complex_fft(re, im, n_fft: int, table: torch.Tensor):
    m_total = n_fft // 2
    off = fft_tables.untangle_floats(n_fft)
    for n_left, s, r in fft_tables.stage_plan(n_fft):
        size = fft_tables.stage_twiddle_floats(n_left, r)
        re, im = stage(re, im, m_total, n_left, s, r, table[off : off + size])
        off += size
    assert off == table.numel()
    return re, im


def untangle(re, im, n_fft: int, table: torch.Tensor):
    """Bins ``0..n_fft/2`` of the real sequence from ``Z`` (``fft.cuh``
    ``untangle``): pairs ``(k, M - k)`` for ``k <= M/2``. Returns
    ``(Re X, Im X)``, ``(F, M + 1)`` each."""
    m = n_fft // 2
    k = np.arange(m // 2 + 1)
    c, sn = table[k], table[m // 2 + 1 + k]
    ar, ai = re[:, phys(k)], im[:, phys(k)]
    br, bi = re[:, phys((m - k) & (m - 1))], im[:, phys((m - k) & (m - 1))]
    er, ei = 0.5 * (ar + br), 0.5 * (ai - bi)
    o_r, oi = 0.5 * (ai + bi), 0.5 * (br - ar)
    tr, ti = o_r * c + oi * sn, oi * c - o_r * sn  # W O
    xr = torch.empty((re.shape[0], m + 1), dtype=torch.float32)
    xi = torch.empty_like(xr)
    xr[:, m - k], xi[:, m - k] = er - tr, -(ei - ti)
    xr[:, k], xi[:, k] = er + tr, ei + ti
    return xr, xi


def rfft_emulated(x: torch.Tensor, n_fft: int):
    table = torch.from_numpy(fft_tables.twiddle_table(n_fft))
    re, im = pack(x, n_fft)
    re, im = complex_fft(re, im, n_fft, table)
    return untangle(re, im, n_fft, table)


def power_emulated(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    xr, xi = rfft_emulated(x, n_fft)
    return xr * xr + xi * xi


def acf_emulated(frames: torch.Tensor, n_fft: int, n_lags: int) -> torch.Tensor:
    """K2's two transforms: the power spectrum, then the real part of the
    FFT of its even extension, over ``n_fft``."""
    power = power_emulated(frames, n_fft)
    even = torch.cat([power, power[:, 1:-1].flip(1)], dim=1)
    xr, _ = rfft_emulated(even, n_fft)
    return xr[:, :n_lags] * (1.0 / n_fft)


# -- tests ---------------------------------------------------------------------


@pytest.mark.parametrize("n_fft", fft_tables.FFT_SIZES)
def test_stage_plan_and_table_layout(n_fft):
    plan = fft_tables.stage_plan(n_fft)
    assert math.prod(r for _, _, r in plan) == n_fft // 2
    assert all(r in (4, 8) for _, _, r in plan)
    assert plan[0][:2] == (n_fft // 2, 1) and plan[-1][0] == plan[-1][2]
    for (n0, s0, r0), (n1, s1, _) in zip(plan, plan[1:]):
        assert (n1, s1) == (n0 // r0, s0 * r0)
    table = fft_tables.twiddle_table(n_fft)
    assert table.dtype == np.float32
    assert table.size == fft_tables.untangle_floats(n_fft) + sum(
        fft_tables.stage_twiddle_floats(n, r) for n, _, r in plan)
    k = np.arange(n_fft // 4 + 1)
    np.testing.assert_array_equal(
        table[: k.size], np.cos(2 * np.pi * k / n_fft).astype(np.float32))
    # the swizzle is a permutation of every run of 32
    i = np.arange(n_fft // 2)
    assert np.array_equal(np.sort(phys(i)), i)
    assert np.array_equal(phys(i) >> 5, i >> 5)


def test_fft_sizes_by_geometry():
    assert fft_tables.fft_route_size(400, 512) == 512
    assert fft_tables.fft_route_size(320, 512) == 512
    assert fft_tables.fft_route_size(1030, 512) is None  # frame > n_fft
    assert fft_tables.fft_route_size(400, 511) is None
    assert fft_tables.fft_route_size(400, 500) is None
    assert fft_tables.fft_route_size(64, 128) is None  # below the smallest
    assert fft_tables.fft_route_size(400, 4096) is None
    assert fft_tables.acf_fft_size(320, 320) == 1024
    assert fft_tables.acf_fft_size(322, 321) == 1024
    assert fft_tables.acf_fft_size(128, 128) == 256
    assert fft_tables.acf_fft_size(2000, 400) is None
    with pytest.raises(ValueError):
        fft_tables.twiddle_table(640)


@pytest.mark.parametrize("frame", [None, 7])
@pytest.mark.parametrize("n_fft", fft_tables.FFT_SIZES)
def test_emulated_schedule_matches_rfft(n_fft, frame):
    """The kernel's schedule from the kernel's tables gives the real FFT."""
    frame = n_fft if frame is None else n_fft * frame // 8
    rng = np.random.default_rng(n_fft + frame)
    x = torch.from_numpy(rng.normal(0, 1000, (9, frame)).astype(np.float32))
    xr, xi = rfft_emulated(x, n_fft)
    want = torch.fft.rfft(x.double(), n=n_fft)
    assert xr.shape == (9, n_fft // 2 + 1)
    assert _nmse(xr, want.real) <= 1e-10
    assert _nmse(xi, want.imag) <= 1e-10
    assert _nmse(xr * xr + xi * xi, want.abs() ** 2) <= 1e-10


@pytest.mark.parametrize("window", ["hamming", "hanning"])
@pytest.mark.parametrize("n_fft", fft_tables.FFT_SIZES)
def test_emulated_power_matches_dense_basis(n_fft, window):
    """... and the plain version's dense windowed-basis power spectrum."""
    from sspv_tpu_torch.ops.frame_kernels import _power
    from sspv_tpu_torch.ops.windows import get_window

    frame = n_fft * 25 // 32  # 400 at 512
    rng = np.random.default_rng(n_fft)
    x = torch.from_numpy(rng.normal(0, 1000, (33, frame)).astype(np.float32))
    wc, ws = bases.windowed_dft_bases(frame, n_fft, window)
    want = _power(x, torch.from_numpy(wc), torch.from_numpy(ws))
    w = torch.from_numpy(get_window(window, frame).astype(np.float32))
    got = power_emulated(x * w, n_fft)
    assert _nmse(got, want) <= 1e-10


@pytest.mark.parametrize("n_fft,filters", [(256, 20), (512, 26), (512, 40),
                                           (1024, 26), (2048, 64)])
def test_ranged_mel_sum_matches_dense_product(n_fft, filters):
    """Each filter summed over its nonzero bins only, in bin order."""
    fb_t = bases.mel_filterbank_np(filters, n_fft, 16000).T.copy()
    ranges = fft_tables.mel_ranges(fb_t)
    assert ranges.dtype == np.int32 and ranges.shape == (filters, 2)
    for m, (lo, hi) in enumerate(ranges):
        assert not fb_t[:lo, m].any() and not fb_t[hi:, m].any()
        assert lo == hi or (fb_t[lo, m] != 0 and fb_t[hi - 1, m] != 0)
    rng = np.random.default_rng(filters)
    power = rng.uniform(0, 1e9, (17, n_fft // 2 + 1)).astype(np.float32)
    got = np.zeros((17, filters), np.float32)
    for m, (lo, hi) in enumerate(ranges):
        for k in range(lo, hi):
            got[:, m] += power[:, k] * fb_t[k, m]
    want = torch.from_numpy(power) @ torch.from_numpy(fb_t)
    assert _nmse(got, want) <= 1e-12
    assert np.array_equal(fft_tables.mel_ranges(np.zeros((9, 2)))[1], [0, 0])


@pytest.mark.parametrize("frame,hop", [(320, 160), (322, 161), (128, 64)])
def test_emulated_acf_matches_plain_pitch(frame, hop):
    """The power-of-two-N ACF (two emulated FFTs) against the plain K2's
    dense 128-rounded bases: the kernel's gates."""
    pipe = FeaturePipeline(FeatureConfig(frame_size=frame, hop_size=hop,
                                         n_fft=max(512, frame)), device="cpu")
    lag_min, lag_max = 40, min(frame - 1, 320)
    merged, nyq_b, inv_live, inv_nyq = pipe._acf_bases(lag_max)
    rng = np.random.default_rng(frame)
    n = 3000
    t = np.arange((n + 1) * hop) / 16000
    sig = (rng.normal(0, 1000, t.size)
           + 3000 * np.sin(2 * np.pi * 130 * t) * (np.sin(2 * np.pi * t) > 0))
    rows = torch.from_numpy(sig.astype(np.float32)).reshape(n + 1, hop)
    pf0, pconf = vk.view_pitch_plain(
        rows, merged=merged, nyq_b=nyq_b, inv_live=inv_live, inv_nyq=inv_nyq,
        lag_min=lag_min, lag_max=lag_max, sample_rate=16000)
    n_fft = fft_tables.acf_fft_size(frame, lag_max + 1)
    frames = torch.cat([rows[:-1], rows[1:]], dim=1)
    acf = acf_emulated(frames, n_fft, lag_max + 1)
    f0, conf = vk.band_peak_pick(acf, lag_min, lag_max, 16000)
    assert _nmse(conf, pconf) <= 1e-9
    assert (f0 == pf0).float().mean().item() >= 0.999


def test_device_twiddles_are_cached_per_size_and_device():
    a = fft_tables.device_twiddles(512, torch.device("cpu"))
    assert a is fft_tables.device_twiddles(512, torch.device("cpu"))
    assert np.array_equal(a.numpy(), fft_tables.twiddle_table(512))
