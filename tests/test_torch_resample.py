#!/usr/bin/env python3
"""The port's device resampler (``sspv_tpu_torch.ops.resample``) against
SciPy's ``resample_poly`` (the call the host path makes) and against the
JAX package's resampler: the cases of ``tests/test_resample.py``, on CPU
tensors (``device="cpu"``; the default is the card).

Gates: the host-built polyphase weights EQUAL to the JAX package's; the
float path within 0.05 absolute on int16-scale data and NMSE <= 1e-10 of
SciPy's; the int16
wrapper >= 99.9 % of samples equal to the host path and none further than
one LSB (float32 sums in another order can cross a truncation boundary).
"""

import functools
import math

import numpy as np
import pytest
import torch

from sspv_tpu.ops import resample as jres
from sspv_tpu_torch.config import Config as TConfig
from sspv_tpu_torch.ops import resample as tres
from sspv_tpu_torch.runtime.audio_source import _resample_to

RATE_PAIRS = [
    (8000, 16000),
    (11025, 16000),
    (22050, 16000),
    (44100, 16000),
    (48000, 16000),
    (16000, 8000),
    (16000, 44100),
]


def _ratio(src, dst):
    g = math.gcd(src, dst)
    return dst // g, src // g


def _resample_to_scipy(arr, src_sr, dst_sr):
    from scipy.signal import resample_poly

    up, down = _ratio(src_sr, dst_sr)
    y = resample_poly(arr.astype(np.float32), up, down)
    return np.clip(y, -32768.0, 32767.0).astype(np.int16)


@pytest.mark.parametrize("src,dst", RATE_PAIRS)
def test_polyphase_weights_equal_jax(src, dst):
    up, down = _ratio(src, dst)
    got = tres._polyphase_kernel(up, down)
    want = jres._polyphase_kernel(up, down)
    assert got[0].dtype == want[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert tres.resample_output_len(12345, dst, src) == \
        jres.resample_output_len(12345, dst, src)


@pytest.mark.parametrize("src,dst", RATE_PAIRS)
@pytest.mark.parametrize("n", [1, 7, 317, 4096, 40000])
def test_float_parity_vs_scipy(src, dst, n):
    from scipy.signal import resample_poly

    rng = np.random.default_rng(n * 31 + src % 97)
    x = rng.normal(0, 3000, n).astype(np.float32)
    up, down = _ratio(src, dst)
    ref = resample_poly(x, up, down)
    out = tres.resample_poly_device(x, up, down, device="cpu")
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    out = out.numpy()
    assert out.shape == ref.shape == (tres.resample_output_len(n, up, down),)
    # float32 products vs SciPy's float32 FIR: rounding-level differences
    # only, on +-32768-scale data
    np.testing.assert_allclose(out, ref, atol=0.05, rtol=0)
    denom = float(np.sum(ref.astype(np.float64) ** 2)) or 1.0
    nmse = float(np.sum((out.astype(np.float64) - ref) ** 2)) / denom
    assert nmse <= 1e-10, nmse
    if n == 4096:
        want = np.asarray(jres.resample_poly_device(x, up, down))
        np.testing.assert_allclose(out, want, atol=0.05, rtol=0)


def test_unreduced_ratio_and_identity():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1000, 500).astype(np.float32)
    a = tres.resample_poly_device(x, 32000, 16000, device="cpu")
    b = tres.resample_poly_device(x, 2, 1, device="cpu")
    assert torch.equal(a, b)
    ident = tres.resample_poly_device(x, 3, 3, device="cpu")
    np.testing.assert_array_equal(ident.numpy(), x)
    assert tuple(tres.resample_poly_device(x[:0], 2, 1, device="cpu").shape) == (0,)
    # a tensor runs on its own device, whatever `device` says
    t = tres.resample_poly_device(torch.from_numpy(x), 2, 1, device="meta")
    assert t.device.type == "cpu" and torch.equal(t, b)


def test_row_block_invariance():
    """Blocks of output rows split only the row axis: bit-identical."""
    rng = np.random.default_rng(9)
    x = rng.normal(0, 3000, 50000).astype(np.float32)
    big = tres.resample_poly_device(x, 160, 441, row_block=1 << 20, device="cpu")
    small = tres.resample_poly_device(x, 160, 441, row_block=64, device="cpu")
    auto = tres.resample_poly_device(x, 160, 441, device="cpu")
    assert torch.equal(big, small) and torch.equal(big, auto)


def test_exact_length_equals_a_padded_run():
    """The signal runs at its exact length whatever `bucket` says, and zero
    padding (SciPy's constant-zero extension) changes no kept sample: what
    the JAX package's length grid relied on."""
    rng = np.random.default_rng(21)
    for n in (4097, 30000):
        x = rng.normal(0, 8000, n).clip(-32768, 32767).astype(np.int16)
        for src, dst in ((22050, 16000), (48000, 16000), (8000, 16000)):
            a = tres.resample_to_rate_device(x, src, dst, device="cpu")
            b = tres.resample_to_rate_device(x, src, dst, bucket=False,
                                             device="cpu")
            np.testing.assert_array_equal(a, b)
            keep = tres.resample_output_len(n, *_ratio(src, dst))
            assert a.shape == (keep,)
            padded = tres.resample_to_rate_device(
                np.pad(x, (0, 5000)), src, dst, device="cpu")
            np.testing.assert_array_equal(padded[:keep], a)
            # and the JAX package's device resampler gives these samples
            want = jres.resample_to_rate_device(x, src, dst)
            diff = np.abs(a.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("src,dst", RATE_PAIRS)
def test_int16_wrapper_parity(src, dst):
    rng = np.random.default_rng(3)
    x = (rng.normal(0, 8000, 30000)).clip(-32768, 32767).astype(np.int16)
    ref = _resample_to(x, src, dst)
    np.testing.assert_array_equal(ref, _resample_to_scipy(x, src, dst))
    out = tres.resample_to_rate_device(x, src, dst, device="cpu")
    assert out.dtype == np.int16 and out.shape == ref.shape
    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1, (src, dst, diff.max())
    assert float((diff > 0).mean()) < 1e-3, (src, dst)


def test_int16_wrapper_identity_and_clipping():
    x = np.array([32767, -32768, 0, 5], np.int16)
    np.testing.assert_array_equal(
        tres.resample_to_rate_device(x, 16000, 16000, device="cpu"), x)
    # a full-scale square wave overshoots the int16 range: clipped, not wrapped
    sq = np.where(np.arange(4000) % 40 < 20, 32767, -32768).astype(np.int16)
    out = tres.resample_to_rate_device(sq, 8000, 16000, device="cpu")
    np.testing.assert_array_equal(out, _resample_to_scipy(sq, 8000, 16000))
    assert out.max() == 32767 and out.min() == -32768


def test_batch_matches_per_row_and_masking():
    rng = np.random.default_rng(11)
    up, down = _ratio(22050, 16000)
    batch = rng.normal(0, 3000, (4, 6000)).astype(np.float32)
    out = tres.resample_batch_device(batch, up, down, device="cpu").numpy()
    for i in range(batch.shape[0]):
        row = tres.resample_poly_device(batch[i], up, down, device="cpu")
        np.testing.assert_allclose(out[i], row.numpy(), atol=0.05, rtol=0)
    # Zero-padded rows: the first resample_output_len(l) samples equal the
    # unpadded row's resample (zero extension == constant-0 padtype).
    true_len = 3210
    padded = batch[0].copy()
    padded[true_len:] = 0.0
    out_pad = tres.resample_poly_device(padded, up, down, device="cpu").numpy()
    out_true = tres.resample_poly_device(batch[0][:true_len], up, down,
                                         device="cpu").numpy()
    keep = tres.resample_output_len(true_len, up, down)
    np.testing.assert_allclose(out_pad[:keep], out_true, atol=0.05, rtol=0)
    assert tuple(tres.resample_batch_device(
        batch[:, :0], up, down, device="cpu").shape) == (4, 0)
    same = tres.resample_batch_device(batch, 5, 5, device="cpu")
    np.testing.assert_array_equal(same.numpy(), batch)


def test_config_knob_routes_long_arrays_to_device(monkeypatch):
    """TPU_DEVICE_RESAMPLE routes whole-file arrays through the device
    resampler (counted by CALLS) and leaves short chunks on host SciPy."""
    calls = []
    real = functools.partial(tres.resample_to_rate_device, device="cpu")

    def spy(arr, src, dst):
        calls.append(arr.shape)
        return real(arr, src, dst)

    monkeypatch.setattr(tres, "resample_to_rate_device", spy)
    monkeypatch.setattr(TConfig, "TPU_DEVICE_RESAMPLE", True)
    monkeypatch.setattr(TConfig, "TPU_DEVICE_RESAMPLE_MIN_SECONDS", 1.0)
    rng = np.random.default_rng(7)
    long_arr = rng.normal(0, 5000, 22050 * 2).astype(np.int16)
    before = tres.CALLS["resample"]
    out = _resample_to(long_arr, 22050, 16000)
    assert calls == [long_arr.shape] and tres.CALLS["resample"] == before + 1
    ref = _resample_to_scipy(long_arr, 22050, 16000)
    assert np.abs(out.astype(np.int32) - ref.astype(np.int32)).max() <= 1

    short = long_arr[:1000]
    _resample_to(short, 22050, 16000)
    assert calls == [long_arr.shape]  # short chunk stayed on host
    assert tres.CALLS["resample"] == before + 1
    monkeypatch.setattr(TConfig, "TPU_DEVICE_RESAMPLE", False)
    np.testing.assert_array_equal(_resample_to(long_arr, 22050, 16000), ref)
    assert calls == [long_arr.shape]


def test_device_failure_propagates(monkeypatch):
    """No fallback to the host: what the device call raises comes out of
    _resample_to, and an unreadable knob raises too."""
    def broken(arr, src, dst):
        raise RuntimeError("device resample failed")

    monkeypatch.setattr(tres, "resample_to_rate_device", broken)
    monkeypatch.setattr(TConfig, "TPU_DEVICE_RESAMPLE", True)
    x = np.ones(40000, np.int16)
    with pytest.raises(RuntimeError, match="device resample failed"):
        _resample_to(x, 22050, 16000)
    monkeypatch.setattr(TConfig, "TPU_DEVICE_RESAMPLE_MIN_SECONDS", "50ms")
    with pytest.raises(ValueError):
        _resample_to(x, 22050, 16000)


def test_file_source_resamples_on_the_device(tmp_path, monkeypatch):
    """FileAudioSource with a target rate: the whole decoded file goes
    through the device resampler when the knob is set."""
    import wave

    from sspv_tpu_torch.runtime.audio_source import FileAudioSource

    rng = np.random.default_rng(2)
    pcm = rng.normal(0, 6000, 48000 * 2).clip(-32768, 32767).astype(np.int16)
    path = tmp_path / "a.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(48000)
        w.writeframes(pcm.tobytes())

    def read_all():
        src = FileAudioSource(str(path), sample_rate=16000)
        src.open()
        out = src.read(1 << 30)
        src.close()
        return out

    host = read_all()
    monkeypatch.setattr(TConfig, "TPU_DEVICE_RESAMPLE", True)
    monkeypatch.setattr(
        tres, "resample_to_rate_device",
        functools.partial(tres.resample_to_rate_device, device="cpu"))
    before = tres.CALLS["resample"]
    dev = read_all()
    assert tres.CALLS["resample"] == before + 1
    assert dev.shape == host.shape == (32000,)
    diff = np.abs(dev.astype(np.int32) - host.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_validation_errors():
    with pytest.raises(ValueError):
        tres.resample_poly_device(np.zeros(10, np.float32), 0, 3, device="cpu")
    with pytest.raises(ValueError):
        tres.resample_poly_device(np.zeros((2, 10), np.float32), 2, 1,
                                  device="cpu")
    with pytest.raises(ValueError):
        tres.resample_batch_device(np.zeros(10, np.float32), 2, 1, device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises((AssertionError, RuntimeError)):
            tres.resample_poly_device(np.zeros(10, np.float32), 2, 1)


# -- rows at their own lengths, float64 sums (K5's plain version) ----------

ROW_RATIOS = [(48000, 16000), (44100, 16000), (8000, 16000)]


def _rows_at(src: int, seed: int, n: int):
    """Five seeded int16 rows of ``n`` samples, zero past unequal lengths:
    whole, one that ``down`` does not divide, a third, one shorter than the
    filter and an empty one."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 9000, (5, n)).clip(-32768, 32767).astype(np.int16)
    lengths = np.array([n, n - 1 if n % 3 == 1 else n - 2, n // 3 + 1, 17, 0])
    x[np.arange(n)[None, :] >= lengths[:, None]] = 0
    return x, lengths


def _upfirdn_rows(x, lengths, src, dst):
    """Each row's own samples through a float64 ``upfirdn`` of the float32
    taps ``resample_poly`` designs, cut to its output length, clipped and
    truncated."""
    from scipy.signal import upfirdn

    up, down = _ratio(src, dst)
    h, n_pre_pad, n_pre_remove = tres._filter(up, down)
    hp = np.concatenate([np.zeros(n_pre_pad), h.astype(np.float64)])
    out = np.zeros((len(x), tres.resample_output_len(x.shape[1], up, down)),
                   np.int16)
    for b, n in enumerate(lengths):
        own = tres.resample_output_len(int(n), up, down)
        if n:
            y = upfirdn(hp, x[b, :n].astype(np.float64), up, down)
            out[b, :own] = np.clip(y[n_pre_remove : n_pre_remove + own],
                                   -32768, 32767).astype(np.int16)
    return out


@pytest.mark.parametrize("src,dst", ROW_RATIOS)
@pytest.mark.parametrize("n", [480, 4801])
def test_rows_plain_version_is_upfirdn_in_float64(src, dst, n):
    up, down = _ratio(src, dst)
    for seed in range(2):
        x, lengths = _rows_at(src, seed + n, n)
        got = tres.resample_rows_int16(torch.from_numpy(x), lengths, up, down)
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(),
                                      _upfirdn_rows(x, lengths, src, dst))
        # the same through the plain version with the lengths on the device
        again = tres.plain_resample_rows_int16(
            torch.from_numpy(x), torch.from_numpy(lengths.astype(np.int32)),
            up, down)
        assert torch.equal(got, again)


def test_rows_ignore_samples_past_their_lengths():
    """What lies past a row's length (here not zero) changes nothing."""
    x, lengths = _rows_at(48000, 4, 3000)
    noisy = x.copy()
    noisy[np.arange(3000)[None, :] >= lengths[:, None]] = 1234
    a = tres.resample_rows_int16(torch.from_numpy(x), lengths, 1, 3)
    b = tres.resample_rows_int16(torch.from_numpy(noisy), lengths, 1, 3)
    assert torch.equal(a, b)
    # the unreduced ratio is the same call
    assert torch.equal(a, tres.resample_rows_int16(torch.from_numpy(x),
                                                   lengths, 16000, 48000))


def test_rows_validation():
    x = torch.zeros((2, 300), dtype=torch.int16)
    for args in ((x.float(), [300, 300], 1, 3), (x[0], [300], 1, 3),
                 (x, [300, 301], 1, 3), (x, [300, -1], 1, 3),
                 (x, [300], 1, 3), (x, [300, 300], 3, 3),
                 (x, [300, 300], 0, 3)):
        with pytest.raises(ValueError):
            tres.resample_rows_int16(*args)
    with pytest.raises(ValueError):
        tres.resample_rows_int16(x.to("meta"), [300, 300], 1, 3)
    assert tuple(tres.resample_rows_int16(x[:, :0], [0, 0], 1, 3).shape) == (2, 0)


@pytest.mark.parametrize("src,dst", ROW_RATIOS + [(22050, 16000)])
def test_benchmark_reference_taps_are_the_ports(src, dst):
    """``portbench/reference/resample.py`` designs the same float32 taps
    (``np.array_equal``) as the port's filter, whose polyphase matrix they
    fill, and resamples a row to the same int16 samples."""
    from portbench.reference import resample as ref

    up, down = ref.ratio(src, dst)
    assert (up, down) == _ratio(src, dst)
    h, n_pre_pad, _ = tres._filter(up, down)
    assert np.array_equal(ref.taps(up, down), h)
    weights, s_lo, _ = tres._polyphase_kernel(up, down)
    t = np.arange(weights.shape[0])[:, None]
    idx = np.arange(up)[None, :] * down - (s_lo + t) * up - n_pre_pad
    live = (idx >= 0) & (idx < len(h))
    assert np.array_equal(weights[live], ref.taps(up, down)[idx[live]])
    assert not weights[~live].any()
    x, lengths = _rows_at(src, 8, 2000)
    got = tres.resample_rows_int16(torch.from_numpy(x), lengths, up, down)
    for b, n in enumerate(lengths):
        want = ref.resample(torch.from_numpy(x[b, :n]), src, dst)
        assert torch.equal(got[b, : want.shape[0]], want)
