"""The roofline work counts against counts made by hand, and against the
function bound of the tool they were copied from."""

import math

import pytest

from portbench.harness.core import load
from portbench.yardstick.work import (bound_s, frames_features, rfft_ops,
                                      view_features, view_pitch)

HOUR = 3600 * 16000
SSPV = load("configs", "sspv-default")["feature_config"]
WHISPER = load("configs", "whisper-frontend")["feature_config"]


def test_rfft_ops():
    assert rfft_ops(512) == 2.5 * 512 * 9
    assert rfft_ops(400) == pytest.approx(2.5 * 400 * math.log2(400))


def test_view_features_hour():
    n = 1 + (HOUR - 320) // 160  # 359,999 frames
    # FFT 11,520; window, energy, signs 960; power 3*257, mel 2*459 nonzero
    # weights, log 26, DCT 2*26*13, lifter 13, entropy 5*257
    per_frame = 11520 + 960 + 771 + 918 + 26 + 676 + 13 + 1285
    ops, nbytes = view_features(SSPV, {"samples": HOUR})
    assert ops == n * per_frame
    # the float32 rows view, the constants (window 320, filterbank 257*26,
    # DCT 26*13, lifter 13), 16 float32 outputs a frame
    assert nbytes == 4 * (n + 1) * 160 + 4 * (320 + 257 * 26 + 26 * 13 + 13) \
        + n * 64
    ms = 1e3 * bound_s(ops, nbytes)[0]
    assert bound_s(ops, nbytes)[1] == "operations"
    assert ms == pytest.approx(0.087, abs=0.001)  # PERF.md's K1 bound


def test_view_pitch_hour():
    n = 1 + (HOUR - 320) // 160
    # lags 40..319; the least transform is 320 + 319 rounded up to 640
    per_frame = 2 * rfft_ops(640) + 3 * 321 + 3 * 320
    ops, nbytes = view_pitch(SSPV, {"samples": HOUR})
    assert ops == pytest.approx(n * per_frame)
    assert nbytes == 4 * (n + 1) * 160 + 8 * n
    assert 1e3 * bound_s(ops, nbytes)[0] == pytest.approx(0.171, abs=0.001)


def test_frames_features_batch():
    rows, samples = 32, 480000
    n = 1 + (samples - 400) // 160  # 2,998 frames a row
    per_frame = rfft_ops(400) + 1200 + 3 * 201 + 2 * 322 + 80 + 2 * 80 * 13 \
        + 13 + 5 * 201
    ops, nbytes = frames_features(WHISPER, {"rows": rows, "samples": samples})
    assert ops == pytest.approx(rows * n * per_frame)
    # the int16 signals, not the gathered frames
    assert nbytes == 2 * rows * samples + 4 * (400 + 201 * 80 + 80 * 13 + 13) \
        + rows * n * 64


def test_matches_the_tools_function_bound():
    from sspv_tpu_torch.ops.pipeline import FeatureConfig
    from sspv_tpu_torch.tools.roofline import kernel_bound

    n = 1 + (HOUR - 320) // 160
    for kernel, fn in (("view_features", view_features),
                       ("view_pitch", view_pitch)):
        tool = kernel_bound(kernel, FeatureConfig(), n)
        ops, _ = fn(SSPV, {"samples": HOUR})
        assert ops == pytest.approx(tool["ops"]), kernel
