"""The trace reader on a recorded event list."""

import pytest

from portbench.readers import counter_ratio, idle, kernel_roofline, measured
from portbench.yardstick.trace import read_trace


def _x(cat, name, ts, dur, **kw):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, **kw}


EVENTS = [
    _x("user_annotation", "ProfilerStep#0", 0, 900),
    _x("user_annotation", "ProfilerStep#1", 1000, 1000),
    _x("kernel", "view_features_fft_kernel", 900, 50),       # before: out
    _x("kernel", "view_features_fft_kernel", 1100, 200),
    _x("kernel", "vad_gates_kernel", 1250, 150),              # overlaps
    _x("gpu_memcpy", "Memcpy HtoD", 1500, 100),
    _x("kernel", "view_pitch_kernel", 1900, 200),             # cut at 2000
    _x("gpu_user_annotation", "ProfilerStep#1", 1000, 1000),  # not work
    _x("cpu_op", "aten::copy_", 1580, 400),
    _x("cpu_op", "aten::to", 1550, 440),
    _x("cuda_runtime", "cudaLaunchKernel", 1095, 5),
    _x("cuda_runtime", "cudaLaunchKernel", 1245, 5),
    _x("cuda_runtime", "cudaLaunchKernel", 1895, 5),
]


def test_read_trace():
    t = read_trace(EVENTS)
    assert t["window_s"] == pytest.approx(1000e-6)
    # union: [1100, 1400] + [1500, 1600] + [1900, 2000]
    assert t["busy_s"] == pytest.approx(500e-6)
    assert t["kernel_s"] == pytest.approx({
        "view_features_fft_kernel": 200e-6, "vad_gates_kernel": 150e-6,
        "Memcpy HtoD": 100e-6, "view_pitch_kernel": 100e-6})
    assert t["device_ops"][0] == ["view_features_fft_kernel",
                                  pytest.approx(200e-6)]
    # gaps: [1600, 1900] under aten::copy_ (innermost at 1600), then
    # [1000, 1100] and [1400, 1500]
    assert t["idle_gaps"][0] == ["aten::copy_", pytest.approx(300e-6)]
    assert sorted(g for _, g in t["idle_gaps"]) == pytest.approx(
        [100e-6, 100e-6, 300e-6])
    assert t["kernels_recorded"] == t["kernels_launched"] == 3


def test_no_window_or_no_device_event():
    assert read_trace([e for e in EVENTS if e["cat"] != "user_annotation"]) \
        is None
    assert read_trace([e for e in EVENTS if e["cat"] in
                       ("user_annotation", "cpu_op")]) is None


def test_readers():
    t = read_trace(EVENTS)
    ctx = {"trace": t, "calls": [{"samples": 16000}],
           "counters": {"a": 3.0, "b": 2, "z": 0},
           "measured": {"lag_ms": 4.5},
           "cfg": {"sample_rate": 16000, "frame_size": 320, "hop_size": 160,
                   "window_type": "hamming", "n_fft": 512,
                   "entropy_n_fft": 512, "num_filters": 26, "num_ceps": 13}}
    assert idle.read(ctx) == pytest.approx(50.0)
    assert counter_ratio.read(ctx, "a", "b", 1000.0) == pytest.approx(1500.0)
    assert counter_ratio.read(ctx, "a", "z") is None
    assert measured.read(ctx, "lag_ms") == 4.5
    assert measured.read(ctx, "no_such_number") is None
    from portbench.yardstick.work import bound_s, view_features

    want = 100 * bound_s(*view_features(ctx["cfg"], {"samples": 16000}))[0] \
        / 200e-6
    assert kernel_roofline.read(ctx, ["view_features_fft"], "view_features") \
        == pytest.approx(want)
    assert kernel_roofline.read(ctx, ["no_such_kernel"], "view_features") is None
    assert kernel_roofline.read({**ctx, "trace": None}, ["view"],
                                "view_features") is None
