#!/usr/bin/env python3
"""The benchmark's cells ``whisper48k.segments30s.resident`` and
``sspv.longform.host`` on the CPU at a small size (the port's plain
versions; the card's look is skipped): sound runs come out correct and
report their metrics, and the comparison that decides ``correct`` fails
the reference one precision below, an altered answer, and, in the 48 kHz
cell, rows resampled with float32 sums. Also the K5 roofline reader's
arithmetic."""

import time

import pytest
import torch

from portbench.harness.core import cell_metrics, load, run_cell
from portbench.readers import resample_roofline
from portbench.tools.control import readings
from sspv_tpu_torch.ops import resample as tres
from sspv_tpu_torch.parallel import mesh as tmesh

W48 = "whisper48k.segments30s.resident"
HOST = "sspv.longform.host"
SMALL = {
    W48: {"pool": 2, "rows": 4, "segment_s": 2.0, "short_per_batch": 1,
          "short_min_s": 0.5, "short_max_s": 2.0, "sample": 2},
    HOST: {"pool": 3, "min_s": 2, "max_s": 5, "sample": 2},
}
SEED = 2147483647 + 4321  # past 32 signed bits, as the driver's are


def _run(cell, trace=False, seed=SEED):
    return run_cell(cell, seed, 1.5, trace, time.monotonic(), device="cpu",
                    overrides=SMALL[cell], log=lambda s: None)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_run_reports_the_span_metrics(cell):
    out = _run(cell, trace=True)
    assert out["correct"], out["checks"]
    want = {"program.host_ms_per_call", "vad.wrapper_host_us"}
    if cell == W48:
        want.add("resample.wrapper_host_us")
    # no device trace on the CPU: the device metrics say nothing
    assert set(out["metrics"]) == want, out["metrics"]


def test_cells_report_what_the_benchmark_lists():
    _, layers = cell_metrics(load("workloads", W48))
    assert {m["name"] for m in layers} == {
        "idle_pct.offline", "program.host_ms_per_call", "vad.wrapper_host_us",
        "frames_features_roofline", "resample_roofline",
        "resample.wrapper_host_us"}
    ends, layers = cell_metrics(load("workloads", HOST))
    assert {m["name"] for m in ends} == {"audio_s_per_s", "setup_s"}
    assert {m["name"] for m in layers} == {
        "idle_pct.offline", "program.host_ms_per_call", "vad.wrapper_host_us",
        "view_features_roofline", "view_pitch_roofline"}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails(cell):
    for seed in (SEED, 11):
        got = readings(cell, seed, 1.5, "cpu", SMALL[cell])
        assert got["control_fails"], got


def test_float32_sums_fail_the_48k_cell(monkeypatch):
    """Rows resampled with float32 sums (the precision below the
    configuration's) are not correct; float64 sums are."""
    def float32_rows(x, lengths, up, down):
        lens = torch.as_tensor(lengths, dtype=torch.int64)
        pos = torch.arange(x.shape[1])
        xf = torch.where(pos < lens[:, None], x, 0).to(torch.float32)
        y = tres._correlate(xf, up, down).clamp_(-32768.0, 32767.0)
        y = y.to(torch.int16)
        own = -(-lens * up // down)
        return y.masked_fill_(torch.arange(y.shape[1]) >= own[:, None], 0)

    # one batch, checked: the window's first call covers every checked row
    # however slow the host, so a correct run cannot miss a row
    overrides = dict(SMALL[W48], pool=1, rows=32, segment_s=3.0,
                     short_per_batch=4, sample=1)
    monkeypatch.setattr(tmesh, "resample_rows_int16", float32_rows)
    out = run_cell(W48, SEED, 1.0, False, time.monotonic(), device="cpu",
                   overrides=overrides, log=lambda s: None)
    assert not out["correct"], out["checks"]
    monkeypatch.undo()
    out = run_cell(W48, SEED, 1.0, False, time.monotonic(), device="cpu",
                   overrides=overrides, log=lambda s: None)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_an_altered_answer_fails(cell, monkeypatch):
    from sspv_tpu_torch.ops import pipeline

    def altered(fn):
        def wrapper(*a, **kw):
            out = dict(fn(*a, **kw))
            out["energy"] = out["energy"] * 1.001
            return out
        return wrapper

    monkeypatch.setattr(pipeline, "fused_view_features",
                        altered(pipeline.fused_view_features))
    monkeypatch.setattr(pipeline, "fused_features",
                        altered(pipeline.fused_features))
    assert not _run(cell)["correct"]


def test_resample_roofline_reads_the_work_of_the_calls():
    call = {"source_samples": 3 * 480000, "outputs": 480000, "up": 1,
            "down": 3}
    ops, nbytes = resample_roofline.work(call)
    assert nbytes == 2 * (3 * 480000 + 480000)
    assert ops == 2 * 61 * 480000  # 61 nonzero taps at 48 -> 16 kHz
    trace = {"kernel_s": {"(anonymous namespace)::resample_rows_kernel<7>"
                          "(short const*, ...)": 1e-3, "other": 5.0}}
    share = resample_roofline.read(
        {"trace": trace, "calls": [call, {"rows": 1, "samples": 3}]},
        kernels=["resample_rows_kernel"])
    assert share == pytest.approx(100 * nbytes / 3.35e12 / 1e-3)
    assert resample_roofline.read({"trace": None, "calls": [call]},
                                  kernels=["resample_rows_kernel"]) is None
    assert resample_roofline.read({"trace": trace, "calls": [{"samples": 3}]},
                                  kernels=["resample_rows_kernel"]) is None
    assert resample_roofline.read({"trace": trace, "calls": [call]},
                                  kernels=["k9"]) is None
