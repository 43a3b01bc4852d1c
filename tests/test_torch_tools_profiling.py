#!/usr/bin/env python3
"""The port's measuring tools (``time_blocked_vad``, ``vad_microbench``,
``resample_probe``, ``ablate_bench``, ``roofline``) on the CPU at small
sizes, beside the JAX package's pieces they time, and the kernels' bounds
from shapes alone against the figures the smoke run prints."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from sspv_tpu.ops import vad as jvad
from sspv_tpu_torch.ops.pipeline import FeatureConfig
from sspv_tpu_torch.tools import (
    ablate_bench,
    resample_probe,
    roofline,
    time_blocked_vad,
    vad_microbench,
)
from sspv_tpu_torch.utils.synth import synth_signal

import oracle

CPU = torch.device("cpu")


def test_time_blocked_vad_on_the_cpu():
    sig = synth_signal(20.0)
    lines, vads = time_blocked_vad.run(20.0, "cpu", signal=sig)
    assert [x.get("variant") for x in lines] == [
        "full_vad_conv", "full_vad_blocked", None]
    assert lines[0]["vad_routes"] == lines[1]["vad_routes"] == {}  # CPU
    assert lines[-1]["decision_mismatches"] == 0
    assert lines[-1]["frames"] == 1999 and lines[-1]["device"] == "cpu"
    from sspv_tpu_torch.ops.pipeline import FeaturePipeline

    block, _ = FeaturePipeline(device="cpu").process_signal_device(sig)
    want, _ = oracle.EngineVadOracle().run_all(
        block.energy.numpy(), block.zcr.numpy(), block.entropy.numpy())
    for vad in vads.values():
        np.testing.assert_array_equal(vad, want)


def test_time_blocked_vad_main(capsys):
    assert time_blocked_vad.main(["2", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[-1]["decision_mismatches"] == 0
    assert all(x["card"] == "cpu" for x in lines)


def test_vad_microbench_blocked_sums_match_jax():
    """The port's float64 blocked sums of a float32 input against the JAX
    package's float32 ones; every form against the direct sum."""
    f = 1024
    x = vad_microbench.inputs(f, CPU)
    want = np.asarray(jvad._blocked_trailing_sums(jnp.asarray(x["ext"].numpy()),
                                                  f, 256))
    got = vad_microbench.window_sums("blocked", x["ext"], f).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    direct = vad_microbench.window_sums("direct", x["ext"], f).numpy()
    for name in ("blocked", "matmul"):
        np.testing.assert_allclose(
            vad_microbench.window_sums(name, x["ext"], f).numpy(), direct,
            rtol=1e-12)
    np.testing.assert_allclose(
        vad_microbench.window_sums("conv1d", x["ext"], f).numpy(), direct,
        rtol=1e-6)
    with pytest.raises(ValueError):
        vad_microbench.window_sums("reduce_window", x["ext"], f)


def test_vad_microbench_cummax_matches_jax_scan():
    f = 1024
    vadi = vad_microbench.inputs(f, CPU)["vadi"]
    idx = jnp.arange(f, dtype=jnp.int32)
    seeds = jnp.where(jnp.asarray(vadi.numpy()), idx, jnp.int32(-(2**30)))
    want = np.asarray(lax.associative_scan(jnp.maximum, seeds))
    np.testing.assert_array_equal(vad_microbench.cummax(vadi).numpy(), want)


def test_vad_microbench_main(capsys):
    assert vad_microbench.main(["--device", "cpu", "--frames", "1000"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    names = [x.get("variant") for x in lines[:-1]]
    assert names == ["direct", "blocked", "conv1d", "matmul", "cummax",
                     "vad_full_blocked", "vad_full_direct", "kernel"]
    for x in lines[:-1]:
        assert x["F"] == 1024 and x["valid_frames"] == 1000
        assert x["time_us"] is None and x["host_us"] > 0 and x["dtype"]
    assert all(x["launches"] == {} for x in lines[:-1])  # nothing on the CPU
    assert lines[-2]["equal_to_plain"]
    sums = {x["variant"]: x["max_rel_vs_direct"] for x in lines[:4]}
    assert sums["direct"] == 0 and sums["blocked"] <= 1e-12
    assert sums["matmul"] <= 1e-12 and sums["conv1d"] <= 1e-6
    assert set(lines[-1]["not_ported"]) == {"reduce_window"}


@pytest.mark.parametrize("kernel", [False, True])
def test_vad_microbench_full_calls_match_jax(kernel):
    """The timed full VAD calls, the plain ``streaming_vad`` and K4's
    wrapper (its plain version on the CPU): the JAX package's decisions on
    the same random inputs and mask."""
    f = 1024
    x = vad_microbench.inputs(f, CPU, valid_frames=1000)
    for impl in ("blocked", "conv"):
        got = vad_microbench.vad_full(x, impl, kernel=kernel)
        want = jvad.streaming_vad(
            *(jnp.asarray(x[k].numpy()) for k in ("e", "z", "h")),
            jvad.initial_vad_state(), valid=jnp.asarray(x["valid"].numpy()),
            trailing_impl=impl, **vad_microbench.GATES)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_resample_probe_on_the_cpu(capsys):
    assert resample_probe.main(["0.5", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(x["src_sr"], x["dst_sr"]) for x in lines] == resample_probe.RATE_PAIRS
    for x in lines:
        assert x["max_int16_lsb_diff"] <= 1
        assert x["resample_calls"] == 1 + resample_probe.REPS
        assert x["event_ms_median"] is None and x["device"] == "cpu"
        assert "device_first_call_s" in x and "device_compile_s" not in x


def test_ablate_bench_on_the_cpu():
    lines = ablate_bench.run(15.0, "cpu", signal=synth_signal(15.0))
    names = [x.get("variant") for x in lines[:-1]]
    assert names == ["full_shipped", "spectrum_only", "features_no_vad",
                     "features_plus_vad", "full_plain_view",
                     "full_scanblock_16384", "full_scanblock_65536"]
    for x in lines[:-1]:
        assert x["time_s"] > 0 and x["device"] == "cpu"
        if x["variant"].startswith("full_"):
            assert x["nmse_max"] <= 1e-5
    assert set(lines[-1]["not_ported"]) == {
        "spectrum_pair_only", "full_dft_pair", "full_highest", "full_default",
        "full_viewkernel"}
    from sspv_tpu_torch.ops.pipeline import FeaturePipeline

    assert FeaturePipeline.SCAN_BLOCK_FRAMES == 32768  # restored


def test_ablate_bench_main(capsys):
    assert ablate_bench.main(["2", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 8 and "not_ported" in lines[-1]


def test_roofline_programs_on_the_cpu():
    lines = roofline.run(12.0, "cpu", signal=synth_signal(12.0), rounds=1)
    assert [x["program"] for x in lines] == list(roofline.PROGRAMS)
    for x in lines:
        assert x["frames"] == 1199 and x["device"] == "cpu"
        assert x["ms_median"] > 0 and x["event_ms_median"] is None
        assert x["calls"] == roofline.REPS
        assert (x["analytic"] is None) == (x["program"] not in roofline.ANALYTIC)
    analytic = {x["program"]: x["analytic"] for x in lines if x["analytic"]}
    assert analytic["feat_only"] == roofline.kernel_bound(
        "view_features", FeatureConfig(), 1199)
    assert analytic["pitch_kernel_only"]["kernel"] == "view_pitch"
    # the VAD's one call runs over the signal's own 1,199 frames
    assert analytic["vad_only"] == roofline.kernel_bound(
        "vad", FeatureConfig(), 1199)


def test_roofline_programs_compute_the_shipped_outputs():
    """The decomposed programs give the shipped calls' outputs: the
    blocked scans equal the whole-signal calls, the gate equals the
    shipped pitch track."""
    sig = synth_signal(12.0)
    progs = roofline.Programs(sig, CPU)
    p = progs.programs
    full = p["feat_shipped"][0]()[0]
    scan = p["feat_r3_scan"][0]()[0]
    flat = p["feat_shipped_flat"][0]()[0]
    for a, b, c in zip(full, scan, flat):
        assert torch.equal(a, b) and torch.equal(a, c)
    vad_only = p["vad_only"][0]()[0]
    assert torch.equal(vad_only.vad, full.vad)
    shipped = p["pitch_shipped"][0]()
    for a, b in zip(shipped, p["pitch_gate_only"][0]()):
        assert torch.equal(a, b)
    for a, b in zip(p["pitch_kernel_only"][0](), p["pitch_r3_scan"][0]()):
        assert torch.equal(a, b)


def test_roofline_scan_blocks_cover_the_signal(monkeypatch):
    """With blocks shorter than the signal the scans still give the whole
    signal's outputs (the VadState carried across blocks)."""
    monkeypatch.setattr(roofline, "BLOCK_FRAMES", 300)
    progs = roofline.Programs(synth_signal(12.0), CPU)
    p = progs.programs
    for a, b in zip(p["feat_shipped"][0]()[0], p["feat_r3_scan"][0]()[0]):
        assert torch.equal(a, b)
    for a, b in zip(p["pitch_kernel_only"][0](), p["pitch_r3_scan"][0]()):
        assert torch.equal(a, b)


def test_roofline_trace_on_the_cpu(capsys, tmp_path):
    assert roofline.main(["--seconds", "10", "--device", "cpu", "--only",
                          "vad_only", "--rounds", "1", "--trace",
                          "--trace-target", "vad", "--trace-dir",
                          str(tmp_path)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["program"] for x in lines] == ["vad_only", "vad_only"]
    t = lines[-1]
    assert t["trace_target"] == "vad" and t["device"] == "cpu"
    assert t["idle_share"] is None and t["window_ms"] is None
    assert t["idle_share_unprofiled"] is None
    assert t["event_ms_per_call_unprofiled"] is None
    assert t["device_trace"].startswith("not measured")
    assert t["top_device_ops_ms"] == [] and t["top_host_ops_ms"]
    assert t["attempts"] == 1
    assert (tmp_path / "roofline_trace_vad.json").exists()


def test_trace_records_again_while_kernels_are_lost(monkeypatch):
    """A profile that lost a kernel is recorded again; after the last
    attempt the line says what it kept."""
    lost = {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": 0.0, "dur": 1.0}
    kernel = {"ph": "X", "cat": "kernel", "name": "k", "ts": 5.0, "dur": 2.0}
    runs = iter([[lost], [lost], [lost, kernel]])
    monkeypatch.setattr(roofline, "_profile",
                        lambda *a: (next(runs), []))
    fn = lambda: torch.zeros(1)
    t = roofline.trace(fn, lambda out: out[0], "cpu", "vad")
    assert t["attempts"] == 3 and t["device_trace"] == "measured"
    assert t["kernels_recorded"] == t["kernels_launched"] == 1
    monkeypatch.setattr(roofline, "_profile", lambda *a: ([lost], []))
    t = roofline.trace(fn, lambda out: out[0], "cpu", "vad")
    assert t["attempts"] == roofline.TRACE_ATTEMPTS
    assert t["idle_share"] is None and t["kernels_recorded"] == 0


def test_roofline_rejects_an_unknown_program():
    with pytest.raises(SystemExit):
        roofline.main(["--device", "cpu", "--only", "feat_nothing"])
    with pytest.raises(SystemExit):
        roofline.main(["--device", "cpu", "--trace", "--trace-target",
                       "feat,nothing"])


def test_roofline_traces_several_targets(capsys):
    assert roofline.main(["--seconds", "3", "--device", "cpu", "--only",
                          "rows_only", "--rounds", "1", "--trace",
                          "--trace-target", "pitch,vad"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x.get("trace_target") for x in lines] == [None, "pitch", "vad"]
    assert [x["program"] for x in lines] == ["rows_only", "pitch_shipped",
                                             "vad_only"]


def test_read_trace_measures_idle_gaps():
    """Three kernels and a copy on the device; the host ops that were
    running when each gap began."""
    ev = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name,
                                     "ts": ts, "dur": dur}
    events = [
        ev("kernel", "k1", 100.0, 10.0),
        ev("gpu_memcpy", "Memcpy DtoD", 108.0, 4.0),  # overlaps k1
        ev("kernel", "k2", 115.0, 5.0),
        ev("kernel", "k1", 150.0, 10.0),
        ev("cpu_op", "outer", 90.0, 40.0),
        ev("cpu_op", "inner", 111.0, 2.0),
        ev("cuda_runtime", "cudaStreamSynchronize", 119.0, 50.0),
    ]
    r = roofline.read_trace(events, calls=2)
    assert r["window_ms"] == pytest.approx(0.060)
    assert r["device_busy_ms"] == pytest.approx(0.027)
    assert r["idle_share"] == pytest.approx(1 - 27 / 60)
    assert r["kernel_launches_per_call"] == 1.5
    assert r["top_device_ops_ms"][0] == ["k1", pytest.approx(0.020), 2]
    assert [g["gap_ms"] for g in r["longest_gaps"]] == [
        pytest.approx(0.030), pytest.approx(0.003)]
    assert [g["host_op"] for g in r["longest_gaps"]] == [
        "cudaStreamSynchronize", "inner"]
    assert r["kernels_recorded"] == 3 and r["kernels_launched"] == 0
    empty = roofline.read_trace([ev("cpu_op", "x", 0.0, 1.0)], calls=1)
    assert empty["idle_share"] is None and empty["longest_gaps"] == []


def test_read_trace_names_the_program_span_at_each_gap():
    """Each gap also carries the innermost ``sspv.`` span around it (the
    latest-starting one that contains its start): not a PyTorch op, not
    another annotation, null outside the program."""
    ev = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name,
                                     "ts": ts, "dur": dur}
    events = [
        ev("kernel", "k1", 100.0, 10.0),   # gap [110, 130] inside the call
        ev("kernel", "k2", 130.0, 5.0),    # gap [135, 155] in the gate
        ev("kernel", "k3", 155.0, 5.0),    # gap [160, 200] outside
        ev("kernel", "k4", 200.0, 1.0),
        ev("user_annotation", "ProfilerStep#1", 0.0, 300.0),
        ev("user_annotation", "sspv.mesh.process_long_pitch", 90.0, 68.0),
        ev("user_annotation", "sspv.mesh.gate", 132.0, 24.0),
        ev("user_annotation", "someone.else", 111.0, 100.0),
        ev("cpu_op", "aten::where", 134.0, 2.0),
        ev("cpu_op", "aten::cat", 165.0, 10.0),
    ]
    r = roofline.read_trace(events, calls=1)
    assert [g["gap_ms"] for g in r["longest_gaps"]] == [
        pytest.approx(0.040), pytest.approx(0.020), pytest.approx(0.020)]
    by_start = sorted(r["longest_gaps"], key=lambda g: g["at_ms"])
    assert [g["program_span"] for g in by_start] == [
        "sspv.mesh.process_long_pitch", "sspv.mesh.gate", None]
    assert [g["host_op"] for g in by_start] == [None, "aten::where", None]


def test_read_trace_refuses_a_trace_that_lost_kernels():
    """Four launches on the host, three kernels on the device: the
    profiler dropped one, so no device figure is given."""
    ev = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name,
                                     "ts": ts, "dur": dur}
    events = [ev("cuda_runtime", "cudaLaunchKernel", 10.0 * i, 2.0)
              for i in range(4)]
    events += [ev("kernel", "k", 100.0 + 10 * i, 5.0) for i in range(3)]
    r = roofline.read_trace(events, calls=1)
    assert (r["kernels_recorded"], r["kernels_launched"]) == (3, 4)
    assert r["idle_share"] is None and r["window_ms"] is None
    assert r["top_device_ops_ms"] == [] and r["longest_gaps"] == []
    events.append(ev("kernel", "k", 140.0, 5.0))
    assert roofline.read_trace(events, calls=1)["idle_share"] == pytest.approx(
        1 - 20 / 45)


# PERF.md's bounds at the hour (ms, what bounds it; design bound, what
# bounds it), as chip_smoke.py printed them on an H100.
HOUR_BOUNDS = {
    "view_features": ((0.087, "operations"), (0.295, "shared memory")),
    "view_pitch": ((0.171, "operations"), (1.020, "shared memory")),
    "frame_features": ((0.179, "bytes"), (0.295, "shared memory")),
    "vad": ((0.002, "bytes"), (0.002, "bytes")),
}
HOUR_FRAMES = {"frame_features": 359_998}


@pytest.mark.parametrize("kernel", sorted(HOUR_BOUNDS))
def test_kernel_bound_gives_the_hours_figures(kernel):
    cfg = (FeatureConfig(frame_size=400, hop_size=160)
           if kernel == "frame_features" else FeatureConfig())
    frames = HOUR_FRAMES.get(kernel, 359_999)
    b = roofline.kernel_bound(kernel, cfg, frames)
    (ms, by), (design, design_by) = HOUR_BOUNDS[kernel]
    assert round(b["bound_ms"], 3) == ms and b["bound_by"] == by
    assert round(b["design_bound_ms"], 3) == design
    assert b["design_bound_by"] == design_by
    assert b["design_bound_ms"] >= b["bound_ms"]


def test_kernel_bound_takes_no_unknown_kernel():
    with pytest.raises(ValueError):
        roofline.kernel_bound("view_nothing", FeatureConfig(), 10)


def test_kernel_bound_of_the_vad_counts_bytes_and_float64_sums():
    """K4's bound: 20 bytes a frame (e, z, h in, two int32 decisions out)
    plus the state. Its design with the blocked sums: three float64 adds a
    frame and stream (one of each block scan, their sum) and 44 bytes of
    shared memory a frame and stream, so the bytes bound it too; with the
    direct sums: 256 adds a frame and stream, and the staged reads (4
    windows a thread share them) bound it."""
    b = roofline.kernel_bound("vad", FeatureConfig(), 1000)
    assert b["bytes"] == 1000 * 20 + 2 * (2 * 4 * 256 + 8)
    assert b["design_ops"] == 1000 * (2 * (3 + 4) + 1)
    assert b["smem_bytes"] == 1000 * 2 * 44
    assert b["bound_ms"] == pytest.approx(1e3 * b["bytes"] / 3.35e12)
    assert b["design_bound_ms"] == b["bound_ms"]
    d = roofline.kernel_bound("vad", FeatureConfig(), 1000, blocked=False)
    assert d["bytes"] == b["bytes"] and d["ops"] == b["ops"]
    assert d["design_ops"] >= 1000 * 2 * 256 > d["ops"]
    assert d["smem_bytes"] == 1000 * 2 * (4 + 259 + 16)
    assert d["design_bound_ms"] == pytest.approx(
        1e3 * d["smem_bytes"] / roofline.SMEM_BYTES_PER_S)
