"""The check that decides ``correct``, driven end to end on the CPU at a
small size: sound runs of every cell come out correct; the control (the
reference one precision below, in the program's place) and runs with the
measured path broken underneath come out not correct. The card's look is
skipped: ``run_cell`` runs on the port's plain versions here."""

import time

import pytest

from portbench.harness.core import run_cell
from portbench.tools.control import readings

# The serve cell is not in the benchmark (its p95 spreads too widely on the
# card, see PERF.md); its driver is kept, and checked here.
SERVE = {"name": "sspv.serve.clips", "config": "sspv-default",
         "traffic": "serve.clips", "chips": 1, "why": "-",
         "checks": {"features_nmse": 1e-9, "vad_mismatch": 0.0}}
SMALL = {
    "sspv.longform.resident": {"pool": 3, "min_s": 2, "max_s": 6,
                               "sample": 2},
    "whisper.segments30s.resident": {"pool": 2, "rows": 4, "segment_s": 3.0,
                                     "short_per_batch": 1,
                                     "short_min_s": 0.5, "short_max_s": 3.0,
                                     "sample": 2},
    "sspv.serve.clips": {"pool": 8, "median_s": 2.0, "max_s": 6.0,
                         "rate_per_s": 5.0, "grace_s": 30, "warm": 2,
                         "sample": 4},
    "sspv.engine.live": {"streams": 3, "warm_s": 1.0, "grace_s": 5.0,
                         "max_window_s": 3.0, "sample": 2},
}
SECONDS = 2.0
SEED = 2147483647 + 12345  # past 32 signed bits, as the driver's are


def _cell(name):
    return SERVE if name == SERVE["name"] else name


def _run(cell, seed=SEED):
    return run_cell(_cell(cell), seed, SECONDS, False, time.monotonic(),
                    device="cpu", overrides=SMALL[cell], log=lambda s: None)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    # every end-to-end metric of the cell, none of them 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    assert all(m["value"] > 0 for m in out["metrics"].values()), out["metrics"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails(cell):
    for seed in (SEED, 7, 2**31 + 5):
        got = readings(_cell(cell), seed, SECONDS, "cpu", SMALL[cell])
        assert got["control_fails"], got


def _altered(fn):
    def wrapper(*a, **kw):
        out = dict(fn(*a, **kw))
        out["energy"] = out["energy"] * 1.001
        return out
    return wrapper


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_an_altered_answer_fails(cell, monkeypatch):
    from sspv_tpu_torch.ops import pipeline

    monkeypatch.setattr(pipeline, "fused_view_features",
                        _altered(pipeline.fused_view_features))
    monkeypatch.setattr(pipeline, "fused_features",
                        _altered(pipeline.fused_features))
    assert not _run(cell)["correct"]


def test_an_altered_pitch_fails(monkeypatch):
    from sspv_tpu_torch.parallel import mesh

    real = mesh.fused_view_pitch

    def shifted(*a, **kw):
        f0, conf = real(*a, **kw)
        return f0 * 0.5, conf
    monkeypatch.setattr(mesh, "fused_view_pitch", shifted)
    assert not _run("sspv.longform.resident")["correct"]


def test_a_state_left_unchanged_fails(monkeypatch):
    from sspv_tpu_torch.ops.pipeline import FeaturePipeline

    real = FeaturePipeline.process_signal_packed

    def stale(self, samples, packed_state, *a, **kw):
        block, _ = real(self, samples, packed_state, *a, **kw)
        return block, packed_state
    monkeypatch.setattr(FeaturePipeline, "process_signal_packed", stale)
    assert not _run("sspv.engine.live")["correct"]


def test_half_the_batch_left_out_fails(monkeypatch):
    import torch
    from sspv_tpu_torch.parallel import BatchPipeline

    real = BatchPipeline.process_batch_masked

    def half(self, signals, lengths, states=None):
        block, st = real(self, signals, lengths, states)
        keep = signals.shape[0] // 2
        return type(block)(*(torch.cat([t[:keep], torch.zeros_like(t[keep:])])
                             for t in block)), st
    monkeypatch.setattr(BatchPipeline, "process_batch_masked", half)
    assert not _run("whisper.segments30s.resident")["correct"]


def test_sweep_steps_the_load(capsys):
    import json

    from portbench.tools import sweep

    sweep.main(["--workload", "sspv.engine.live", "--param", "streams",
                "--values", "1,2", "--seconds", "1.5", "--device", "cpu",
                "--overrides", json.dumps({**SMALL["sspv.engine.live"],
                                           "sample": 1})])
    steps = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [s["streams"] for s in steps] == [1.0, 2.0]
    assert all(s["failed"] == 0 and s["n"] > 0 for s in steps)
