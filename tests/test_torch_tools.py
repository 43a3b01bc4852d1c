#!/usr/bin/env python3
"""The port's tools (``sspv_tpu_torch.tools``) beside the JAX package's
originals in ``tools/``: the soak report and stitcher are NumPy-free copies
that differ only in the package name and the ``cuda_mb=`` field (held so
here, and held to the originals' numbers on the logs of
``tests/test_tools.py``); the probes and the fuzz run with ``--device cpu``
at tiny sizes; ``run_soak.sh`` names nothing of the JAX package.
"""

import ast
import difflib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sspv_tpu_torch.ops.frame_kernels import kernel_route
from sspv_tpu_torch.tools import (
    deep_fuzz,
    length_probe,
    pitch_probe,
    soak_report,
    soak_stitch,
)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "sspv_tpu_torch" / "tools"

# Lines of an original that its copy replaces, beside the docstring and the
# lines about the cuda_mb field: where the stitcher finds the report.
REPLACED = {
    "soak_stitch.py": [
        "sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))",
        "from soak_report import fit, parse  # noqa: E402",
    ],
}


def _code_lines(path: Path) -> list[str]:
    """The file's lines after its module docstring, package name folded."""
    text = path.read_text()
    end = ast.parse(text).body[0].end_lineno
    return [x.replace("sspv_tpu_torch.tools.", "")
            for x in text.splitlines()[end:]]


@pytest.mark.parametrize("name", ["soak_report.py", "soak_stitch.py"])
def test_copies_differ_only_in_the_package_and_cuda_mb(name):
    theirs, ours = _code_lines(REPO / "tools" / name), _code_lines(PORT / name)
    matcher = difflib.SequenceMatcher(None, theirs, ours, autojunk=False)
    for op, i1, i2, j1, j2 in matcher.get_opcodes():
        if op == "equal":
            continue
        removed, added = theirs[i1:i2], ours[j1:j2]
        assert all(x in REPLACED.get(name, []) for x in removed), removed
        # each inserted block is about the card's allocator, or the
        # stitcher's import of the report
        assert (any("cuda" in x for x in added)
                or added == ["from soak_report import fit, parse"]), added


def _soak_log(path: Path, cuda_mb_per_call=None, n=60, old_prefix=0) -> Path:
    """``tests/test_tools.py``'s synthetic soak logs: 0.5 MB of RSS per
    call, 2 calls per 5 s sample, frames from t = 60 s; optionally the
    card's allocated memory growing by ``cuda_mb_per_call``, and rows of
    the old format (no ``calls=``) in front."""
    lines, rss, calls, cuda = [], 200.0, 0, 12.0
    for i in range(old_prefix):
        lines.append(f"t={5.0 * (i + 1):6.1f}s rss={100.0 + 3 * i:7.1f}MB "
                     "recent_frames=50 err=None")
    for i in range(n):
        t = 5.0 * (old_prefix + i + 1)
        frames = 0 if t < 60 else 100
        if frames:
            calls += 2
            rss += 1.0
            cuda += 2 * (cuda_mb_per_call or 0.0)
        card = (f"cuda_mb={cuda:9.1f}MB " if cuda_mb_per_call is not None
                else "")
        lines.append(f"t={t:6.1f}s rss={rss:7.1f}MB calls={calls} "
                     f"recent_frames={frames} voiced=3 {card}err=None")
    lines.append("soak: PASS")
    path.write_text("\n".join(lines) + "\n")
    return path


def _original_report(log: Path, *args) -> tuple[int, dict]:
    out = subprocess.run(
        [sys.executable, "tools/soak_report.py", str(log), *args],
        capture_output=True, text=True, cwd=REPO,
    )
    return out.returncode, json.loads(out.stdout)


def _port_report(capsys, log: Path, *args) -> tuple[int, dict]:
    rc = soak_report.main([str(log), *args])
    return rc, json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("case", [
    ("fits", {}, ("--settle", "30")),
    ("mixed format", {"old_prefix": 10}, ("--settle", "0")),
    ("no frames", {"n": 1}, ()),
])
def test_soak_report_gives_the_originals_numbers(case, tmp_path, capsys):
    _, kwargs, args = case
    log = _soak_log(tmp_path / "soak.log", **kwargs)
    assert _port_report(capsys, log, *args) == _original_report(log, *args)


def test_soak_report_fits_the_card(tmp_path, capsys):
    """A log with cuda_mb: the card's slopes beside the host's, and the
    original reads the same log to the same host numbers."""
    log = _soak_log(tmp_path / "soak.log", cuda_mb_per_call=0.25)
    rc, ours = _port_report(capsys, log, "--settle", "30")
    assert rc == 0
    assert abs(ours["cuda_mb_per_call"] - 0.25) < 0.01
    assert abs(ours["cuda_slope_mb_per_s"] - 0.1) < 0.01  # 2 calls / 5 s
    assert ours["cuda_mb_end"] > ours["cuda_mb_start"]
    assert abs(ours["rss_mb_per_call"] - 0.5) < 0.01
    rc0, theirs = _original_report(log, "--settle", "30")
    assert rc0 == 0
    assert {k: v for k, v in ours.items() if not k.startswith("cuda")} == theirs


def _stitch(capsys, *args):
    rc = soak_stitch.main(list(args))
    return rc, capsys.readouterr().out


def _original_stitch(*args):
    out = subprocess.run(
        [sys.executable, "tools/soak_stitch.py", *args],
        capture_output=True, text=True, cwd=REPO,
    )
    return out.returncode, out.stdout


@pytest.mark.parametrize("cuda_mb", [None, 0.1])
def test_soak_stitch_gives_the_originals_record(cuda_mb, tmp_path, capsys):
    """``tests/test_tools.py``'s segments: a clean one and an orphan,
    stitched by both copies into equal state rows and reports."""
    rows = {}
    for who in ("ours", "theirs"):
        d = tmp_path / who
        d.mkdir()
        _soak_log(d / "seg1.log", cuda_mb_per_call=cuda_mb, n=100)
        _soak_log(d / "seg2.log", cuda_mb_per_call=cuda_mb, n=60)
        state = d / "state.jsonl"
        run = ((lambda *a: _stitch(capsys, *a)) if who == "ours"
               else _original_stitch)
        out = [run("--append-state", str(state), "--log", str(d / "seg1.log"),
                   "--rc", "0"),
               run("--reconcile", str(state), str(d)),
               run("--accumulated", str(state)),
               run("--settle", "120", str(state))]
        assert all(rc == 0 for rc, _ in out)
        rows[who] = [text.replace(str(d), "D") for _, text in out]
    assert rows["ours"] == rows["theirs"]
    report = json.loads(rows["ours"][-1])
    assert report["segments"] == 2 and report["total_calls"] == 2 * (100 + 60 - 22)
    assert abs(report["pooled_rss_mb_per_call"] - 0.5) < 0.01


def test_run_soak_names_nothing_of_the_jax_package():
    text = (PORT / "run_soak.sh").read_text()
    assert "jax" not in text.lower()
    # every path or module of a tool or an example is the port's
    for m in re.finditer(r"(\S*?)(tools|examples)[/.]", text):
        assert m.group(1).endswith(("sspv_tpu_torch/", "sspv_tpu_torch.")), m.group(0)
    assert "python -m sspv_tpu_torch.examples.soak" in text
    assert "MIN_DISPATCH_INTERVAL" not in text
    assert subprocess.run(["bash", "-n", str(PORT / "run_soak.sh")]).returncode == 0


# -- probes and fuzz ---------------------------------------------------------


def test_length_probe_on_the_cpu(capsys):
    assert length_probe.main(["1.5", "2", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["seconds"] for r in lines] == [1.5, 2.0]
    assert [r["frames"] for r in lines] == [149, 199]
    for r in lines:
        assert r["pipelined_time_s"] > 0 and r["event_ms_median"] is None
        assert r["synth_s"] is not None and r["device"] == "cpu"


def test_probes_take_the_callers_signal():
    from sspv_tpu_torch.utils.synth import synth_signal

    sig = synth_signal(1.0)
    r = length_probe.probe(1.0, "cpu", signal=sig)
    assert r["synth_s"] is None and r["frames"] == 99
    r = pitch_probe.probe(1.0, "cpu", signal=sig)
    assert r["synth_s"] is None and r["frames"] == 99


def test_pitch_probe_on_the_cpu(capsys):
    assert pitch_probe.main(["1", "--device", "cpu"]) == 0
    (r,) = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert r["seconds_per_call"] == 1.0 and r["frames"] == 99
    assert r["serialized_time_s"] > 0 and r["audio_s_per_s"] > 0


def test_deep_fuzz_on_the_cpu(capsys):
    assert deep_fuzz.main(["6", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "vad fuzz: 6/6 exact" in out
    assert "geometry fuzz: 3/3 within gates" in out


def test_deep_fuzz_geometries_reach_both_k3_routes():
    """The first 20 geometries (the smoke's count) take both K3 kernels."""
    routes = set()
    for seed in range(20):
        _, (frame, _, n_fft, *_) = deep_fuzz.geometry(seed)
        routes.add(kernel_route(frame, n_fft // 2 + 1, n_fft))
    assert routes == {"fft", "dense"}


def test_deep_fuzz_counts_a_mismatch(monkeypatch, capsys):
    """A geometry whose features miss the oracle fails the run."""
    import sspv_tpu_torch.ops.pipeline as pipeline_mod

    real = pipeline_mod.FeaturePipeline.process_block

    def off_by_a_bit(self, frames, state, valid=None):
        block, st = real(self, frames, state, valid)
        return block._replace(mfcc=block.mfcc * 1.01), st

    monkeypatch.setattr(pipeline_mod.FeaturePipeline, "process_block",
                        off_by_a_bit)
    assert deep_fuzz.main(["0", "1", "--device", "cpu"]) == 1
    assert "GEOMETRY MISMATCH" in capsys.readouterr().out
    assert np.isfinite(deep_fuzz.NMSE_GATE)


# K3's geometries at the hour (359,998 frames of 400/160; 359,999 of 320/160
# for n_fft 640): the dense route's (n_fft 400 with Whisper's Hann and 80 mel
# bands, 511, 640) and the FFT route's at 512
K3_BOUND_CASES = {
    "dense_whisper_400": (dict(frame_size=400, hop_size=160, n_fft=400,
                               entropy_n_fft=400, window_type="hanning",
                               num_filters=80), 359_998),
    "dense_511": (dict(frame_size=400, hop_size=160, n_fft=511,
                       entropy_n_fft=511), 359_998),
    "dense_640": (dict(n_fft=640, entropy_n_fft=640), 359_999),
}


@pytest.mark.parametrize("case", list(K3_BOUND_CASES))
def test_roofline_bounds_k3_dense_route(case):
    """kernel_bound takes every geometry K3 takes: at the dense route's the
    function's bound (a real FFT of n_fft points, or the bytes) and the
    design's (the 3xTF32 product at 495 TFLOP/s, the bytes, or the
    design's shared-memory traffic) are finite, the design's no lower."""
    from sspv_tpu_torch.ops.pipeline import FeatureConfig
    from sspv_tpu_torch.tools import roofline

    geometry, frames = K3_BOUND_CASES[case]
    cfg = FeatureConfig(**geometry)
    bins = cfg.n_fft // 2 + 1
    assert kernel_route(cfg.frame_size, bins, cfg.n_fft) == "dense"
    b = roofline.kernel_bound("frame_features", cfg, frames)
    assert all(np.isfinite(b[k]) and b[k] > 0
               for k in ("bound_ms", "design_bound_ms", "ops", "design_ops"))
    assert b["bound_by"] == "bytes"
    assert b["design_ops"] == 3 * 2 * frames * cfg.frame_size * 2 * bins
    tf32_ms = 1e3 * b["design_ops"] / roofline.TF32_OPS_PER_S
    assert b["design_bound_ms"] >= max(tf32_ms, b["bound_ms"])
    assert b["design_bound_by"] in ("TF32 operations", "bytes",
                                    "shared memory")


def test_roofline_bounds_k3_fft_route_as_before():
    """The FFT route's bounds at 400/160 of 512 points on the hour stay
    what they were before the dense route had any (0.1788 / 0.2948 ms)."""
    from sspv_tpu_torch.ops.pipeline import FeatureConfig
    from sspv_tpu_torch.tools import roofline

    b = roofline.kernel_bound("frame_features",
                              FeatureConfig(frame_size=400, hop_size=160),
                              359_998)
    assert round(b["bound_ms"], 4) == 0.1788 and b["bound_by"] == "bytes"
    assert round(b["design_bound_ms"], 4) == 0.2948
    assert b["design_bound_by"] == "shared memory"
