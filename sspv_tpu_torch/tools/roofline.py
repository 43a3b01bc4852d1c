#!/usr/bin/env python3
"""Time decomposition of the long features and pitch calls, with the
kernels' bounds and an optional ``torch.profiler`` trace.

Splits the shipped calls into programs and times each warm, with calls
queued back to back (``length_probe``'s method: one readback per round of
4 calls; the host clock per call, median / best / spread over the rounds,
beside the median CUDA-event time per call):

    python -m sspv_tpu_torch.tools.roofline [--seconds 14400] [--only a,b]
        [--skip-r3] [--rounds 3] [--trace] [--trace-target feat|vad|pitch
        or a comma-separated list] [--trace-dir DIR] [--device cuda]

One JSON line per program:

  feat_shipped        process_signal_device on the uploaded rows view: K1 +
                      one full-length VAD
  feat_shipped_flat   the same on the 1-D signal (the view formed on the card)
  feat_r3_scan        K1 + VAD per 32,768-frame block, the VadState carried,
                      as the engine dispatches
  feat_only           K1 alone
  vad_only            the full-length VAD over K1's features (K4 on the
                      card: three launches)
  rows_only           one full read of the rows view: the input side's floor
  pitch_shipped       pitch_track_signal on the rows view (K2 + the gate)
  pitch_kernel_only   K2 alone (fused_view_pitch), ungated
  pitch_shipped_flat  pitch_track_signal on the 1-D signal
  pitch_gate_only     the gate over K2's outputs
  pitch_r3_scan       K2 per 32,768-frame block

Each line carries the kernel launches of its timed calls. The kernel rows
(``feat_only``, ``pitch_kernel_only``, ``vad_only``) carry ``analytic``:
the operations and bytes of the kernel's function and of its design, and
the least time each takes on an H100 SXM (``kernel_bound``); the other
rows carry null.

``--trace`` records the target program under ``torch.profiler`` (CPU and
CUDA activity) for 3 queued calls after a warm one (the profiler's
warm-up step), and prints one line: the top 25 device operations by
device time, the window from the first device operation's start to the
last one's end, the device's busy time (the union of kernels and copies),
``idle_share = 1 - busy / window``, the kernel launches per call, and the
five longest idle gaps with the host operation that was running when each
began. The profiler's own host cost widens the gaps, so the line also
gives ``idle_share_unprofiled``: one minus the traced busy time per call
over the CUDA-event time per call of the same program timed unprofiled
just before (3 rounds of 4 queued calls, as the program lines). Without device events (the CPU, or a profiler that records none),
or with fewer kernels recorded than the host launched (recorded again up
to 3 times: the profiler sometimes drops kernels on the card), the device
fields are null and ``device_trace`` says why.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import warnings

import numpy as np
import torch

from ..utils.device import card_line, resolve_device, synchronize
from .length_probe import make_signal, pipelined

# The least time of a kernel's work on an H100 SXM (NVIDIA's data sheet, at
# its full 700 W): fp32 and fp64 operations outside the tensor cores (a
# multiply-add counts 2), TF32 on the tensor cores (dense), device memory.
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 33.5e12
TF32_OPS_PER_S = 495e12
HBM_BYTES_PER_S = 3.35e12
# Shared memory: 128 bytes per clock and SM, 132 SMs, 1.98 GHz boost clock.
SMEM_BYTES_PER_S = 128 * 132 * 1.98e9

PROGRAMS = ("feat_shipped", "feat_shipped_flat", "feat_r3_scan", "feat_only",
            "vad_only", "rows_only", "pitch_shipped", "pitch_kernel_only",
            "pitch_shipped_flat", "pitch_gate_only", "pitch_r3_scan")
R3 = ("feat_r3_scan", "pitch_r3_scan")
ANALYTIC = {"feat_only": "view_features", "pitch_kernel_only": "view_pitch",
            "vad_only": "vad"}
TRACE_TARGETS = {"feat": "feat_shipped", "vad": "vad_only",
                 "pitch": "pitch_shipped"}
BLOCK_FRAMES = 32768
REPS = 4
TRACE_CALLS = 3
TRACE_ATTEMPTS = 3
TOP_OPS = 25
GAPS = 5
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MIN_CONFIDENCE = 0.3


# -- bounds from shapes ----------------------------------------------------


def bound(ops: float, nbytes: float,
          ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """The least ms of the work on the card and what bounds it."""
    t_ops, t_bytes = ops / ops_per_s, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def rfft_ops(n: int) -> float:
    """Operations of one real-input FFT of ``n`` points: half the
    ``5 n log2 n`` of a radix-2 complex FFT."""
    return 2.5 * n * math.log2(n)


def rfft_smem_floats(n_fft: int) -> int:
    """Shared-memory floats one frame's real FFT in ``csrc/fft.cuh`` reads
    and writes: the packed samples, every stage's sequence in and out and
    its twiddles, and the untangling step's reads."""
    from ..ops import fft_tables

    stages = sum(2 * n_fft + fft_tables.stage_twiddle_floats(n_left, r)
                 * (n_fft // 2 // n_left)
                 for n_left, _, r in fft_tables.stage_plan(n_fft))
    return n_fft + stages + 6 * (n_fft // 4 + 1)


def _mel_nnz(cfg) -> int:
    """Nonzero weights of the configuration's mel filterbank, as the
    pipeline loads it (float32)."""
    from ..ops import bases

    fb = bases.mel_filterbank_np(cfg.num_filters, cfg.n_fft, cfg.sample_rate)
    return int((np.asarray(fb, np.float32) != 0).sum())


def _features_work(cfg, frames: int, input_floats: int,
                   route: str = "fft") -> tuple:
    """K1's or K3's ``(ops, bytes, shared-memory bytes)`` on ``frames``
    frames read from ``input_floats`` floats of input, through the FFT
    route (K1, K3's FFT kernel) or K3's dense route. The operations are the
    function's least at any ``n_fft`` (a real FFT of n_fft points); the
    bytes and the shared-memory traffic are the route's."""
    from ..ops import fft_tables

    fr, bins = cfg.frame_size, cfg.n_fft // 2 + 1
    nf, nc = cfg.num_filters, cfg.num_ceps
    nnz = _mel_nnz(cfg)
    # power, mel, log, DCT, lifter, entropy
    tail = 3 * bins + 2 * nnz + nf + 2 * nf * nc + nc + 5 * bins
    # window, energy, sign changes
    ops = frames * (rfft_ops(cfg.n_fft) + 3 * fr + tail)
    # the kernel reads its input, the window, its twiddle table (the FFT
    # route) or the packed bases (the dense route), the filterbank with its
    # ranges and the cepstral constants, and writes energy, zcr, entropy and
    # the cepstra
    spectrum = (fft_tables.twiddle_table(cfg.n_fft).size if route == "fft"
                else _dense_bases_floats(fr, bins))
    nbytes = (4 * input_floats
              + 4 * (fr + spectrum + bins * nf + 2 * nf + nf * nc + nc)
              + frames * 4 * (3 + nc))
    # the power row out, the ranged mel sum, the log-mel row, the entropy's
    # two passes, the DCT; before them the FFT, or the dense route's
    # product
    tail_smem = bins + nnz + nf + 2 * bins + nf * nc
    if route == "fft":
        smem = frames * 4 * (rfft_smem_floats(cfg.n_fft) + tail_smem)
    else:
        smem = frames * 4 * tail_smem + _dense_product_smem(fr, bins, frames)
    return ops, nbytes, smem


def _dense_bases_floats(frame: int, n_bins: int) -> int:
    """Floats of K3's packed dense bases (``pack_dense_bases``)."""
    from ..ops import frame_kernels as fk

    tiles = -(-(-(-2 * n_bins // 8)) // fk.DENSE_STEP_TILES) \
        * fk.DENSE_STEP_TILES
    return -(-frame // fk.DENSE_DEPTH) * fk.DENSE_DEPTH * 8 * tiles * 2


def dense_product_ops(frame: int, n_bins: int, frames: int) -> float:
    """The tensor-core operations of K3's dense route: the product of the
    frames with the interleaved (wc, ws) pair, three times (3xTF32)."""
    return 3.0 * 2 * frames * frame * 2 * n_bins


def _dense_product_smem(frame: int, n_bins: int, frames: int) -> int:
    """Shared-memory bytes of the dense route's product at its plan: the
    staged samples written once for each time they are staged and read by
    energy and ZCR, and every warp's fragment loads of all the block's
    samples for each column step (the bases go from L2 to registers)."""
    from ..ops import frame_kernels as fk

    block, chunk = fk.dense_plan(frame, n_bins)
    kp = -(-frame // fk.DENSE_DEPTH) * fk.DENSE_DEPTH
    steps = -(-(-(-2 * n_bins // 8)) // fk.DENSE_STEP_TILES)
    blocks = -(-frames // block)
    staged = 1 if chunk >= kp else steps
    return 4 * blocks * block * kp * (staged + 8 * steps) + 4 * frames * frame


def _pitch_work(cfg, frames: int) -> tuple:
    """K2's ``(least ops, design ops, bytes, shared-memory bytes)`` at the
    default 50-400 Hz band."""
    from ..ops import fft_tables
    from ..ops.pitch import _lag_band

    fr, hop = cfg.frame_size, cfg.hop_size
    _, lag_max = _lag_band(cfg.sample_rate, 50.0, 400.0, fr)
    n_lags = lag_max + 1
    # the least transform of the linear ACF (frame + lag_max rounded up to
    # 128, the ACF bases' width) against the kernel's power of two
    nfft_least = -(-(fr + lag_max) // 128) * 128
    n_acf = fft_tables.acf_fft_size(fr, n_lags)
    # power spectrum, normalization and peak pick
    rest = lambda nfft: 3 * (nfft // 2 + 1) + 3 * n_lags
    # the kernel reads the rows and its twiddle table and writes f0, conf
    nbytes = (4 * (frames + 1) * hop + 4 * fft_tables.twiddle_table(n_acf).size
              + 8 * frames)
    # two FFTs, the power row out and in, its even extension, the ACF row
    smem = frames * 4 * (2 * rfft_smem_floats(n_acf) + 2 * (n_acf // 2 + 1)
                         + n_acf + 2 * n_lags)
    return (frames * (2 * rfft_ops(nfft_least) + rest(nfft_least)),
            frames * (2 * rfft_ops(n_acf) + rest(n_acf)), nbytes, smem)


def _vad_work(cfg, frames: int, blocked: bool = True) -> tuple:
    """K4's ``(least fp64 ops, design fp64 ops, bytes, shared-memory
    bytes)`` on one row of ``frames`` frames, with the blocked or the
    direct window sums."""
    h = cfg.history_len
    # per frame and stream: a running window sum (an add and a subtract),
    # the mean, the blend (two multiplies and an add) and the clamp; the
    # margin once
    least = frames * (2 * 6 + 1)
    # e, z, h in and the two int32 decisions out; the state in and out
    nbytes = frames * (3 * 4 + 2 * 4) + 2 * (2 * 4 * h + 2 * 4)
    if blocked:
        # per frame and stream: one add of each block scan and their sum;
        # shared memory: the staged float, the two scans' reads (floats) and
        # writes (doubles), the frame's two reads (doubles)
        design = frames * (2 * (3 + 4) + 1)
        smem = frames * 2 * (4 + 2 * 4 + 2 * 8 + 2 * 8)
    else:
        # each window summed whole (H adds a frame and stream); a thread's
        # 4 windows share the loads of H + 3 staged floats
        design = frames * (2 * (h + 4) + 1)
        smem = frames * 2 * (4 + (h + 3) + 2 * 8)
    return least, design, nbytes, smem


def kernel_bound(kernel: str, cfg, frames: int, blocked: bool = True,
                 route: str | None = None) -> dict:
    """The bounds of one kernel (``view_features`` K1 and ``view_pitch`` K2
    on the rows view of ``frames`` frames, ``frame_features`` K3 on
    ``frames`` formed frames, ``vad`` K4 on one row of ``frames`` frames)
    at the configuration ``cfg``, from shapes alone. Both count the bytes
    the function must move (each input read once, each output written
    once) and operations (a multiply-add is 2): fp32 for K1-K3, fp64 for
    K4. ``bound_ms`` counts the least operations of the function: the power
    spectrum and the ACF by real FFTs, the mel filterbank by its nonzero
    weights, the VAD's window sums as running sums. ``design_bound_ms`` is
    the ceiling of the kernel's own design: the FFTs at the kernel's
    transform size (K2's power of two against the least size the ACF
    needs), K3's dense route's 3xTF32 product over the TF32 peak
    (``design_bound_by`` "TF32 operations"), K4's block scans (``blocked``,
    the order of the long calls) or its windows summed whole, or the
    shared-memory traffic of their stages and tail rows (K4's staged
    values, scans and sums; the dense route's staged samples, fragment
    loads and bases), whichever takes longer. K3's route is ``route``
    ("fft" or "dense"), or the one its wrapper takes for the bases ``cfg``
    builds (``frame_kernels.kernel_route``)."""
    peak = design_peak = FP32_OPS_PER_S
    if kernel == "view_features":
        ops, nbytes, smem = _features_work(cfg, frames,
                                           (frames + 1) * cfg.hop_size)
        design_ops = ops
    elif kernel == "frame_features":
        from ..ops.frame_kernels import kernel_route

        bins = cfg.n_fft // 2 + 1
        route = route or kernel_route(cfg.frame_size, bins, cfg.n_fft)
        ops, nbytes, smem = _features_work(cfg, frames,
                                           frames * cfg.frame_size, route)
        design_ops = ops
        if route == "dense":
            design_ops = dense_product_ops(cfg.frame_size, bins, frames)
            design_peak = TF32_OPS_PER_S
    elif kernel == "view_pitch":
        ops, design_ops, nbytes, smem = _pitch_work(cfg, frames)
    elif kernel == "vad":
        ops, design_ops, nbytes, smem = _vad_work(cfg, frames, blocked)
        peak = design_peak = FP64_OPS_PER_S
    else:
        raise ValueError(f"no kernel {kernel!r}")
    ms, by = bound(ops, nbytes, peak)
    design_ms, design_by = bound(design_ops, nbytes, design_peak)
    if design_peak == TF32_OPS_PER_S and design_by == "operations":
        design_by = "TF32 operations"
    smem_ms = 1e3 * smem / SMEM_BYTES_PER_S
    if smem_ms > design_ms:
        design_ms, design_by = smem_ms, "shared memory"
    return {"kernel": kernel, "frames": int(frames), "ops": float(ops),
            "bytes": int(nbytes), "bound_ms": ms, "bound_by": by,
            "design_ops": float(design_ops), "smem_bytes": int(smem),
            "design_bound_ms": design_ms, "design_bound_by": design_by}


# -- timing ----------------------------------------------------------------


def launches_now() -> dict:
    from ..ops import LAUNCHES

    return dict(LAUNCHES)


def timed(fn, probe, device, rounds: int = 3, reps: int = REPS) -> dict:
    """A warm call, then ``rounds`` rounds of ``reps`` queued calls with one
    readback each: the host ms per call (median, best, spread over the
    rounds), the median of the rounds' CUDA-event medians (null off the
    card), and the kernel launches of the timed calls."""
    float(probe(fn()))
    before = launches_now()
    host, events = [], []
    for _ in range(rounds):
        s, ms = pipelined(lambda: probe(fn()), device, reps)
        host.append(s)
        events.append(ms)
    after = launches_now()
    s = sorted(host)
    return {
        "ms_median": 1e3 * s[len(s) // 2], "ms_best": 1e3 * s[0],
        "ms_spread": 1e3 * (s[-1] - s[0]),
        "event_ms_median": (None if events[0] is None
                            else float(np.median(events))),
        "calls": rounds * reps,
        "launches": {k: after[k] - before[k] for k in after
                     if after[k] != before[k]},
    }


class Programs:
    """The programs on one signal: device tensors made once, and
    ``programs[name] = (call, probe)``."""

    def __init__(self, sig_np: np.ndarray, device):
        from ..ops import pitch
        from ..ops.pipeline import FeatureBlock, FeatureConfig, FeaturePipeline
        from ..ops.view_kernels import fused_view_pitch

        self.pipe = pipe = FeaturePipeline(FeatureConfig(), device=device)
        c = pipe.cfg
        self.rows = rows = torch.from_numpy(pipe.host_rows_view(sig_np)).to(device)
        self.flat = flat = torch.from_numpy(sig_np).to(device)
        self.n = n = rows.shape[0] - 1
        state0 = pipe.initial_state()
        kw = pipe._pitch_kwargs(50.0, 400.0)
        lag_min, lag_max = pitch._lag_band(c.sample_rate, 50.0, 400.0,
                                           c.frame_size)
        merged, nyq_b, inv_live, inv_nyq = kw["bases"]
        k2 = dict(merged=merged, nyq_b=nyq_b, inv_live=inv_live,
                  inv_nyq=inv_nyq, lag_min=lag_min, lag_max=lag_max,
                  sample_rate=c.sample_rate)
        vad_gate = torch.ones((n,), dtype=torch.int32, device=device)
        self.feats = pipe._features_from_rows(rows)
        self.f0c = fused_view_pitch(rows, **k2)
        # the frames each kernel row's call gives its kernel: the VAD runs
        # once over the call's frames (in the blocked order)
        self.kernel_frames = {"view_features": n, "view_pitch": n, "vad": n}

        def r3():
            st, blocks = state0, []
            for start in range(0, n, BLOCK_FRAMES):
                m = min(BLOCK_FRAMES, n - start)
                feats = pipe._features_from_rows(rows[start:start + m + 1])
                blk, st = pipe._vad_stage(feats, st, None)
                blocks.append(blk)
            return FeatureBlock(*(torch.cat(x) for x in zip(*blocks))), st

        def pitch_r3():
            parts = [fused_view_pitch(rows[s:s + min(BLOCK_FRAMES, n - s) + 1],
                                      **k2)
                     for s in range(0, n, BLOCK_FRAMES)]
            return tuple(torch.cat(x) for x in zip(*parts))

        def gate():
            f0, conf = self.f0c
            on = (vad_gate > 0) & (conf >= MIN_CONFIDENCE)
            return torch.where(on, f0, torch.zeros_like(f0)), conf

        block = lambda out: out[0].vad[-1].to(torch.float32)
        feats = lambda out: out["energy"][-1]
        f0c = lambda out: out[0][-1] + out[1][-1]
        track = lambda x: pitch.pitch_track_signal(
            x, vad_gate, min_confidence=MIN_CONFIDENCE, bases=kw["bases"])
        self.programs = {
            "feat_shipped": (lambda: pipe.process_signal_device(rows, state0),
                             block),
            "feat_shipped_flat": (
                lambda: pipe.process_signal_device(flat, state0), block),
            "feat_r3_scan": (r3, block),
            "feat_only": (lambda: pipe._features_from_rows(rows), feats),
            "vad_only": (lambda: pipe._vad_full_length(self.feats, state0, n),
                         block),
            "rows_only": (lambda: rows.sum(), lambda out: out),
            "pitch_shipped": (lambda: track(rows), f0c),
            "pitch_kernel_only": (lambda: fused_view_pitch(rows, **k2), f0c),
            "pitch_shipped_flat": (lambda: track(flat), f0c),
            "pitch_gate_only": (gate, f0c),
            "pitch_r3_scan": (pitch_r3, f0c),
        }


# -- the trace -------------------------------------------------------------


def _union(intervals: list) -> list:
    """Sorted, merged ``[start, end]`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_op_at(t: float, host_ops: list) -> str | None:
    """The innermost host operation running at ``t`` (the latest-starting
    one that contains it)."""
    inside = [e for e in host_ops if e["ts"] <= t <= e["ts"] + e["dur"]]
    return max(inside, key=lambda e: e["ts"])["name"] if inside else None


def _launch(e: dict) -> bool:
    return e.get("cat") in ("cuda_runtime", "cuda_driver") and \
        e["name"].startswith(("cudaLaunchKernel", "cuLaunchKernel"))


def read_trace(events: list, calls: int) -> dict:
    """The device figures of a Chrome trace's events (microseconds):
    busy time, window, idle share, launches per call, the top device
    operations and the longest idle gaps. Null fields where the trace
    holds no device event, or fewer kernels than the host launched (the
    profiler lost some: every figure would be wrong)."""
    x = [e for e in events if e.get("ph") == "X"]
    dev = [e for e in x if e.get("cat") in DEVICE_CATS]
    recorded = sum(e["cat"] == "kernel" for e in dev)
    launched = sum(_launch(e) for e in x)
    out = {"window_ms": None, "device_busy_ms": None, "idle_share": None,
           "kernel_launches_per_call": None, "top_device_ops_ms": [],
           "longest_gaps": [], "kernels_recorded": recorded,
           "kernels_launched": launched}
    if not dev or recorded < launched:
        return out
    host_ops = [e for e in x
                if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver")]
    spans = _union([[e["ts"], e["ts"] + e["dur"]] for e in dev])
    window = spans[-1][1] - spans[0][0]
    busy = sum(b - a for a, b in spans)
    agg: dict[str, list] = {}
    for e in dev:
        acc = agg.setdefault(e["name"], [0.0, 0])
        acc[0] += e["dur"]
        acc[1] += 1
    top = sorted(agg.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(spans, spans[1:])),
                  reverse=True)[:GAPS]
    out.update({
        "window_ms": window / 1e3,
        "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "kernel_launches_per_call": recorded / calls,
        "top_device_ops_ms": [[name[:110], ms / 1e3, count]
                              for name, (ms, count) in top],
        "longest_gaps": [{"gap_ms": g / 1e3,
                          "at_ms": (t - spans[0][0]) / 1e3,
                          "host_op": _host_op_at(t, host_ops)}
                         for g, t in gaps],
    })
    return out


def _profile(fn, probe, device, path: str) -> tuple:
    """``TRACE_CALLS`` queued calls of ``fn`` under ``torch.profiler``
    after a warm one, the Chrome trace written to ``path``: ``(its
    events, the host operations by self time)``. The warm call is the
    profiler's warm-up step: the tracer starts there, and what it records
    is dropped."""
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    done = {}

    def ready(prof):
        prof.export_chrome_trace(path)
        done["host"] = sorted(prof.key_averages(),
                              key=lambda a: -a.self_cpu_time_total)

    with warnings.catch_warnings(), profile(
            activities=activities, on_trace_ready=ready,
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        # one active cycle: clearing its events after it loses nothing
        warnings.filterwarnings("ignore", "Profiler clears events")
        float(probe(fn()))
        synchronize(device)
        prof.step()
        tails = [probe(fn()) for _ in range(TRACE_CALLS)]
        float(torch.stack(tails).sum())
        synchronize(device)
        prof.step()
    with open(path) as f:
        return json.load(f)["traceEvents"], done["host"]


def trace(fn, probe, device, target: str, trace_dir=None) -> dict:
    """The trace line of ``fn``: recorded again, up to ``TRACE_ATTEMPTS``
    times, while the profiler keeps fewer kernels than the host launched
    (it sometimes drops some, on the card). The Chrome trace goes to
    ``trace_dir`` (default: a temporary directory, removed)."""
    device = torch.device(device)
    # the same program unprofiled, timed as the program lines are, for the
    # idle share the profiler's own host cost does not inflate
    unprofiled = timed(fn, probe, device)
    synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        folder = trace_dir or tmp
        os.makedirs(folder, exist_ok=True)
        path = os.path.join(folder, f"roofline_trace_{target}.json")
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            events, host = _profile(fn, probe, device, path)
            got = read_trace(events, TRACE_CALLS)
            if got["kernels_recorded"] >= got["kernels_launched"]:
                break
    out = {"trace_target": target, "program": TRACE_TARGETS[target],
           "calls": TRACE_CALLS, "attempts": attempt, **got}
    busy, ms = out["device_busy_ms"], unprofiled["event_ms_median"]
    out["event_ms_per_call_unprofiled"] = ms
    out["idle_share_unprofiled"] = (
        None if busy is None or ms is None
        else max(0.0, 1.0 - busy / TRACE_CALLS / ms))
    if out["window_ms"] is not None:
        out["device_trace"] = "measured"
    elif device.type != "cuda":
        out["device_trace"] = (f"not measured: device {device} has no "
                               "device activity to trace")
    elif out["kernels_recorded"] < out["kernels_launched"]:
        out["device_trace"] = (
            f"not measured: the profiler recorded {out['kernels_recorded']} "
            f"of the {out['kernels_launched']} kernels launched, "
            f"{attempt} times")
    else:
        out["device_trace"] = ("not measured: torch.profiler recorded no "
                               "kernel or copy on the card")
    out["top_host_ops_ms"] = [[a.key[:110], a.self_cpu_time_total / 1e3,
                               a.count] for a in host[:TOP_OPS]]
    if trace_dir:
        out["chrome_trace"] = path
    return out


# -- the run ---------------------------------------------------------------


def run(seconds: float, device, signal=None, only=None, skip_r3: bool = False,
        rounds: int = 3, trace_targets=(), trace_dir=None) -> list[dict]:
    """The programs on ``signal`` (default ``synth_signal(seconds)``), then
    one trace line per target: the JSON lines."""
    device = resolve_device(device)
    card = card_line(device)
    sig_np, synth_s = make_signal(seconds, signal)
    progs = Programs(sig_np, device)
    del sig_np
    synchronize(device)
    base = {"seconds": seconds, "frames": progs.n, "synth_s": synth_s,
            "view_kernel": progs.pipe._view_kernel_ok,
            "device": str(device), "card": card}
    lines = []
    for name in PROGRAMS:
        if (only and name not in only) or (skip_r3 and name in R3):
            continue
        fn, probe = progs.programs[name]
        stats = timed(fn, probe, device, rounds=rounds)
        kernel = ANALYTIC.get(name)
        lines.append({
            "program": name, **base, **stats,
            "x_realtime": seconds / (stats["ms_median"] / 1e3),
            "analytic": (kernel_bound(kernel, progs.pipe.cfg,
                                      progs.kernel_frames[kernel])
                         if kernel else None)})
    for target in trace_targets:
        fn, probe = progs.programs[TRACE_TARGETS[target]]
        lines.append({**trace(fn, probe, device, target, trace_dir), **base})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sspv_tpu_torch.tools.roofline")
    ap.add_argument("--seconds", type=float, default=14400.0)
    ap.add_argument("--trace", action="store_true",
                    help="record the target program under torch.profiler "
                         "and print its device figures")
    ap.add_argument("--trace-target", default="feat",
                    help="which program --trace records: "
                         f"{'|'.join(TRACE_TARGETS)}, or several, "
                         "comma-separated")
    ap.add_argument("--trace-dir", default=None,
                    help="write the Chrome trace there")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of programs to run")
    ap.add_argument("--skip-r3", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    unknown = (only or set()) - set(PROGRAMS)
    if unknown:
        ap.error(f"unknown programs {sorted(unknown)}; choose from "
                 f"{', '.join(PROGRAMS)}")
    targets = args.trace_target.split(",")
    if set(targets) - set(TRACE_TARGETS):
        ap.error(f"unknown trace target {args.trace_target!r}; choose from "
                 f"{', '.join(TRACE_TARGETS)}")
    for line in run(args.seconds, args.device, only=only,
                    skip_r3=args.skip_r3, rounds=args.rounds,
                    trace_targets=targets if args.trace else (),
                    trace_dir=args.trace_dir):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
