#!/usr/bin/env python3
"""Stitch per-segment soak logs into one cumulative soak record.

A host recycle that kills a long soak takes the *process* with it and
leaves no way to resume toward the reference's 24 h claim. So a long soak
runs as SEGMENTS (``sspv_tpu_torch/tools/run_soak.sh``): each segment
appends a state row when it ends, and re-running the same command after a
recycle resumes from the accumulated state instead of starting over.

Modes:

    # append one finished segment to the state file (called by run_soak.sh)
    python -m sspv_tpu_torch.tools.soak_stitch --append-state STATE.jsonl --log seg1.log --rc 0

    # accumulated steady seconds (frames flowing) across completed segments
    python -m sspv_tpu_torch.tools.soak_stitch --accumulated STATE.jsonl

    # combined report over every recorded segment
    python -m sspv_tpu_torch.tools.soak_stitch STATE.jsonl
"""

from __future__ import annotations

import json
import os
import sys

from sspv_tpu_torch.tools.soak_report import fit, parse


def segment_row(log: str, rc: int | None = None) -> dict:
    """One state row for a finished (or killed) segment log: wall duration,
    frames-flowing duration, device calls, and RSS endpoints. Robust to a
    log truncated mid-line by a recycle (parse skips partial lines)."""
    rows, errors, verdict = parse(log)
    framed = [r for r in rows if r[3] > 0]
    calls = [r[2] for r in rows if r[2] is not None]
    out = {
        "log": os.path.abspath(log),
        "rc": rc,
        "samples": len(rows),
        "duration_s": round(rows[-1][0], 1) if rows else 0.0,
        "frames_s": round(framed[-1][0] - framed[0][0], 1) if len(framed) > 1 else 0.0,
        "calls": calls[-1] if calls else 0,
        "rss_start_mb": round(rows[0][1], 1) if rows else 0.0,
        "rss_end_mb": round(rows[-1][1], 1) if rows else 0.0,
        "errors": errors,
        **({"verdict": verdict} if verdict else {}),
    }
    return out


def combined(state_path: str, settle: float = 120.0) -> dict:
    """Stitched report: total steady soak time across segments plus pooled
    leak-rate fits. Slopes are fit per segment (RSS does not carry across
    process restarts) and pooled weighted by each segment's steady span."""
    segs = []
    with open(state_path) as f:
        for line in f:
            line = line.strip()
            if line:
                segs.append(json.loads(line))
    per_seg, tot_frames_s, tot_calls = [], 0.0, 0
    w_slope_num = w_slope_den = 0.0
    w_call_num = w_call_den = 0.0
    for s in segs:
        rows, _, _ = parse(s["log"]) if os.path.exists(s["log"]) else ([], 0, None)
        t_first = next((t for t, _, _, fr in rows if fr > 0), None)
        entry = {k: s[k] for k in ("log", "rc", "duration_s", "frames_s", "calls")}
        if t_first is not None:
            steady = [r for r in rows if r[0] >= t_first + settle]
            if len(steady) >= 3:
                ts = [r[0] for r in steady]
                rss = [r[1] for r in steady]
                slope, _ = fit(ts, rss)
                span = ts[-1] - ts[0]
                entry["rss_slope_mb_per_s"] = round(slope, 5)
                w_slope_num += slope * span
                w_slope_den += span
                with_calls = [r for r in steady if r[2] is not None]
                if len(with_calls) >= 3 and with_calls[-1][2] > with_calls[0][2]:
                    mb_per_call, _ = fit(
                        [r[2] for r in with_calls], [r[1] for r in with_calls]
                    )
                    ncalls = with_calls[-1][2] - with_calls[0][2]
                    entry["rss_mb_per_call"] = round(mb_per_call, 5)
                    w_call_num += mb_per_call * ncalls
                    w_call_den += ncalls
        tot_frames_s += s.get("frames_s", 0.0)
        tot_calls += s.get("calls", 0)
        per_seg.append(entry)
    pooled_slope = w_slope_num / w_slope_den if w_slope_den else 0.0
    out = {
        "state": os.path.abspath(state_path),
        "segments": len(segs),
        "total_steady_s": round(tot_frames_s, 1),
        "total_steady_h": round(tot_frames_s / 3600.0, 2),
        "total_calls": tot_calls,
        "pooled_rss_slope_mb_per_s": round(pooled_slope, 5),
        "pooled_rss_24h_extrapolation_gb": round(
            pooled_slope * 86400 / 1024, 2
        ),
        **(
            {"pooled_rss_mb_per_call": round(w_call_num / w_call_den, 5)}
            if w_call_den
            else {}
        ),
        "errors": sum(s.get("errors", 0) for s in segs),
        "per_segment": per_seg,
    }
    return out


def reconcile(state: str, seg_dir: str) -> int:
    """Adopt orphan segment logs: a segment killed by a host recycle never
    reaches its --append-state call, but its log (on disk) still holds the
    samples up to the kill. Appends a state row (rc=None) for every
    seg*.log in ``seg_dir`` not yet recorded. Returns the count adopted."""
    import glob

    known = set()
    if os.path.exists(state):
        with open(state) as f:
            for line in f:
                line = line.strip()
                if line:
                    known.add(json.loads(line)["log"])
    adopted = 0
    for log in sorted(glob.glob(os.path.join(seg_dir, "seg*.log"))):
        if os.path.abspath(log) in known:
            continue
        row = segment_row(log, rc=None)
        row["orphan"] = True  # killed mid-run (recycle/oom): no exit status
        with open(state, "a") as f:
            f.write(json.dumps(row) + "\n")
        adopted += 1
    return adopted


def main(argv) -> int:
    if "--reconcile" in argv:
        i = argv.index("--reconcile")
        print(reconcile(argv[i + 1], argv[i + 2]))
        return 0
    if "--append-state" in argv:
        state = argv[argv.index("--append-state") + 1]
        log = argv[argv.index("--log") + 1]
        rc = int(argv[argv.index("--rc") + 1]) if "--rc" in argv else None
        row = segment_row(log, rc)
        with open(state, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row))
        return 0
    if "--accumulated" in argv:
        state = argv[argv.index("--accumulated") + 1]
        tot = 0.0
        if os.path.exists(state):
            with open(state) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        tot += json.loads(line).get("frames_s", 0.0)
        print(int(tot))
        return 0
    settle = 120.0
    if "--settle" in argv:
        i = argv.index("--settle")
        settle = float(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    state = next(a for a in argv if not a.startswith("--"))
    print(json.dumps(combined(state, settle)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
