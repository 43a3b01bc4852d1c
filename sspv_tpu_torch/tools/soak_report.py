#!/usr/bin/env python3
"""Summarize a soak log (``sspv_tpu_torch.examples.soak`` output) into
leak-rate numbers.

Parses ``t=..s rss=..MB calls=N ...`` lines and reports RSS slope vs time
and vs device calls over the steady-state tail (default: after the first
frame appears plus a settle margin), plus a 24 h extrapolation:

    python -m sspv_tpu_torch.tools.soak_report /path/to/soak.log [--settle 120]

Lines that carry ``cuda_mb=..MB`` (the soak on a CUDA device logs the
card's allocated memory) get the same fits for the card: a leak per device
call that stays on the card never shows in host RSS. Logs without it (the
JAX package's soak) give the JAX package's report, key for key.
"""

from __future__ import annotations

import json
import re
import sys

_LINE = re.compile(
    r"t=\s*([0-9.]+)s\s+rss=\s*([0-9.]+)MB\s+(?:calls=(\d+)\s+)?"
    r"recent_frames=(\d+)"
)
_CUDA_MB = re.compile(r"cuda_mb=\s*([0-9.]+)MB")


def parse(path: str):
    rows, errors, verdict = [], 0, None
    with open(path) as f:
        for line in f:
            m = _LINE.search(line)
            if m:
                t, rss, calls, frames = m.groups()
                rows.append(
                    (float(t), float(rss),
                     int(calls) if calls else None, int(frames))
                )
                if "err=None" not in line and "err=" in line:
                    errors += 1
            elif line.startswith("soak:"):
                verdict = line.split()[-1]
    return rows, errors, verdict


def parse_cuda_mb(path: str):
    """``(t, calls, cuda_mb)`` of every sample line that carries cuda_mb."""
    out = []
    with open(path) as f:
        for line in f:
            m, c = _LINE.search(line), _CUDA_MB.search(line)
            if m and c:
                calls = m.group(3)
                out.append((float(m.group(1)),
                            int(calls) if calls else None, float(c.group(1))))
    return out


def fit(xs, ys):
    """Least-squares slope + intercept."""
    n = len(xs)
    if n < 2 or max(xs) == min(xs):
        return 0.0, (ys[0] if ys else 0.0)
    mx = sum(xs) / n
    my = sum(ys) / n
    num = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    den = sum((x - mx) ** 2 for x in xs)
    slope = num / den
    return slope, my - slope * mx


def main(argv):
    path = argv[0]
    settle = 120.0
    if "--settle" in argv:
        settle = float(argv[argv.index("--settle") + 1])
    rows, errors, verdict = parse(path)
    if not rows:
        print(json.dumps({"error": "no samples parsed", "path": path}))
        return 1
    # steady state: from the first sample with frames>0, plus settle margin
    t_first = next((t for t, _, _, fr in rows if fr > 0), None)
    if t_first is None:
        print(json.dumps({"error": "no frames ever produced", "path": path}))
        return 1
    steady = [r for r in rows if r[0] >= t_first + settle]
    if len(steady) < 3:
        steady = [r for r in rows if r[0] >= t_first]
    ts = [r[0] for r in steady]
    rss = [r[1] for r in steady]
    mb_per_s, _ = fit(ts, rss)
    out = {
        "log": path,
        "samples": len(rows),
        "steady_samples": len(steady),
        "duration_s": round(rows[-1][0], 1),
        "first_frames_at_s": round(t_first, 1),
        "rss_start_mb": round(steady[0][1], 1),
        "rss_end_mb": round(steady[-1][1], 1),
        "rss_slope_mb_per_s": round(mb_per_s, 5),
        "rss_24h_extrapolation_gb": round(mb_per_s * 86400 / 1024, 2),
        "steady_samples_with_frames": sum(1 for r in steady if r[3] > 0),
        "errors": errors,
        **({"verdict": verdict} if verdict else {}),
    }
    # Pairwise-filter rows that carry the calls field: a mixed-format log
    # (e.g. appended across restarts where early rows predate `calls=`) must
    # not pair call counts against RSS samples from other timestamps.
    with_calls = [r for r in steady if r[2] is not None]
    if len(with_calls) >= 3 and with_calls[-1][2] > with_calls[0][2]:
        c_ts = [r[0] for r in with_calls]
        c_rss = [r[1] for r in with_calls]
        c_calls = [r[2] for r in with_calls]
        mb_per_call, _ = fit(c_calls, c_rss)
        out["device_calls"] = c_calls[-1]
        if c_ts[-1] > c_ts[0]:
            out["calls_per_s"] = round(
                (c_calls[-1] - c_calls[0]) / (c_ts[-1] - c_ts[0]), 3
            )
        out["rss_mb_per_call"] = round(mb_per_call, 5)
    # the card's allocator over the same steady window
    cuda_mb = [r for r in parse_cuda_mb(path) if r[0] >= steady[0][0]]
    if len(cuda_mb) >= 2:
        cuda_slope, _ = fit([r[0] for r in cuda_mb], [r[2] for r in cuda_mb])
        out["cuda_mb_start"] = round(cuda_mb[0][2], 1)
        out["cuda_mb_end"] = round(cuda_mb[-1][2], 1)
        out["cuda_slope_mb_per_s"] = round(cuda_slope, 5)
        cuda_calls = [r for r in cuda_mb if r[1] is not None]
        if len(cuda_calls) >= 3 and cuda_calls[-1][1] > cuda_calls[0][1]:
            cuda_per_call, _ = fit([r[1] for r in cuda_calls],
                                   [r[2] for r in cuda_calls])
            out["cuda_mb_per_call"] = round(cuda_per_call, 5)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
