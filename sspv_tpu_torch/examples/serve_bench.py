#!/usr/bin/env python3
"""Serving-layer benchmark: N concurrent HTTP clients against
``sspv_tpu_torch.serve``.

Measures end-to-end request latency and aggregate audio throughput of the
HTTP surface (decode + bucket pad + shared-pipeline device call + JSON/npz
encode). Complements ``multistream_bench``, which measures the engine and
dispatch layer without HTTP: the difference between the two is the serving
overhead. With ``--url`` the clients run in this process and the server in
another (``python -m sspv_tpu_torch.serve``), so the server's encoding and
the clients' decoding no longer share one interpreter.

Usage:
    python -m sspv_tpu_torch.examples.serve_bench [--clients 1,4,8]
        [--seconds 30] [--requests 8] [--endpoint /v1/features] [--fmt npz]
        [--device cuda]            # the in-process server's device
        [--url http://host:port]   # benchmark an external server instead

Prints one JSON line per client count:
    {"clients": N, "requests": R, "audio_s_per_s": ..., "p50_ms": ...,
     "p90_ms": ..., "aggregate_x_realtime": ..., "backend": ...}
``backend`` is what the server's ``/healthz`` reports.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import time
import urllib.request
import wave

import numpy as np


def _wav_bytes(seconds: float, sr: int, freq: float = 150.0) -> bytes:
    t = np.arange(int(seconds * sr)) / sr
    sig = np.zeros_like(t)
    third = len(t) // 3
    sig[third : 2 * third] = np.sin(2 * np.pi * freq * t[third : 2 * third])
    samples = (sig * 8000).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(samples.tobytes())
    return buf.getvalue()


def _post(url: str, body: bytes, timeout: float = 600.0) -> bytes:
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": "audio/wav"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}")
        return resp.read()


def run_level(url: str, wav: bytes, clients: int, requests_each: int,
              audio_seconds: float) -> dict:
    latencies: list[list[float]] = [[] for _ in range(clients)]
    errors: list = []

    def worker(i: int) -> None:
        try:
            for _ in range(requests_each):
                t0 = time.perf_counter()
                _post(url, wav)
                latencies[i].append(time.perf_counter() - t0)
        except Exception as e:  # pragma: no cover - network failure path
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    lat = np.array(sorted(x for l in latencies for x in l))
    total_requests = int(lat.size)
    total_audio = total_requests * audio_seconds
    return {
        "clients": clients,
        "requests": total_requests,
        "errors": errors,
        "wall_s": round(wall, 3),
        "requests_per_s": round(total_requests / wall, 2),
        "audio_s_per_s": round(total_audio / wall, 1),
        "aggregate_x_realtime": round(total_audio / wall, 1),
        "p50_ms": round(float(np.percentile(lat, 50)) * 1000, 1) if lat.size else None,
        "p90_ms": round(float(np.percentile(lat, 90)) * 1000, 1) if lat.size else None,
        "max_ms": round(float(lat.max()) * 1000, 1) if lat.size else None,
    }


def run(clients=(1, 4, 8), seconds: float = 30.0, requests: int = 8,
        endpoint: str = "/v1/features", fmt: str = "npz",
        url: str | None = None, device="cuda") -> list[dict]:
    """One result per client count, against ``url`` or, without one, a
    server on a thread of this process over ``FeatureService(device)``."""
    from ..config import Config

    wav = _wav_bytes(seconds, Config.SAMPLE_RATE)
    path = f"{endpoint}?fmt={fmt}"

    server = None
    if url:
        base = url.rstrip("/")
    else:
        import torch

        from ..serve import FeatureService, make_server
        from ..utils.device import resolve_device

        service = FeatureService(device=resolve_device(device))
        # one float32 matmul precision for every request thread, as the
        # server's own main pins it (ops.fp32.full_fp32 then never writes)
        torch.set_float32_matmul_precision("highest")
        server = make_server("127.0.0.1", 0, service)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        host, port = server.server_address[:2]
        base = f"http://{host}:{port}"

    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            backend = json.loads(resp.read())["backend"]
        # warm-up: the kernels' build and each program's first call
        t0 = time.perf_counter()
        _post(base + path, wav)
        print(json.dumps({"warmup_s": round(time.perf_counter() - t0, 2),
                          "backend": backend}), file=sys.stderr)
        return [dict(run_level(base + path, wav, c, requests, seconds),
                     backend=backend, fmt=fmt)
                for c in clients]
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sspv_tpu_torch.examples.serve_bench")
    ap.add_argument("--clients", default="1,4,8")
    ap.add_argument("--seconds", type=float, default=30.0,
                    help="audio seconds per request")
    ap.add_argument("--requests", type=int, default=8,
                    help="requests per client per level")
    ap.add_argument("--endpoint", default="/v1/features")
    ap.add_argument("--fmt", default="npz", choices=["json", "npz"])
    ap.add_argument("--url", default=None,
                    help="external server base URL; default: in-process")
    ap.add_argument("--device", default="cuda",
                    help="the in-process server's device: cuda (default) or "
                         "cpu; unused with --url")
    args = ap.parse_args(argv)
    for line in run(tuple(int(c) for c in args.clients.split(",")),
                    args.seconds, args.requests, args.endpoint, args.fmt,
                    args.url, args.device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
