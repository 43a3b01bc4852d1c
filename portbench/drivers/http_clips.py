"""Open-loop HTTP clips against the port's service: ``serve.make_server`` on
127.0.0.1, port 0, over one ``FeatureService`` in this process, and a
client in a process of its own (``http_client.py``) that sends each
request at its due time.

Traffic parameters: ``route``; ``pool`` WAV clips (16 kHz mono int16)
whose durations are the mid-quantiles of a log-normal (``median_s``,
``sigma``, clipped to ``min_s``..``max_s``), made on the card at set-up and
sent in a fixed order; Poisson arrivals at ``rate_per_s`` (the gaps are
the mid-quantiles of the exponential, in a fixed order); the order is the
mix's own (``order_seed``), which the run's seed rotates; ``grace_s``:
how long answers are awaited past the window; ``warm``: clips sent before
the window; ``floor_rms``; ``sample``: how many answers are checked (the
first request of the longest clip and ``sample - 1`` drawn from the seed).

End-to-end: ``request_p95_ms``, the 95th percentile over every request due
in the window of the time from its due time to its response's last byte;
a request that fails or never answers counts as infinitely late.
Counters: the service's own ``requests`` and ``latency_sum_s`` of the
route across the window.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import threading
import time
import wave

import numpy as np
import torch

from ..harness import plans
from ..harness.audio import speech
from ..yardstick.stats import percentile

CLIENT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "http_client.py")


def wav_bytes(pcm: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.astype("<i2").tobytes())
    return buf.getvalue()


class Driver:
    PITCH = False

    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        sr = ctx.cfg["sample_rate"]
        durs = plans.log_normal(int(t["pool"]), float(t["median_s"]),
                                float(t["sigma"]), float(t["min_s"]),
                                float(t["max_s"]))
        self.lengths = [int(round(d * sr)) for d in durs]
        self.rate = float(t["rate_per_s"])
        self.dir = os.path.join(ctx.tmpdir, f"portbench_http_{os.getpid()}")
        self.client = self.server = None

    def inputs(self) -> None:
        """The clips, made on the device from the seed, on the host."""
        ctx = self.ctx
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(ctx.seed & (2**63 - 1))
        audio = speech(sum(self.lengths), ctx.cfg["sample_rate"], gen,
                       float(ctx.traffic["floor_rms"])).cpu()
        self.clips = list(torch.split(audio, self.lengths))

    def checked(self, seconds: float) -> list:
        """``(pcm, frames)`` of what a run of ``seconds`` checks."""
        return [(self.clips[q["clip"]], None) for q in self._plan(seconds)
                if q["keep"]]

    def setup(self, tracer) -> None:
        from sspv_tpu_torch import serve
        from sspv_tpu_torch.ops.pipeline import FeatureConfig, FeaturePipeline

        ctx = self.ctx
        sr = ctx.cfg["sample_rate"]
        os.makedirs(self.dir, exist_ok=True)
        self.inputs()
        bodies = [wav_bytes(c.numpy(), sr) for c in self.clips]
        offsets = np.cumsum([0] + [len(b) for b in bodies])
        self.bodies_path = os.path.join(self.dir, "bodies.bin")
        with open(self.bodies_path, "wb") as f:
            f.write(b"".join(bodies))
        self.offsets = [[int(a), int(b)] for a, b in zip(offsets, offsets[1:])]

        # as ``serve.main`` sets up a server: one process-wide float32
        # matmul precision for every request thread, then the warm-up
        torch.set_float32_matmul_precision("highest")
        pipe = FeaturePipeline(FeatureConfig(**ctx.cfg), device=ctx.device)
        self.service = serve.FeatureService(pipe)
        self.server = serve.make_server("127.0.0.1", 0, self.service)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.service.warmup()
        self.metrics = serve._METRICS
        self.route = ctx.traffic["route"]
        by_len = np.argsort(self.lengths)
        warm = by_len[np.linspace(0, len(by_len) - 1,
                                  int(ctx.traffic["warm"])).astype(int)]
        for i in warm:
            self._post_once(bodies[i])
        tracer.start()

    def _post_once(self, body: bytes) -> None:
        import http.client

        host, port = self.server.server_address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=120)
        try:
            conn.request("POST", self.route, body,
                         {"Content-Type": "audio/wav"})
            resp = conn.getresponse()
            resp.read()
            if resp.status != 200:
                raise RuntimeError(f"warm-up request: HTTP {resp.status}")
        finally:
            conn.close()

    def _plan(self, seconds: float) -> list[dict]:
        """The requests due in a window of ``seconds``: due time, clip and
        whether the answer is checked. The sequence of gaps and clips is
        one for the mix (``order_seed``); the run's seed rotates it and
        draws the checked answers, so that every seed offers the same
        arrivals in another order without another queue."""
        fixed = plans.rng(int(self.ctx.traffic["order_seed"]), 1)
        r = plans.rng(self.ctx.seed, 1)
        m = max(1, int(round(self.rate * seconds)))
        gaps = np.roll(fixed.permutation(plans.exponential_gaps(m, self.rate)),
                       int(r.integers(m)))
        due = np.cumsum(gaps) - gaps[0]  # the first request at the start
        due = due[due < seconds]
        base = fixed.permutation(len(self.lengths))
        order = np.roll(np.resize(base, len(due)), int(r.integers(len(base))))
        reqs = [{"id": i, "due": float(d), "clip": int(order[i]),
                 "keep": False} for i, d in enumerate(due)]
        longest = int(np.argmax(self.lengths))
        first = next((q for q in reqs if q["clip"] == longest), None)
        picks = [q["id"] for q in reqs if q is not first]
        picks = list(r.permutation(picks)[: int(self.ctx.traffic["sample"]) - 1])
        for q in reqs:
            q["keep"] = q is first or q["id"] in picks
        return reqs

    def _counters(self) -> tuple:
        with self.metrics._lock:
            r = self.metrics._routes.get(self.route, {})
            return r.get("requests", 0), r.get("latency_sum_s", 0.0)

    def window(self, seconds: float, tracer) -> dict:
        reqs = self._plan(seconds)
        self.reqs = reqs
        host, port = self.server.server_address[:2]
        plan = {"host": host, "port": port, "route": self.route,
                "bodies": self.bodies_path, "offsets": self.offsets,
                "requests": reqs, "grace_s": float(self.ctx.traffic["grace_s"]),
                "keep_dir": self.dir}
        plan_path = os.path.join(self.dir, "plan.json")
        result_path = os.path.join(self.dir, "result.json")
        with open(plan_path, "w") as f:
            json.dump(plan, f)
        self.client = subprocess.Popen(
            [sys.executable, CLIENT, plan_path, result_path],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        if self.client.stdout.readline().strip() != "ready":
            raise RuntimeError("the HTTP client did not start")
        t0 = time.monotonic() + 0.2
        self.client.stdin.write(f"{t0!r}\n")
        self.client.stdin.flush()
        while time.monotonic() < t0:
            time.sleep(0.001)
        n0, s0 = self._counters()
        while (now := time.monotonic()) < t0 + seconds:
            tracer.poll(now)
            time.sleep(0.005)
        tracer.poll(time.monotonic())
        self.client.wait(timeout=seconds + plan["grace_s"] + 60)
        n1, s1 = self._counters()
        with open(result_path) as f:
            got = {r["id"]: r for r in json.load(f)}
        lat = [got[q["id"]]["latency_s"]
               if q["id"] in got and got[q["id"]]["status"] == 200
               else float("inf") for q in reqs]
        self.last = ([q["due"] for q in reqs], lat)
        failed = sum(np.isinf(lat))
        p95 = percentile(lat, 95)
        if np.isinf(p95):  # more than 5 % never answered
            p95 = seconds + plan["grace_s"]
        return {"metrics": {"request_p95_ms": 1e3 * p95},
                "attempted": len(reqs), "failed": int(failed),
                "counters": {"serve.requests": n1 - n0,
                             "serve.latency_sum_s": s1 - s0},
                "notes": {"requests": len(reqs),
                          "request_p50_ms": 1e3 * percentile(lat, 50)}}

    def release(self) -> list:
        self.close()
        items = []
        for q in self.reqs:
            if not q["keep"]:
                continue
            path = os.path.join(self.dir, f"body_{q['id']}.json")
            prog = {}
            if os.path.exists(path):
                with open(path) as f:
                    body = json.load(f)
                prog = {k: np.asarray(body[k]) for k in
                        ("energy", "zcr", "entropy", "mfcc", "vad",
                         "vad_adaptive")}
            items.append((self.clips[q["clip"]], prog, None))
        for name in os.listdir(self.dir):
            os.remove(os.path.join(self.dir, name))
        os.rmdir(self.dir)
        self.service = None
        if torch.device(self.ctx.device).type == "cuda":
            torch.cuda.empty_cache()
        return items

    def close(self) -> None:
        if self.client is not None and self.client.poll() is None:
            self.client.kill()
        if self.client is not None:
            self.client.wait()
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.thread.join(timeout=30)
            self.server = None
