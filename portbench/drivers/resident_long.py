"""Closed-loop offline analysis of long recordings already on the card:
``BatchPipeline(make_mesh(1), cfg).process_long_pitch`` on one recording at
a time, synchronised when each completes.

Traffic parameters (``traffic/<mix>.json``): ``pool`` recordings of int16
PCM made on the card at set-up, their lengths ``min_s``..``max_s`` evenly
spaced in log (the same set for every seed, cycled in the seed's order),
``floor_rms``, and ``sample``: how many recordings' outputs are checked
(the longest and ``sample - 1`` drawn from the seed; the last call of each
in the window).

End-to-end: ``audio_s_per_s``, the audio of every call completed in the
window over the window's wall-clock seconds (the window closes at the end
of the first call that ends past ``--seconds``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..harness import plans
from ..harness.audio import speech


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Driver:
    PITCH = True

    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        sr = ctx.cfg["sample_rate"]
        secs = plans.log_uniform(int(t["pool"]), float(t["min_s"]),
                                 float(t["max_s"]))
        self.lengths = [int(round(s * sr)) for s in secs]
        r = plans.rng(ctx.seed)
        self.order = r.permutation(len(self.lengths))
        longest = int(np.argmax(self.lengths))
        others = [i for i in r.permutation(len(self.lengths)) if i != longest]
        self.sample = [longest] + others[: int(t["sample"]) - 1]

    def _call(self, sig):
        b = self.ctx.band
        return self.bp.process_long_pitch(
            sig, fmin=b["fmin"], fmax=b["fmax"],
            min_confidence=b["min_confidence"])

    def inputs(self) -> None:
        """The recordings, on the device, from the seed."""
        ctx = self.ctx
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(ctx.seed & (2**63 - 1))
        self.pool = [speech(n, ctx.cfg["sample_rate"], gen,
                            float(ctx.traffic["floor_rms"]))
                     for n in self.lengths]

    def checked(self, seconds: float) -> list:
        """``(pcm, frames)`` of what a run of ``seconds`` checks."""
        return [(self.pool[i], None) for i in self.sample]

    def setup(self, tracer) -> None:
        from sspv_tpu_torch.ops.pipeline import FeatureConfig
        from sspv_tpu_torch.parallel import BatchPipeline, make_mesh

        ctx = self.ctx
        self.inputs()
        self.bp = BatchPipeline(make_mesh(1, device=ctx.device),
                                FeatureConfig(**ctx.cfg))
        for _ in range(2):  # every length of the mix, twice
            for sig in self.pool:
                self._call(sig)
            sync(ctx.device)
        tracer.start()

    def window(self, seconds: float, tracer) -> dict:
        sr = self.ctx.cfg["sample_rate"]
        kept = {}
        calls = audio = 0
        t0 = now = time.monotonic()
        marks, mark = [], t0 + 2.0
        while now - t0 < seconds:
            i = int(self.order[calls % len(self.order)])
            tracing = tracer.active
            out = self._call(self.pool[i])
            sync(self.ctx.device)
            now = time.monotonic()
            calls += 1
            audio += self.lengths[i] / sr
            if i in self.sample:
                kept[i] = out
            if tracing:
                tracer.record({"samples": self.lengths[i]})
            tracer.poll(now)
            if now >= mark:
                marks.append(round(audio))
                mark += 2.0
        self.kept = kept
        return {"metrics": {"audio_s_per_s": audio / (now - t0)},
                "attempted": calls, "failed": 0,
                "notes": {"calls": calls, "window_s": now - t0,
                          "audio_s_by_2s": [int(x) for x in np.diff([0] + marks)]}}

    def release(self) -> list:
        """The checked items on the host; the program's state freed."""
        items = []
        for i in self.sample:
            out = self.kept.get(i)
            if out is None:  # never called in the window: nothing to show
                items.append((self.pool[i], {}, None))
                continue
            block, _, f0, conf = out
            prog = {k: getattr(block, k).cpu().numpy() for k in
                    ("energy", "zcr", "entropy", "mfcc", "vad",
                     "vad_adaptive")}
            prog["f0"], prog["confidence"] = f0.cpu().numpy(), conf.cpu().numpy()
            items.append((self.pool[i], prog, None))
        self.kept = self.bp = None
        if torch.device(self.ctx.device).type == "cuda":
            torch.cuda.empty_cache()
        return items
