"""Closed-loop batches of fixed-length segments already on the card:
``BatchPipeline(make_mesh(1), cfg).process_batch_masked(signals,
lengths)``, one batch at a time, synchronised when each completes.

Traffic parameters: ``pool`` batches of ``rows`` int16 rows of
``segment_s`` seconds, made on the card at set-up and cycled; in each
batch ``short_per_batch`` rows are a recording's last segment, zero-padded
past its length; the short lengths are the mid-quantiles of U(``short_min_s``,
``short_max_s``) over the whole pool (the same set for every seed; the
seed places them); ``floor_rms``; ``sample``: how many batches are checked
(every row's true frames; the last call of each batch in the window).

End-to-end: ``audio_s_per_s``, the true audio (each row's own length) of
every batch completed in the window over the window's seconds.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..harness import plans
from ..harness.audio import speech
from .resident_long import sync


class Driver:
    PITCH = False

    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        sr = ctx.cfg["sample_rate"]
        pool, rows = int(t["pool"]), int(t["rows"])
        self.seg = int(round(float(t["segment_s"]) * sr))
        short = int(t["short_per_batch"])
        r = plans.rng(ctx.seed)
        shorts = r.permutation(plans.uniform(
            pool * short, float(t["short_min_s"]), float(t["short_max_s"])))
        self.lengths = np.full((pool, rows), self.seg, dtype=np.int64)
        for p in range(pool):
            at = r.choice(rows, size=short, replace=False)
            self.lengths[p, at] = np.round(
                shorts[p * short:(p + 1) * short] * sr).astype(np.int64)
        self.sample = [int(i) for i in r.permutation(pool)[: int(t["sample"])]]

    def inputs(self) -> None:
        """The batches, on the device, from the seed: rows of one long
        recording, zero past each row's length."""
        ctx = self.ctx
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(ctx.seed & (2**63 - 1))
        pool, rows = self.lengths.shape
        sig = speech(pool * rows * self.seg, ctx.cfg["sample_rate"], gen,
                     float(ctx.traffic["floor_rms"])).reshape(pool, rows,
                                                              self.seg)
        pos = torch.arange(self.seg, device=sig.device)
        lens = torch.as_tensor(self.lengths, device=sig.device)
        self.batches = torch.where(pos < lens[..., None], sig, 0)

    def _frames(self, length: int) -> int:
        c = self.ctx.cfg
        return 0 if length < c["frame_size"] else \
            1 + (int(length) - c["frame_size"]) // c["hop_size"]

    def checked(self, seconds: float) -> list:
        """``(pcm, frames)`` of what a run of ``seconds`` checks."""
        return [(self.batches[p, r, :length], self._frames(length))
                for p in self.sample for r, length in enumerate(self.lengths[p])]

    def setup(self, tracer) -> None:
        from sspv_tpu_torch.ops.pipeline import FeatureConfig
        from sspv_tpu_torch.parallel import BatchPipeline, make_mesh

        ctx = self.ctx
        self.inputs()
        pool = self.lengths.shape[0]
        self.bp = BatchPipeline(make_mesh(1, device=ctx.device),
                                FeatureConfig(**ctx.cfg))
        for _ in range(2):
            for p in range(pool):
                self.bp.process_batch_masked(self.batches[p], self.lengths[p])
            sync(ctx.device)
        tracer.start()

    def window(self, seconds: float, tracer) -> dict:
        sr = self.ctx.cfg["sample_rate"]
        pool = self.lengths.shape[0]
        kept = {}
        calls = 0
        audio = 0.0
        t0 = now = time.monotonic()
        marks, mark = [], t0 + 2.0
        while now - t0 < seconds:
            p = calls % pool
            tracing = tracer.active
            out = self.bp.process_batch_masked(self.batches[p], self.lengths[p])
            sync(self.ctx.device)
            now = time.monotonic()
            calls += 1
            audio += float(self.lengths[p].sum()) / sr
            if p in self.sample:
                kept[p] = out
            if tracing:
                tracer.record({"rows": self.lengths.shape[1],
                               "samples": self.seg})
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
        items = []
        for p in self.sample:
            out = self.kept.get(p)
            block = None if out is None else {
                k: getattr(out[0], k).cpu().numpy() for k in
                ("energy", "zcr", "entropy", "mfcc", "vad", "vad_adaptive")}
            for r, length in enumerate(self.lengths[p]):
                prog = {} if block is None else {k: v[r] for k, v in block.items()}
                items.append((self.batches[p, r, :length], prog,
                              self._frames(length)))
        self.kept = self.bp = None
        if torch.device(self.ctx.device).type == "cuda":
            torch.cuda.empty_cache()
        return items
