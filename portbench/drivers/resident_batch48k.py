"""Closed-loop batches of segments at a source rate already on the card,
resampled inside the call: ``BatchPipeline(make_mesh(1), cfg).
process_batch_masked(signals, lengths, source_rate=...)``, one batch at a
time, synchronised when each completes.

The traffic parameters of ``resident_batch`` (``pool``, ``rows``,
``segment_s``, ``short_per_batch``, ``short_min_s``, ``short_max_s``,
``floor_rms``, ``sample``), with the rows made at the configuration's
``source_rate``, one batch at a time from the seed. The comparison's PCM is
the reference's own resample (``reference/resample.py``, float64) of each
checked row's true samples, so the features reference holds the whole
chain, resample included.

End-to-end: ``audio_s_per_s``, the true audio (each row's own length at the
source rate) of every batch completed in the window over the window's
seconds. Each traced call records its rows and samples at the features'
rate (``frames_features``) and its true source samples, outputs and ratio
(``resample_roofline``).
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from ..harness.audio import speech
from ..reference import resample as ref
from . import resident_batch
from .resident_long import sync


class Driver(resident_batch.Driver):
    PITCH = False

    def __init__(self, ctx):
        self.src = int(ctx.config["source_rate"])
        at_src = copy.copy(ctx)  # the rows, their lengths and shorts at src
        at_src.cfg = {**ctx.cfg, "sample_rate": self.src}
        super().__init__(at_src)
        self.ctx = ctx
        self.up, self.down = ref.ratio(self.src, ctx.cfg["sample_rate"])
        self.out_lengths = -(-self.lengths * self.up // self.down)
        self.seg_out = ref.output_len(self.seg, self.up, self.down)

    def inputs(self) -> None:
        """The batches at the source rate, on the device, from the seed:
        each a run of one long recording, zero past each row's length."""
        ctx = self.ctx
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(ctx.seed & (2**63 - 1))
        pool, rows = self.lengths.shape
        pos = torch.arange(self.seg, device=ctx.device)
        batches = []
        for p in range(pool):
            sig = speech(rows * self.seg, self.src, gen,
                         float(ctx.traffic["floor_rms"])).reshape(rows, self.seg)
            lens = torch.as_tensor(self.lengths[p], device=ctx.device)
            batches.append(torch.where(pos < lens[:, None], sig, 0))
            del sig
        self.batches = torch.stack(batches)

    def _reference_rows(self, p: int) -> list:
        """``(pcm, frames)`` of batch ``p``'s rows at the features' rate:
        the reference's resample of each row's true samples."""
        out = []
        for r, length in enumerate(self.lengths[p]):
            pcm = ref.resample(self.batches[p, r, :length], self.src,
                               self.ctx.cfg["sample_rate"])
            out.append((pcm, self._frames(pcm.shape[0])))
        return out

    def checked(self, seconds: float) -> list:
        """``(pcm, frames)`` of what a run of ``seconds`` checks."""
        return [item for p in self.sample for item in self._reference_rows(p)]

    def _call(self, p: int):
        return self.bp.process_batch_masked(self.batches[p], self.lengths[p],
                                            source_rate=self.src)

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
                self._call(p)
            sync(ctx.device)
        tracer.start()

    def window(self, seconds: float, tracer) -> dict:
        pool, rows = self.lengths.shape
        kept = {}
        calls = 0
        audio = 0.0
        t0 = now = time.monotonic()
        marks, mark = [], t0 + 2.0
        while now - t0 < seconds:
            p = calls % pool
            tracing = tracer.active
            out = self._call(p)
            sync(self.ctx.device)
            now = time.monotonic()
            calls += 1
            audio += float(self.lengths[p].sum()) / self.src
            if p in self.sample:
                kept[p] = out
            if tracing:
                tracer.record({"rows": rows, "samples": self.seg_out,
                               "source_samples": int(self.lengths[p].sum()),
                               "outputs": int(self.out_lengths[p].sum()),
                               "up": self.up, "down": self.down})
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
            for r, (pcm, frames) in enumerate(self._reference_rows(p)):
                prog = {} if block is None else {k: v[r] for k, v in block.items()}
                items.append((pcm, prog, frames))
        self.kept = self.bp = None
        if torch.device(self.ctx.device).type == "cuda":
            torch.cuda.empty_cache()
        return items
