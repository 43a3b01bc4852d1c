"""Closed-loop offline analysis of long recordings held in host memory:
``BatchPipeline(make_mesh(1), cfg).process_long_pitch`` on one pageable
int16 NumPy array at a time, as a decoder leaves it, with every output
copied back to host NumPy before the call counts.

The traffic parameters and the recordings of ``resident_long`` (made on the
card from the seed, then moved to the host at set-up). Each call pays the
upload, the kernels and the readback of the ``FeatureBlock`` fields, f0
and confidence; the checks read those host copies.

End-to-end: ``audio_s_per_s``, as ``resident_long`` counts it.
"""

from __future__ import annotations

import torch

from . import resident_long

FIELDS = ("energy", "zcr", "entropy", "mfcc", "vad", "vad_adaptive")


class Driver(resident_long.Driver):
    PITCH = True

    def inputs(self) -> None:
        """The recordings, made on the device from the seed, as host
        arrays."""
        super().inputs()
        self.pool = [sig.cpu().numpy() for sig in self.pool]
        if torch.device(self.ctx.device).type == "cuda":
            torch.cuda.empty_cache()

    def checked(self, seconds: float) -> list:
        return [(torch.from_numpy(pcm), frames)
                for pcm, frames in super().checked(seconds)]

    def _call(self, sig) -> dict:
        block, _, f0, conf = super()._call(sig)
        out = {k: getattr(block, k).cpu().numpy() for k in FIELDS}
        out["f0"], out["confidence"] = f0.cpu().numpy(), conf.cpu().numpy()
        return out

    def release(self) -> list:
        """The checked items: the host copies the window's calls made."""
        items = [(torch.from_numpy(self.pool[i]), self.kept.get(i, {}), None)
                 for i in self.sample]
        self.kept = self.bp = None
        return items
