"""The comparison that decides ``correct``: the program's per-frame outputs
against the reference's, over every item a run checks.

The features are the reference's own, from the PCM alone. The VAD and the
pitch gate follow the program step by step: the reference's automaton runs
over the program's own features (the VAD stage's inputs) and the
reference's pitch is gated on the program's own decisions. The VAD is a
chain of thresholds on features that the two sides compute in different
precisions; from its own features the reference would flip a decision
wherever a feature lies within rounding of its threshold, and a flip
spreads over the hangover. From the program's features it must agree
exactly, and the features are held to the reference by themselves.

The numbers compared, each against a limit of its cell's own
(``checks`` in ``portbench/workloads/<cell>.json``):

- ``features_nmse``: the largest, over energy, ZCR, entropy and MFCC, of
  ``sum((program - reference)^2) / sum(reference^2)`` over all compared
  frames (float32 kernels against float64);
- ``vad_mismatch``: the share of compared decisions (``vad`` and
  ``vad_adaptive`` of every frame) that differ from the reference
  automaton's over the program's features (float64 history sums, as the
  configuration states);
- ``f0_mismatch``: the share of frames whose gated F0 differs (another
  lag, or the confidence gate on one side only);
- ``conf_maxerr``: the largest absolute difference of the normalized-ACF
  confidence.

An item whose program outputs are missing or shorter than the frames
compared counts every missing frame as wrong.
"""

from __future__ import annotations

import numpy as np
import torch

from .features import features
from .pitch import pitch
from .vad import vad

FEATURES = ("energy", "zcr", "entropy", "mfcc")


def control(pcm: torch.Tensor, cfg: dict, band: dict | None = None) -> dict:
    """The control in the program's place: every output of one 1-D int16
    signal from the reference one precision below the configuration's."""
    out = features(pcm, cfg, "control")
    out.update(vad(out["energy"], out["zcr"], out["entropy"], cfg, "control",
                   device=pcm.device))
    if band is not None:
        out.update(pitch(pcm, out["vad"], cfg, band, "control"))
    return out


def _take(program: dict, k: str, n: int, shape: tuple):
    """The program's first ``n`` values of output ``k``, or None where it
    has fewer."""
    v = np.asarray(program.get(k, ()), np.float64)
    return v[:n] if v.shape[:1] and v.shape[0] >= n and v.shape[1:] == shape \
        else None


class Comparison:
    """Accumulates the compared numbers over items (signals, rows, clips or
    streams); :meth:`values` gives them."""

    def __init__(self, pitch: bool):
        self.pitch = pitch
        self.err = dict.fromkeys(FEATURES, 0.0)
        self.ref = dict.fromkeys(FEATURES, 0.0)
        self.frames = self.vad_diff = self.f0_diff = 0
        self.conf_maxerr = 0.0
        self.items = 0

    def add(self, program: dict, pcm: torch.Tensor, cfg: dict,
            band: dict | None, frames: int | None = None) -> None:
        """Judge one item: ``program`` maps output names to per-frame arrays
        of the signal ``pcm`` (1-D int16, on the device the reference runs
        on); its first ``frames`` frames (default all) are compared."""
        ref = features(pcm, cfg)
        n = len(ref["energy"]) if frames is None else int(frames)
        self.items += 1
        self.frames += n
        got = {}
        for k in FEATURES:
            r = ref[k][:n]
            p = _take(program, k, n, r.shape[1:])
            got[k] = p
            self.err[k] += float(((r if p is None else p - r) ** 2).sum())
            self.ref[k] += float((r ** 2).sum())
        decisions = {k: _take(program, k, n, ()) for k in ("vad", "vad_adaptive")}
        if any(got[k] is None for k in ("energy", "zcr", "entropy")) or \
                any(v is None for v in decisions.values()):
            self.vad_diff += 2 * n
            self.f0_diff += n if self.pitch else 0
            self.conf_maxerr = np.inf if self.pitch and n else self.conf_maxerr
            return
        want = vad(got["energy"], got["zcr"], got["entropy"], cfg,
                   device=pcm.device)
        for k, v in decisions.items():
            self.vad_diff += int((v != want[k][:n]).sum())
        if self.pitch:
            ref_p = pitch(pcm, decisions["vad"].astype(np.int32), cfg, band)
            f0 = _take(program, "f0", n, ())
            conf = _take(program, "confidence", n, ())
            if f0 is None or conf is None:
                self.f0_diff += n
                self.conf_maxerr = np.inf
                return
            self.f0_diff += int((f0.astype(np.float32) != ref_p["f0"]).sum())
            if n:
                self.conf_maxerr = max(self.conf_maxerr, float(
                    np.abs(conf - ref_p["confidence"]).max()))

    def values(self) -> dict:
        nmse = max((self.err[k] / self.ref[k] if self.ref[k] > 0 else
                    float(self.err[k] > 0)) for k in FEATURES)
        out = {"features_nmse": nmse,
               "vad_mismatch": self.vad_diff / max(2 * self.frames, 1)}
        if self.pitch:
            out["f0_mismatch"] = self.f0_diff / max(self.frames, 1)
            out["conf_maxerr"] = self.conf_maxerr
        return out
