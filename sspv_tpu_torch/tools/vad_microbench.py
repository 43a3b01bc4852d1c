#!/usr/bin/env python3
"""Micro-benchmark of the streaming VAD's building blocks.

The pipeline runs the VAD stage as one kernel, K4 (``csrc/vad.cu``
through ``ops/vad_kernels.fused_streaming_vad``); its plain version is
tensor ops (``ops/vad.py``). K4 and the plain version's pieces are timed
alone, each at two shapes: the original's block (F = 32,768 frames,
history H = 256) and the hour's full-length call (the 359,999 frames of
3,600 s at 320/160, which the JAX package's full-length pass pads to
360,192, a multiple of H; the port's pipeline runs the 359,999 in the
blocked order and pads nothing):

  direct            the shipped window sums: ``unfold`` then ``sum``, float64
  blocked           ``_blocked_trailing_sums``, two-level block cumsums, float64
  conv1d            ``F.conv1d`` with a ones filter, float32 with TF32 off: a
                    yardstick the port uses nowhere (cuDNN)
  matmul            the ``unfold`` windows times a ones vector, float64
  cummax            ``vad._cummax``, the hangover's running max of indices
  vad_full_blocked  the plain ``streaming_vad`` with the pipeline's default
                    blocked sums
  vad_full_direct   the plain ``streaming_vad`` with ``trailing_impl="conv"``
  kernel            K4 (``fused_streaming_vad``) with the blocked sums, as
                    the pipeline runs it; the plain version off the card

    python -m sspv_tpu_torch.tools.vad_microbench [--device cuda]

One JSON line per piece and shape: ``time_us`` is the median CUDA-event
time of a call among 32 queued back to back (null off the card),
``host_us`` the host clock per call over the same 32 with one readback,
``launches`` the port's kernel launches of those calls; the sums carry
``max_rel_vs_direct``, the kernel line ``equal_to_plain`` (decisions and
state against the plain version on the same inputs). The original's
``reduce_window`` (``lax.reduce_window``) has no PyTorch counterpart: one
``not_ported`` line says so.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from ..utils.device import card_line, resolve_device, synchronize
from .length_probe import pipelined

HISTORY = 256
BLOCK_FRAMES = 32768
HOUR_FRAMES = 359_999  # 3,600 s at hop 160, frame 320
REPS = 32
SUMS = ("direct", "blocked", "conv1d", "matmul")
NOT_PORTED = {
    "reduce_window": "lax.reduce_window has no PyTorch counterpart; the "
                     "port's window sums are the direct unfold sum and the "
                     "blocked cumsums, both timed here",
}
GATES = dict(energy_threshold=1e9, zcr_threshold=0.3, entropy_voice_max=0.6,
             use_adaptive=True, adaptive_alpha=0.8)


def padded(frames: int, history: int = HISTORY) -> int:
    """``frames`` rounded up to a multiple of ``history``, as the JAX
    package's full-length VAD pass pads them."""
    return -(-frames // history) * history


def inputs(frames: int, device, history: int = HISTORY, seed: int = 0,
           valid_frames: int | None = None) -> dict:
    """The original's random inputs: ``ext`` (``history + frames`` float32
    window values), ``vadi`` (random decisions), and energy, zcr, entropy
    of ``frames`` frames; ``valid`` marks the first ``valid_frames``
    (None: all)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    out = {
        "ext": f32(np.abs(rng.normal(1e8, 5e9, (history + frames,)))),
        "vadi": torch.from_numpy(rng.integers(0, 2, (frames,)).astype(bool)
                                 ).to(device),
        "e": f32(np.abs(rng.normal(1e8, 5e9, (frames,)))),
        "z": f32(rng.uniform(0, 0.5, (frames,))),
        "h": f32(rng.uniform(0, 1, (frames,))),
        "valid": None,
    }
    if valid_frames is not None and valid_frames != frames:
        out["valid"] = torch.arange(frames, device=device) < valid_frames
    return out


@contextlib.contextmanager
def tf32_off():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def window_sums(name: str, ext: torch.Tensor, frames: int,
                history: int = HISTORY) -> torch.Tensor:
    """``sums[t] = ext[t:t+history].sum()`` for ``t < frames`` by one of
    ``SUMS``; ``ext`` is float32, the port's forms sum in float64."""
    from ..ops import vad

    if name == "direct":
        return vad._window_sums(ext.double(), frames, history, "conv")
    if name == "blocked":
        return vad._blocked_trailing_sums(ext.double(), frames, history)
    if name == "matmul":
        ones = torch.ones(history, dtype=torch.float64, device=ext.device)
        return ext.double().unfold(0, history, 1)[:frames] @ ones
    if name == "conv1d":
        ones = torch.ones((1, 1, history), dtype=torch.float32,
                          device=ext.device)
        with tf32_off():
            return torch.nn.functional.conv1d(ext[None, None], ones)[0, 0, :frames]
    raise ValueError(f"unknown window sum {name!r}")


def cummax(vadi: torch.Tensor) -> torch.Tensor:
    """The hangover's running max over the voiced frames' indices."""
    from ..ops import vad

    idx = torch.arange(vadi.shape[0], dtype=torch.int32, device=vadi.device)
    seeds = torch.where(vadi, idx, torch.full_like(idx, vad._NEG_LARGE))
    return vad._cummax(seeds)


def vad_full(x: dict, impl: str, kernel: bool = False):
    """The whole VAD on the inputs: the plain ``streaming_vad``, or with
    ``kernel`` K4 through its wrapper."""
    from ..ops import vad
    from ..ops.vad_kernels import fused_streaming_vad

    state = vad.initial_vad_state(HISTORY, device=x["e"].device)
    fn = fused_streaming_vad if kernel else vad.streaming_vad
    return fn(x["e"], x["z"], x["h"], state, valid=x["valid"],
              trailing_impl=impl, history_len=HISTORY, **GATES)


def same_vad(got, want) -> bool:
    """Decisions, adaptive decisions and every state field equal."""
    return all(torch.equal(a, b) for a, b in zip(got[:2], want[:2])) and \
        all(torch.equal(a, b) for a, b in zip(got[2], want[2]))


def bench(frames: int, device, valid_frames: int | None = None,
          reps: int = REPS) -> list[dict]:
    """Every piece at ``frames`` frames (``valid_frames`` of them real, the
    rest masked in the full VAD calls)."""
    device = resolve_device(device)
    card = card_line(device)
    x = inputs(frames, device, valid_frames=valid_frames)
    synchronize(device)
    base = {"F": frames, "H": HISTORY, "valid_frames": valid_frames or frames,
            "device": str(device), "card": card}
    lines = []

    def line(name, fn, dtype, extra=None):
        from ..ops import LAUNCHES

        fn()  # warm
        before = dict(LAUNCHES)
        host_s, ms = pipelined(lambda: fn().reshape(-1)[-1].double(), device,
                               reps)
        lines.append({"variant": name, **base, "dtype": dtype,
                      "time_us": None if ms is None else round(1e3 * ms, 2),
                      "host_us": round(1e6 * host_s, 2),
                      "launches": {k: v - before[k]
                                   for k, v in LAUNCHES.items()
                                   if v != before[k]},
                      **(extra or {})})

    ref = window_sums("direct", x["ext"], frames)
    for name in SUMS:
        got = window_sums(name, x["ext"], frames)
        rel = float(((got.double() - ref).abs()
                     / ref.abs().clamp_min(1.0)).max())
        line(name, lambda name=name: window_sums(name, x["ext"], frames),
             str(got.dtype).replace("torch.", ""),
             {"max_rel_vs_direct": float(f"{rel:.3e}")})
    line("cummax", lambda: cummax(x["vadi"]), "int32")
    for label, impl in (("vad_full_blocked", "blocked"),
                        ("vad_full_direct", "conv")):
        line(label, lambda impl=impl: vad_full(x, impl)[0],
             "float64 means, float32 comparisons")
    same = same_vad(vad_full(x, "blocked", kernel=True),
                    vad_full(x, "blocked"))
    line("kernel", lambda: vad_full(x, "blocked", kernel=True)[0],
         "float64 means, float32 comparisons", {"equal_to_plain": same})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sspv_tpu_torch.tools.vad_microbench")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--frames", type=int, nargs="*",
                    default=[BLOCK_FRAMES, HOUR_FRAMES],
                    help="frame counts (default: the block and the hour; "
                         "each is padded to a multiple of 256 and the "
                         "padding masked, as the JAX package's full-length "
                         "VAD pass does)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for frames in args.frames:
        for line in bench(padded(frames), device, valid_frames=frames):
            print(json.dumps(line), flush=True)
    print(json.dumps({"not_ported": NOT_PORTED, "device": str(device),
                      "card": card_line(device)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
