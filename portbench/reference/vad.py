"""The upstream engine's composite voice-activity decision with hangover
(``real_time_voice_processing/engine.py`` of the upstream project), written
out again: per frame ``t`` of a stream that starts from nothing,

1. ``initial = E > T_E and (Z < T_Z or H < T_H)``, the fixed gates, with
   the features as float32 values compared with Python floats (float64);
2. ``adaptive = E > th_e and Z < th_z``, where ``th_e = max(a m_E + (1-a)
   E, 1e-6)`` and ``th_z = min(a m_Z + (1-a) Z, 0.5)``, ``m`` the mean of
   the previous ``min(t, history_len)`` frames' float32 features (the frame
   itself where there is none) summed in float64, ``a = min(alpha, 0.99)``;
   the comparison is the float32 feature against the threshold rounded to
   float32 (NumPy compares a float32 array with a Python float in float32);
3. with the adaptive VAD on: ``initial |= adaptive`` (``&=`` in the "and"
   composite mode);
4. the hangover automaton: a voiced frame sets ``hold = max(hold, ON)``
   and outputs 1; otherwise a positive ``hold`` counts down and outputs 1;
   otherwise the silence run grows and the output is 1 until it reaches
   ``OFF``; ``hold`` and the run start at 0.

The features enter as float64 (the reference's own) and are rounded to
float32, as the upstream engine stores them. ``precision="control"`` sums
and blends the history in float32 (one step below the float64 the
configuration states).
"""

from __future__ import annotations

import numpy as np
import torch


def hangover(initial: np.ndarray, on: int, off: int) -> np.ndarray:
    hold = run = 0
    out = np.zeros(len(initial), dtype=np.int32)
    for t, v in enumerate(initial.tolist()):
        if v:
            hold, run, out[t] = max(hold, on), 0, 1
        elif hold > 0:
            hold, run, out[t] = hold - 1, 0, 1
        else:
            run += 1
            out[t] = 0 if run >= off else 1
    return out


def _trailing_means(v32: torch.Tensor, h: int, dtype) -> torch.Tensor:
    n = v32.shape[0]
    ext = torch.cat([v32.new_zeros(h), v32]).to(dtype)
    sums = ext.unfold(0, h, 1)[:n].sum(dim=1)
    counts = torch.arange(n, device=v32.device).clamp_max(h).to(dtype)
    return torch.where(counts > 0, sums / counts.clamp_min(1), v32.to(dtype))


def vad(energy: np.ndarray, zcr: np.ndarray, entropy: np.ndarray, cfg: dict,
        precision: str = "float64", device="cpu") -> dict:
    """``vad`` and ``vad_adaptive`` (int32 numpy) of one stream's features
    (float64 numpy arrays) under the configuration's VAD settings."""
    dtype = torch.float64 if precision == "float64" else torch.float32
    e32, z32, h32 = (torch.as_tensor(np.asarray(v, np.float32), device=device)
                     for v in (energy, zcr, entropy))
    h = cfg["history_len"]
    a = max(0.0, min(float(cfg["adaptive_alpha"]), 0.99))
    e, z = e32.to(dtype), z32.to(dtype)
    th_e = (a * _trailing_means(e32, h, dtype) + (1 - a) * e).clamp_min(1e-6)
    th_z = (a * _trailing_means(z32, h, dtype) + (1 - a) * z).clamp_max(0.5)
    adaptive = (e32 > th_e.to(torch.float32)) & (z32 < th_z.to(torch.float32))
    e64, z64, h64 = (v.to(torch.float64) for v in (e32, z32, h32))
    initial = (e64 > cfg["energy_threshold"]) & (
        (z64 < cfg["zcr_threshold"]) | (h64 < cfg["entropy_voice_max"]))
    if cfg["use_adaptive_vad"]:
        if cfg.get("composite_mode", "or") == "and":
            initial = initial & adaptive
        else:
            initial = initial | adaptive
    return {"vad": hangover(initial.cpu().numpy(), cfg["hangover_on"],
                            cfg["release_off"]),
            "vad_adaptive": adaptive.cpu().numpy().astype(np.int32)}
