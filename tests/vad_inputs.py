"""Per-frame VAD inputs, made with NumPy from a seed: the inputs of
``test_torch_vad.py``, ``test_torch_vad_gate.py``,
``test_torch_vad_kernel.py``, of K4's rehearsal on the CPU
(``test_torch_kernels_on_cpu.py``), of its tests on the card
(``test_torch_cuda.py``) and of ``chip_smoke.py``. NumPy and PyTorch only,
so that the card's machine (no JAX) imports it too.

- ``synth_features``: energy, zcr and entropy with runs of voiced and
  silent frames;
- ``vad_rows`` and ``row_mask``: ``B`` rows of them, each with its own
  state, and masks per row;
- the float32 threshold ties (``TIES``): each function gives ``(energy,
  zcr, entropy)``, float32, ``N`` frames, for the engine's gates with
  ``adaptive_alpha`` 3.0 (clamped to ``ALPHA``): the float64 threshold of
  frame ``TIE`` (of frame 256 for the full history) lies strictly between
  the feature and its float32 neighbour.
"""

import numpy as np
import torch

from sspv_tpu_torch.ops import vad as tvad

GATES = dict(energy_threshold=1000.0, zcr_threshold=0.3,
             entropy_voice_max=0.65, use_adaptive=True, adaptive_alpha=3.0)
ALPHA = 0.99  # adaptive_alpha 3.0 clamped, as the engine does
F32 = np.float32
N = 512  # two blocks of history_len: the blocked sums take the whole call
TIE = 4  # the frame whose threshold ties


def ulp(x) -> F32:
    return np.spacing(F32(x))


def zcr_tie():
    """Four frames of history whose zcr mean is z + ulp/4, then a loud
    frame with zcr z: its float64 threshold z + 0.2475 ulp lies strictly
    between z and the next float32. Every other frame decides clearly:
    falling energies keep the adaptive gate shut, and all stay below the
    fixed energy gate."""
    z = F32(11 / 512)
    e, zc = np.empty(N, F32), np.empty(N, F32)
    e[:TIE], zc[:TIE] = [120, 110, 105, 101], [z, z, z + ulp(z), z]
    e[TIE], zc[TIE] = 500, z
    e[TIE + 1:] = F32(90) - F32(0.125) * np.arange(N - TIE - 1, dtype=F32)
    zc[TIE + 1:] = 0.4
    return e, zc, np.full(N, 0.9, F32)


def energy_tie():
    """The same for the energy: a history whose mean is e - ulp/4 gives a
    float64 threshold e - 0.2475 ulp, strictly between e's float32
    neighbour below and e; its zcr passes clearly."""
    es = F32(800)
    e, zc = np.empty(N, F32), np.empty(N, F32)
    e[:TIE], zc[:TIE] = [es, es, es - ulp(es), es], [0.40, 0.42, 0.44, 0.46]
    e[TIE], zc[TIE] = es, 0.05
    e[TIE + 1:] = F32(400) - F32(0.125) * np.arange(N - TIE - 1, dtype=F32)
    zc[TIE + 1:] = 0.4
    return e, zc, np.full(N, 0.9, F32)



def full_history_tie():
    """A full history (256 frames) of zcr 7/320 in float32, 40 of them one
    float32 above: the threshold of the next frame at zcr 7/320 is
    0.0218749999156 against a feature of 0.0218749996275, the shape of the
    tie a test WAV showed (0.021875 against 0.0218750002860)."""
    z = F32(7 / 320)
    e, zc = np.empty(N, F32), np.full(N, z, F32)
    e[:256] = F32(900) - F32(0.5) * np.arange(256, dtype=F32)
    zc[256 - 40:256] = z + ulp(z)
    e[256] = 950
    e[257:] = F32(600) - F32(0.5) * np.arange(N - 257, dtype=F32)
    zc[257:] = 0.4
    return e, zc, np.full(N, 0.9, F32)


TIES = {"zcr_tie": zcr_tie, "energy_tie": energy_tie,
        "full_history_tie": full_history_tie}


def synth_features(n, seed):
    """Per-frame features with runs of voiced and silent frames."""
    rng = np.random.default_rng(seed)
    voiced = rng.random(n) < 0.35
    for i in range(1, n):
        if voiced[i - 1] and rng.random() < 0.6:
            voiced[i] = True
    energy = np.where(voiced, rng.uniform(2e3, 1e7, n),
                      rng.uniform(0, 900, n)).astype(np.float32)
    zcr = np.where(voiced, rng.uniform(0.01, 0.25, n),
                   rng.uniform(0.2, 0.5, n)).astype(np.float32)
    entropy = np.where(voiced, rng.uniform(0.2, 0.6, n),
                       rng.uniform(0.6, 1.0, n)).astype(np.float32)
    return energy, zcr, entropy


def vad_rows(b: int, f: int, seed: int, history_len: int = 256,
             device="cpu"):
    """``b`` rows of ``synth_features`` (float32 ``(b, f)`` tensors on
    ``device``) and a state per row: a history that is full, empty or in
    between (zero-padded at the front, as carried), and a last voiced
    frame near, far, or drifted below -2**30 by a long silence."""
    rng = np.random.default_rng(seed)
    feats = [synth_features(f, seed + 1 + r) for r in range(b)]
    e, z, h = (np.stack(x) for x in zip(*feats))
    hist = [synth_features(history_len, seed + 100 + r) for r in range(b)]
    ebuf = np.stack([x[0] for x in hist])
    zbuf = np.stack([x[1] for x in hist])
    count = np.array([history_len, 0, 17, history_len - 1]
                     + list(rng.integers(0, history_len + 1, b)), np.int32)[:b]
    for r, c in enumerate(count):
        ebuf[r, : history_len - c] = 0.0
        zbuf[r, : history_len - c] = 0.0
    last = np.array([-4, -1, -300, -(2**30) - 5000]
                    + list(rng.integers(-600, 0, b)), np.int32)[:b]
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return (t(e), t(z), t(h),
            tvad.VadState(t(ebuf), t(zbuf), t(count), t(last)))


def row_mask(kind: str, b: int, f: int, seed: int, device="cpu"):
    """None (``kind`` "none"), a prefix mask per row ("prefix": 0 and f
    among the counts), or a mask with holes ("holes")."""
    if kind == "none":
        return None
    rng = np.random.default_rng(seed)
    if kind == "prefix":
        n = ([0, f, f // 2] + list(rng.integers(0, f + 1, b)))[:b]
        if b == 1:
            n = [f // 2]
        return (torch.arange(f, device=device)[None, :]
                < torch.tensor(n, device=device)[:, None])
    return torch.from_numpy(rng.random((b, f)) < 0.7).to(device)
