"""Speech-like int16 PCM made on the device from a seeded generator.

A recording is a sequence of segments: voiced stretches (45 % of segments,
0.08-0.4 s: a harmonic series of 8 partials with amplitudes 1/k below
0.45 sr, at an F0 drawn log-uniform from 80-300 Hz with a vibrato of 1-4 %
at 3-7 Hz, 1,500-8,000 peak), unvoiced noise bursts (15 %, 0.04-0.15 s,
Gaussian, 300-2,500 RMS) and pauses (40 %, 0.05-0.6 s), each with 5 ms
fades, over a Gaussian noise floor (RMS 40 by default: a microphone's
floor, which also keeps every mel band above float32 rounding). Every
value comes from ``gen`` in a fixed order of a few large calls, so one seed
gives one signal on one device.
"""

from __future__ import annotations

import math

import torch

KINDS = (0.45, 0.15, 0.40)  # voiced, unvoiced, pause
HARMONICS = 8


def speech(n_samples: int, sample_rate: int, gen: torch.Generator,
           floor_rms: float = 40.0) -> torch.Tensor:
    """``n_samples`` int16 samples on ``gen``'s device."""
    dev = gen.device
    sr = float(sample_rate)
    n_seg = int(n_samples / (0.04 * sr)) + 8  # every segment lasts >= 0.04 s
    kind = torch.multinomial(torch.tensor(KINDS, device=dev), n_seg,
                             replacement=True, generator=gen)
    u = torch.rand((6, n_seg), generator=gen, device=dev, dtype=torch.float64)
    dur_s = torch.where(kind == 0, 0.08 + 0.32 * u[0],
                        torch.where(kind == 1, 0.04 + 0.11 * u[0],
                                    0.05 + 0.55 * u[0]))
    dur = (dur_s * sr).long().clamp_min(1)
    ends = torch.cumsum(dur, 0)
    starts = ends - dur
    amp = torch.where(kind == 0, 1500 + 6500 * u[1],
                      torch.where(kind == 1, 300 + 2200 * u[1],
                                  torch.zeros_like(u[1])))
    f0 = torch.exp(math.log(80.0) + u[2] * math.log(300.0 / 80.0))
    vib_rate, vib_depth = 3 + 4 * u[3], 0.01 + 0.03 * u[4]
    vib_phase = 2 * math.pi * u[5]

    t = torch.arange(n_samples, device=dev)
    seg = torch.searchsorted(ends, t, right=True)
    pos = (t - starts[seg]).to(torch.float64)
    d = dur[seg].to(torch.float64)
    del t
    f = f0[seg] * (1 + vib_depth[seg] * torch.sin(
        2 * math.pi * vib_rate[seg] * pos / sr + vib_phase[seg]))
    phase = torch.remainder(torch.cumsum(2 * math.pi * f / sr, 0), 2 * math.pi)
    harm = torch.zeros(n_samples, device=dev, dtype=torch.float64)
    for k in range(1, HARMONICS + 1):
        harm += torch.where(k * f < 0.45 * sr, torch.sin(k * phase) / k, 0.0)
    del phase
    fade = (torch.minimum(pos, d - 1 - pos) / (0.005 * sr)).clamp(0, 1)
    k_seg = kind[seg]
    noise = torch.randn((2, n_samples), generator=gen, device=dev,
                        dtype=torch.float64)
    sig = amp[seg] * fade * torch.where(k_seg == 0, 0.6 * harm,
                                        torch.where(k_seg == 1, noise[0], 0.0))
    sig += floor_rms * noise[1]
    return sig.round().clamp(-32768, 32767).to(torch.int16)
