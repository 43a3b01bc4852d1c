"""Plain polyphase resampling of int16 PCM to the features' rate, in
float64: the resample Whisper's ``load_audio`` asks of ffmpeg before the
front end runs, here with the filter of SciPy's ``resample_poly``.

Written out from ``resample_poly``'s definition; nothing here imports the
port, ``jax`` or ``sspv_tpu``:

- the filter: ``firwin(2 * 10 * max(up, down) + 1, 1 / max(up, down),
  window=("kaiser", 5.0))`` for the reduced ratio ``up / down``, cast to
  float32 and multiplied by ``up`` in float32 (``resample_poly`` on float32
  input), then preceded by ``n_pre_pad = down - half_len % down`` zeros;
- ``upfirdn`` of the signal with it: output ``j`` of the filtered,
  upsampled-by-``up``, downsampled-by-``down`` signal is
  ``sum_s x[s] * hp[j * down - s * up]``, the signal zero outside its own
  samples;
- the ``ceil(n * up / down)`` outputs from ``n_pre_remove = (half_len +
  n_pre_pad) // down`` on, each clipped to [-32768, 32767] and truncated to
  int16 (``runtime/audio_source._resample_to`` of the upstream project).

Every product of an int16 and a float32 tap is exact in float64, and each
output's sum is a float64 ``sum`` over its taps, computed in blocks of
outputs on the signal's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BLOCK_OUTPUTS = 1 << 18


def ratio(src_rate: int, dst_rate: int) -> tuple[int, int]:
    """``(up, down)``: ``dst_rate / src_rate`` reduced."""
    g = math.gcd(int(src_rate), int(dst_rate))
    return int(dst_rate) // g, int(src_rate) // g


def taps(up: int, down: int) -> np.ndarray:
    """The float32 taps ``resample_poly`` designs for ``up / down``
    (reduced), times ``up``."""
    from scipy.signal import firwin

    most = max(up, down)
    h = firwin(2 * 10 * most + 1, 1.0 / most,
               window=("kaiser", 5.0)).astype(np.float32)
    return h * np.float32(up)


def output_len(n: int, up: int, down: int) -> int:
    """``ceil(n * up / down)``."""
    return -(-int(n) * up // down)


def resample(pcm: torch.Tensor, src_rate: int, dst_rate: int) -> torch.Tensor:
    """1-D int16 ``pcm`` at ``src_rate`` as int16 at ``dst_rate``, on its
    device."""
    up, down = ratio(src_rate, dst_rate)
    if up == down:
        return pcm.clone()
    dev = pcm.device
    half_len = 10 * max(up, down)
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    hp = torch.from_numpy(np.concatenate(
        [np.zeros(n_pre_pad), taps(up, down).astype(np.float64)])).to(dev)
    x = pcm.to(torch.float64)
    n = x.shape[0]
    n_out = output_len(n, up, down)
    out = torch.empty(n_out, dtype=torch.int16, device=dev)
    m = torch.arange(-(-hp.shape[0] // up), device=dev)
    for k0 in range(0, n_out, BLOCK_OUTPUTS):
        j = (torch.arange(k0, min(n_out, k0 + BLOCK_OUTPUTS), device=dev)
             + n_pre_remove) * down
        s = (j // up)[:, None] - m[None, :]
        t = (j % up)[:, None] + up * m[None, :]
        live = (s >= 0) & (s < n) & (t < hp.shape[0])
        prod = torch.where(live, x[s.clamp(0, max(n - 1, 0))]
                           * hp[t.clamp(max=hp.shape[0] - 1)], 0.0)
        out[k0 : k0 + j.shape[0]] = prod.sum(1).clamp(-32768.0, 32767.0).to(
            torch.int16)
    return out
