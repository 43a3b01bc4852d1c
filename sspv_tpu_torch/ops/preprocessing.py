"""Framing of a 1-D signal into overlapping raw frames, in PyTorch.

Counterpart of ``sspv_tpu/ops/preprocessing.py:47-119``:

- ``num_frames_for``: the reference frame count ``1 + ceil((L - N)/H)``;
- ``frame_signal``: the batch contract, ``num_frames_for`` frames with the
  tail zero-padded;
- ``stream_frames``: the streaming engine's contract, full frames only.

Both run on the device of the signal. When ``frame_size % hop_size == 0``
the frames are ``frame_size // hop_size`` shifted slices of the
``(hops, hop)`` reshape, concatenated (strided copies); otherwise one gather.
"""

from __future__ import annotations

import math

import torch

__all__ = ["frame_signal", "num_frames_for", "stream_frames"]


def num_frames_for(signal_length: int, frame_size: int, hop_size: int) -> int:
    """The reference frame-count formula ``1 + ceil((L - N)/H)`` (clamped at
    0), preprocessing.py:74."""
    if frame_size <= 0 or hop_size <= 0 or signal_length == 0:
        return 0
    return max(0, 1 + math.ceil((signal_length - frame_size) / hop_size))


def _frames(x: torch.Tensor, n: int, frame_size: int,
            hop_size: int) -> torch.Tensor:
    """``n`` frames of ``x``, which holds at least ``(n-1)*hop + frame``
    samples."""
    if frame_size % hop_size == 0:
        k = frame_size // hop_size
        rows = x[: (n - 1 + k) * hop_size].reshape(n - 1 + k, hop_size)
        return torch.cat([rows[i : i + n] for i in range(k)], dim=1)
    idx = (torch.arange(frame_size, device=x.device)[None, :]
           + torch.arange(n, device=x.device)[:, None] * hop_size)
    return x[idx]


def frame_signal(signal: torch.Tensor, frame_size: int,
                 hop_size: int) -> torch.Tensor:
    """Overlapping zero-padded frames (no window) of a 1-D signal:
    ``(num_frames_for(len), frame_size)`` float32."""
    x = signal.to(torch.float32)
    n = num_frames_for(int(x.shape[0]), frame_size, hop_size)
    if n <= 0:
        return x.new_zeros((0, max(frame_size, 0)))
    pad_length = (n - 1) * hop_size + frame_size
    if pad_length > x.shape[0]:
        x = torch.nn.functional.pad(x, (0, pad_length - x.shape[0]))
    return _frames(x, n, frame_size, hop_size)


def stream_frames(signal: torch.Tensor, frame_size: int,
                  hop_size: int) -> torch.Tensor:
    """Streaming framing: only FULL frames, no tail padding (the live
    engine's rule, reference engine.py:240-242). Returns
    ``(num_full_frames, frame_size)`` float32."""
    x = signal.to(torch.float32)
    length = int(x.shape[0])
    if length < frame_size or frame_size <= 0 or hop_size <= 0:
        return x.new_zeros((0, max(frame_size, 0)))
    n = 1 + (length - frame_size) // hop_size
    return _frames(x, n, frame_size, hop_size)
