"""Pre-emphasis, and framing of a 1-D signal into overlapping frames, in
PyTorch.

Counterpart of ``sspv_tpu/ops/preprocessing.py:37-133``:

- ``preemphasis``: ``concat([x[0], x[1:] - alpha*x[:-1]])`` over the last
  axis, float32;
- ``framing``: ``frame_signal`` then the analysis window;
- ``num_frames_for``: the reference frame count ``1 + ceil((L - N)/H)``;
- ``frame_signal``: the batch contract, ``num_frames_for`` frames with the
  tail zero-padded;
- ``stream_frames``: the streaming engine's contract, full frames only.

All run on the device of the signal. When ``frame_size % hop_size == 0``
the frames are ``frame_size // hop_size`` shifted slices of the
``(hops, hop)`` reshape, concatenated (strided copies); otherwise one gather.
"""

from __future__ import annotations

import math

import torch

from .windows import get_window

__all__ = ["frame_signal", "framing", "num_frames_for", "preemphasis",
           "stream_frames"]


def preemphasis(signal: torch.Tensor, alpha: float = 0.97) -> torch.Tensor:
    """First-order high-pass pre-emphasis filter over the last axis."""
    x = signal.to(torch.float32)
    if x.shape[-1] == 0:
        return x
    # alpha as a float32 tensor: the product is float32 times float32
    a = torch.tensor(alpha, dtype=torch.float32, device=x.device)
    return torch.cat([x[..., :1], x[..., 1:] - a * x[..., :-1]], dim=-1)


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


def framing(signal: torch.Tensor, frame_size: int, hop_size: int,
            window_type: str = "hamming") -> torch.Tensor:
    """Frame (zero-padded tail) and window a 1-D signal:
    ``(num_frames_for(len), frame_size)`` float32."""
    frames = frame_signal(signal, frame_size, hop_size)
    if frames.shape[0] == 0:
        return frames
    window = torch.from_numpy(get_window(window_type, frame_size))
    return frames * window.to(frames.device)
