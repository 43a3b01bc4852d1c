"""The device a harness runs on, and the line that names it.

The example harnesses (``sspv_tpu_torch.examples``) and the tools
(``sspv_tpu_torch.tools``) take ``--device`` (default ``cuda``). Asking for
the card where there is none raises: nothing carries on on the CPU unless
the caller asks for it with ``--device cpu``.
"""

from __future__ import annotations

import subprocess

import torch

__all__ = ["card_line", "resolve_device", "synchronize"]


def resolve_device(name) -> torch.device:
    """``torch.device(name)``; raises for a CUDA device where there is none."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(name)!r}: no CUDA device here "
                           "(pass --device cpu to run on the CPU)")
    return device


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (the first card's line
    for ``cuda``, the numbered one for ``cuda:i``), or the device's name
    for any other device. Every time a harness prints stands beside it: a
    card set below its maximum power runs slower under load."""
    device = torch.device(device)
    if device.type != "cuda":
        return str(device)
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return lines[device.index or 0]


def synchronize(device) -> None:
    """Wait for the work queued on a CUDA device; nothing to wait for on
    another device."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
