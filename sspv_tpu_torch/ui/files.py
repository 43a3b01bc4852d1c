#!/usr/bin/env python3
"""Audio-file discovery helpers shared by the UI backends and main entry
(the reference keeps these inline in visualization.py:650-687 / main.py:56-76)."""

from __future__ import annotations

import os
from typing import List

from ..runtime.audio_source import SUPPORTED_EXTENSIONS

__all__ = ["default_audio_dir", "collect_audio_files"]


def default_audio_dir() -> str:
    """``sspv_tpu_torch/assets/audio_tests``, created on demand."""
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = os.path.join(pkg_dir, "assets", "audio_tests")
    os.makedirs(d, exist_ok=True)
    return d


def collect_audio_files(directory: str) -> List[str]:
    """Sorted supported-extension files directly inside ``directory``."""
    exts = {e.lower() for e in SUPPORTED_EXTENSIONS}
    out: List[str] = []
    if not directory or not os.path.isdir(directory):
        return out
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        if os.path.isfile(path) and os.path.splitext(name)[1].lower() in exts:
            out.append(path)
    return out
