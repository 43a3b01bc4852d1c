"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
root of the repository. Tests marked ``cuda`` need an NVIDIA GPU and skip
without one; whether there is one is decided inside the ``card`` fixture,
never while a module is imported."""

import pytest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return "cuda"
