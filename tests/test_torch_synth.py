#!/usr/bin/env python3
"""The port's copies of the benchmark script's synthetic signal and NumPy
oracle (``sspv_tpu_torch/utils/synth.py``) against the originals in
``bench.py``: bit-identical, so the port's smoke run checks the same audio
against the same reference without importing anything outside the port."""

import numpy as np
import pytest

import bench
from sspv_tpu_torch.utils import synth


@pytest.mark.parametrize("seconds,seed", [(0.5, 0), (3.0, 0), (2.25, 7)])
def test_synth_signal_equals_bench(seconds, seed):
    got = synth.synth_signal(seconds, 16000, seed)
    want = bench.synth_signal(seconds, 16000, seed)
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("seconds", [0.02, 2.0])
def test_oracle_features_equal_bench(seconds):
    sig = bench.synth_signal(max(seconds, 1.0))[: int(seconds * 16000)]
    got, want = synth.oracle_features(sig), bench._oracle_features(sig)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("scale", [0.0, 1e-3, 1.0])
def test_nmse_equals_bench(scale):
    rng = np.random.default_rng(3)
    want = rng.normal(0, 100, (50, 13)).astype(np.float32)
    got = want + scale * rng.normal(0, 1, want.shape).astype(np.float32)
    assert synth.nmse(got, want) == bench._nmse(got, want)
    assert synth.nmse(got, np.zeros_like(want)) == bench._nmse(got, np.zeros_like(want))
