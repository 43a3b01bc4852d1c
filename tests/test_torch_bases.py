#!/usr/bin/env python3
"""The port's NumPy constants are bit-identical to the JAX package's.

``sspv_tpu_torch`` keeps its own copies of the host-built windows and bases
(importing anything under ``sspv_tpu`` imports jax), so every function is
held ``np.array_equal`` to its original here, at the default geometry and at
a second one (frame 400 / hop 200 / n_fft 1024 / 40 filters / 20 cepstra).
"""

import numpy as np
import pytest

from sspv_tpu.ops import bases as jbases
from sspv_tpu.ops import time_features as jtf
from sspv_tpu.ops import windows as jwindows
from sspv_tpu.ops.pipeline import FeatureConfig as JConfig
from sspv_tpu.ops.pipeline import FeaturePipeline as JPipeline
from sspv_tpu.ops.pitch import _lag_band as j_lag_band

from sspv_tpu_torch.ops import bases as tbases
from sspv_tpu_torch.ops import time_features as ttf
from sspv_tpu_torch.ops import windows as twindows
from sspv_tpu_torch.ops.pipeline import ACF_CONSTANTS, FEATURE_CONSTANTS
from sspv_tpu_torch.ops.pipeline import FeatureConfig as TConfig
from sspv_tpu_torch.ops.pipeline import FeaturePipeline as TPipeline
from sspv_tpu_torch.ops.pitch import _lag_band as t_lag_band

GEOMETRIES = {
    "default": dict(frame_size=320, hop_size=160, n_fft=512, num_filters=26,
                    num_ceps=13, lifter=22, sample_rate=16000),
    "400_200_1024": dict(frame_size=400, hop_size=200, n_fft=1024,
                         entropy_n_fft=1024,
                         num_filters=40, num_ceps=20, lifter=22,
                         sample_rate=16000),
}


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["hamming", "hanning", "rect", "unknown"])
@pytest.mark.parametrize("length", [0, 1, 2, 320, 400])
def test_windows(kind, length):
    _same(twindows.get_window(kind, length), jwindows.get_window(kind, length))


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_dft_bases(geom):
    g = GEOMETRIES[geom]
    frame, n_fft = g["frame_size"], g["n_fft"]
    for window in ("hamming", "hanning"):
        for got, want in zip(
            tbases.windowed_dft_bases(frame, n_fft, window),
            jbases.windowed_dft_bases(frame, n_fft, window),
        ):
            _same(got, want)
        for got, want in zip(
            tbases.merged_windowed_dft_bases(frame, n_fft, window),
            jbases.merged_windowed_dft_bases(frame, n_fft, window),
        ):
            _same(got, want)


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_mel_dct_lifter(geom):
    g = GEOMETRIES[geom]
    _same(
        tbases.mel_filterbank_np(g["num_filters"], g["n_fft"], g["sample_rate"]),
        jbases.mel_filterbank_np(g["num_filters"], g["n_fft"], g["sample_rate"]),
    )
    _same(tbases.dct_ortho_matrix(g["num_filters"], g["num_ceps"]),
          jbases.dct_ortho_matrix(g["num_filters"], g["num_ceps"]))
    for lifter in (g["lifter"], 0, None):
        _same(tbases.lifter_vector(g["num_ceps"], lifter),
              jbases.lifter_vector(g["num_ceps"], lifter))


@pytest.mark.parametrize("geom", list(GEOMETRIES))
@pytest.mark.parametrize("band", [(50.0, 400.0), (80.0, 300.0)])
def test_acf_bases(geom, band):
    g = GEOMETRIES[geom]
    sr, frame = g["sample_rate"], g["frame_size"]
    lags = t_lag_band(sr, band[0], band[1], frame)
    assert lags == j_lag_band(sr, band[0], band[1], frame)
    for got, want in zip(ttf._acf_dft_bases(frame, lags[1]),
                         jtf._acf_dft_bases(frame, lags[1])):
        _same(got, want)
    for got, want in zip(ttf._acf_dft_bases_merged(frame, lags[1]),
                         jtf._acf_dft_bases_merged(frame, lags[1])):
        _same(got, want)


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_pipeline_constants_equal_jax_attributes(geom):
    """``FeaturePipeline.constants()`` hands back exactly the JAX pipeline's
    bases (and the default band's ACF bases), after a round trip through
    the device tensors."""
    g = GEOMETRIES[geom]
    tp = TPipeline(TConfig(**g), device="cpu")
    jp = JPipeline(JConfig(**g))
    got = tp.constants()
    for k in FEATURE_CONSTANTS:
        _same(got[k], getattr(jp, "_" + k))
    lag_max = j_lag_band(g["sample_rate"], 50.0, 400.0, g["frame_size"])[1]
    for k, want in zip(ACF_CONSTANTS,
                       jtf._acf_dft_bases_merged(g["frame_size"], lag_max)):
        _same(got[k], want)
