#!/usr/bin/env python3
"""The batch programs at a source rate, on the CPU: ``process_batch_masked``,
``process_batch_masked_pitch`` and ``_exact_batch`` with ``source_rate``
resample each device's int16 rows first (K5's plain version here) and are
then, bit for bit, the same call on the resampled rows; without a source
rate, or at the configuration's own, nothing is resampled. The whole chain
is held to the benchmark's plain reference (``portbench/reference``: its
own float64 resample, then the features) at the benchmark's limits."""

import numpy as np
import pytest
import torch

from sspv_tpu_torch.ops import resample as tres
from sspv_tpu_torch.ops.pipeline import FeatureConfig
from sspv_tpu_torch.parallel import BatchPipeline, make_mesh
from sspv_tpu_torch.parallel import mesh as tmesh

WHISPER = FeatureConfig(frame_size=400, hop_size=160, window_type="hanning",
                        n_fft=400, entropy_n_fft=400, num_filters=80)
SRC = 48000


def _rows(seed: int, seconds: float = 1.5):
    """Four int16 rows at 48 kHz: tones with harmonics up to 0.45 of the
    rate over a noise floor, zero past unequal lengths (whole, one ``down``
    does not divide, a short one, one shorter than a frame at 16 kHz)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SRC)
    t = np.arange(n) / SRC
    f0 = rng.uniform(90, 250, (4, 1))
    k = np.arange(1, 9)[:, None, None]
    harm = np.where(k * f0 < 0.45 * SRC, np.sin(2 * np.pi * k * f0 * t) / k,
                    0).sum(0)
    x = (rng.normal(0, 40, (4, n)) + 4000 * harm * (t * 3 % 1 < 0.6))
    x = x.clip(-32768, 32767).astype(np.int16)
    lengths = np.array([n, n - 1, n // 2 + 7, 1000])
    x[np.arange(n)[None, :] >= lengths[:, None]] = 0
    return x, lengths


def _at16(x, lengths):
    """The rows resampled to 16 kHz by the plain version, and their
    lengths."""
    y = tres.plain_resample_rows_int16(torch.from_numpy(x), lengths, 1, 3)
    return y.numpy(), -(-lengths // 3)


def _flat(out):
    flat = []
    for t in out:
        if t is None:
            continue
        flat.extend(t if isinstance(t, tuple) else (t,))
    return flat


CALLS = {
    "masked": lambda bp, s, n, **kw: bp.process_batch_masked(s, n, **kw),
    "pitch": lambda bp, s, n, **kw: bp.process_batch_masked_pitch(s, n, **kw),
    "exact": lambda bp, s, n, **kw: bp._exact_batch(s, n, 256, None, **kw),
    "exact_pitch": lambda bp, s, n, **kw: bp._exact_batch(
        s, n, 512, (50.0, 400.0), **kw),
}


@pytest.mark.parametrize("devices", [1, 8])
@pytest.mark.parametrize("call", list(CALLS))
def test_batch_programs_at_48k_are_the_calls_on_the_resampled_rows(call,
                                                                   devices):
    bp = BatchPipeline(make_mesh(devices, device="cpu"), WHISPER)
    x, lengths = _rows(devices)
    y, out_lengths = _at16(x, lengths)
    got = _flat(CALLS[call](bp, x, lengths, source_rate=SRC))
    want = _flat(CALLS[call](bp, y, out_lengths))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # a tensor of rows takes the same path
    again = _flat(CALLS[call](bp, torch.from_numpy(x), lengths,
                              source_rate=SRC))
    for a, b in zip(again, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rate", [None, 16000])
@pytest.mark.parametrize("call", list(CALLS))
def test_no_source_rate_resamples_nothing(call, rate, monkeypatch):
    bp = BatchPipeline(make_mesh(1, device="cpu"), WHISPER)
    x, lengths = _rows(3, 0.5)
    y, out_lengths = _at16(x, lengths)
    ran = []
    monkeypatch.setattr(tmesh, "resample_rows_int16",
                        lambda *a, **k: ran.append(a) or tres.resample_rows_int16(
                            *a, **k))
    kw = {} if rate is None else {"source_rate": rate}
    got = _flat(CALLS[call](bp, y, out_lengths, **kw))
    assert not ran
    want = _flat(CALLS[call](bp, y, out_lengths))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    CALLS[call](bp, x, lengths, source_rate=SRC)
    assert len(ran) == 1


def test_rows_at_a_source_rate_must_be_int16():
    bp = BatchPipeline(make_mesh(1, device="cpu"), WHISPER)
    x, lengths = _rows(4, 0.2)
    with pytest.raises(ValueError):
        bp.process_batch_masked(x.astype(np.float32), lengths,
                                source_rate=SRC)


@pytest.mark.parametrize("bad", [-1, "past", "count"])
def test_source_lengths_outside_the_rows_raise(bad):
    bp = BatchPipeline(make_mesh(1, device="cpu"), WHISPER)
    x, lengths = _rows(4, 0.2)
    if bad == "count":
        lengths = lengths[:-1]
    else:
        lengths[1] = -1 if bad == -1 else x.shape[1] + 1
    with pytest.raises(ValueError, match="lengths must be"):
        bp.process_batch_masked(x, lengths, source_rate=SRC)


def test_whole_chain_within_the_benchmark_reference():
    """The port's 48 kHz chain against ``portbench/reference`` (its own
    float64 resample of each row's true samples, then the float64
    features and the VAD automaton over the port's features): within the
    benchmark cell's limits, ``features_nmse`` <= 1e-9 and
    ``vad_mismatch`` 0."""
    import json
    from pathlib import Path

    from portbench.reference import resample as ref
    from portbench.reference.compare import Comparison

    path = (Path(__file__).resolve().parents[1] / "portbench" / "configs"
            / "whisper-frontend-48k.json")
    config = json.loads(path.read_text())
    cfg = config["feature_config"]
    assert config["source_rate"] == SRC
    bp = BatchPipeline(make_mesh(1, device="cpu"), FeatureConfig(**cfg))
    cmp = Comparison(pitch=False)
    for seed in (5, 6):
        x, lengths = _rows(seed, 2.0)
        block = bp.process_batch_masked(x, lengths, source_rate=SRC)[0]
        for r, n in enumerate(lengths):
            pcm = ref.resample(torch.from_numpy(x[r, :n]), SRC, 16000)
            frames = (0 if pcm.shape[0] < cfg["frame_size"] else
                      1 + (pcm.shape[0] - cfg["frame_size"]) // cfg["hop_size"])
            prog = {k: getattr(block, k)[r].numpy() for k in
                    ("energy", "zcr", "entropy", "mfcc", "vad", "vad_adaptive")}
            cmp.add(prog, pcm, cfg, None, frames)
    values = cmp.values()
    assert cmp.frames > 300
    assert values["features_nmse"] <= 1e-9, values
    assert values["vad_mismatch"] == 0, values
