#!/usr/bin/env python3
"""The port's HTTP service (``sspv_tpu_torch.serve``) against the JAX
package's (``sspv_tpu.serve``), on the CPU.

Two servers run in this process: the JAX one as ``tests/test_serve.py``
starts it (the JAX CPU backend), and the port's over
``FeatureService(device="cpu")`` (the kernels' plain versions). The same
requests, built from a seed with NumPy, go to both. Tolerances, those of
``tests/test_torch_pipeline.py``: zcr, vad, vad_adaptive and f0 EQUAL;
energy, entropy, mfcc and pitch_confidence NMSE <= 1e-9 (both float32,
different summation order); status codes, content types, meta fields, npz
keys and dtypes, and error messages EQUAL, but for the package name in the
413 text; ``/config`` equal. Then the server-only cases of
``tests/test_serve.py`` on the port's server, and the launch counters under
threads.
"""

import http.client
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import types
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import sspv_tpu.serve as jserve
import sspv_tpu_torch.serve as tserve
from sspv_tpu_torch.config import Config
from sspv_tpu_torch.ops import _build
from sspv_tpu_torch.ops.pitch import pitch_track

REPO = Path(__file__).resolve().parents[1]
SR = 16000
NMSE_KEYS = {"energy", "entropy", "mfcc", "pitch_confidence"}
TIMEOUT_S = 120


def _nmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


def speech(seconds, seed, rate=SR):
    """Noise, a 130 Hz tone and loud noise in alternating quarter seconds."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    seg = (t * 4).astype(int) % 3
    sig = rng.normal(0, 40, n)
    sig = np.where(seg == 1, 6000 * np.sin(2 * np.pi * 130 * t), sig)
    sig = np.where(seg == 2, rng.normal(0, 2000, n), sig)
    return np.clip(sig, -32768, 32767).astype(np.int16)


def wav_bytes(samples, rate=SR, channels=1, width=2):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(samples.tobytes())
    return buf.getvalue()


SIG = speech(3.0, seed=0)
WAV = wav_bytes(SIG)
STEREO_44K = np.stack([speech(2.0, 1, 44100), speech(2.0, 2, 44100)], 1)
SIG_8K = speech(3.0, seed=3, rate=8000)
RAW = "application/octet-stream"


def _start(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


@pytest.fixture(scope="module")
def servers():
    """``(port's server, JAX server)``, each on its own thread."""
    ours = _start(tserve.make_server(
        "127.0.0.1", 0, tserve.FeatureService(device="cpu")))
    theirs = _start(jserve.make_server("127.0.0.1", 0))
    yield ours, theirs
    for srv in (ours, theirs):
        srv.shutdown()
        srv.server_close()


@pytest.fixture(scope="module")
def server(servers):
    return servers[0]


def send(server, method, path, body=b"", headers=None, chunk_samples=None,
         raw=None):
    """One request on a fresh connection: a plain body, the body as chunks
    of ``chunk_samples`` int16 samples (Transfer-Encoding: chunked), or
    ``raw`` bytes after chunked headers. Returns ``(status, content type,
    body)``; the client decodes a chunked response."""
    host, port = server.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=TIMEOUT_S)
    try:
        if raw is None and chunk_samples is None:
            conn.request(method, path, body=body, headers=headers or {})
        else:
            conn.putrequest(method, path)
            for k, v in {"Content-Type": RAW, **(headers or {})}.items():
                conn.putheader(k, v)
            conn.putheader("Transfer-Encoding", "chunked")
            conn.endheaders()
            if raw is None:
                step = 2 * chunk_samples
                for lo in range(0, len(body), step):
                    piece = body[lo : lo + step]
                    conn.send(f"{len(piece):x}\r\n".encode() + piece + b"\r\n")
                raw = b"0\r\n\r\n"
            conn.send(raw)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def parse(ctype, body):
    if ctype == "application/json":
        return json.loads(body)
    if ctype == "application/x-ndjson":
        return [json.loads(line) for line in body.decode().splitlines()
                if line.strip()]
    if ctype == "application/octet-stream":
        with np.load(io.BytesIO(body)) as z:
            return {k: z[k] for k in z.files}
    return body.decode()


def assert_field(key, got, want, where):
    if key == "error":
        assert got.replace("sspv_tpu_torch", "sspv_tpu") == want, where
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (where, key, g.shape, w.shape)
    if isinstance(got, np.ndarray):  # an npz field
        assert g.dtype == w.dtype, (where, key, g.dtype, w.dtype)
    if key in NMSE_KEYS and w.size:
        assert _nmse(g, w) <= 1e-9, (where, key, _nmse(g, w))
    else:
        assert np.array_equal(g, w), (where, key)


def assert_same(got, want, where):
    if isinstance(want, list):  # NDJSON rows
        assert len(got) == len(want), (where, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where} row {i}")
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), (where, sorted(got), sorted(want))
        for k in want:
            assert_field(k, got[k], want[k], where)
    else:
        assert got == want, where


# name -> (method, path, keyword arguments of ``send``, expected status)
PARITY = {
    # every endpoint and format on the 3 s 16 kHz WAV
    "features_wav": ("POST", "/v1/features", dict(body=WAV), 200),
    "vad_wav": ("POST", "/v1/vad", dict(body=WAV), 200),
    "pitch_default_band": ("POST", "/v1/pitch", dict(body=WAV), 200),
    "pitch_custom_band": ("POST", "/v1/pitch?fmin=80&fmax=300",
                          dict(body=WAV), 200),
    "pitch_strict_confidence": ("POST", "/v1/pitch?min_confidence=0.99",
                                dict(body=WAV), 200),
    "pitch_negative_confidence": ("POST", "/v1/pitch?min_confidence=-1",
                                  dict(body=WAV), 200),
    "features_npz": ("POST", "/v1/features?fmt=npz", dict(body=WAV), 200),
    "vad_npz": ("POST", "/v1/vad?fmt=npz", dict(body=WAV), 200),
    "pitch_npz": ("POST", "/v1/pitch?fmt=npz", dict(body=WAV), 200),
    # the decode ladder: resample and downmix, raw PCM, a short input
    "features_stereo_44k": ("POST", "/v1/features", dict(
        body=wav_bytes(STEREO_44K, 44100, channels=2)), 200),
    "pitch_stereo_44k": ("POST", "/v1/pitch", dict(
        body=wav_bytes(STEREO_44K, 44100, channels=2)), 200),
    "vad_raw_rate_header": ("POST", "/v1/vad", dict(
        body=SIG.tobytes(), headers={"Content-Type": RAW,
                                     "X-Sample-Rate": str(SR)}), 200),
    "features_raw_rate_query_8k": ("POST", "/v1/features?rate=8000", dict(
        body=SIG_8K.tobytes(), headers={"Content-Type": RAW}), 200),
    "features_shorter_than_a_frame": ("POST", "/v1/features", dict(
        body=wav_bytes(SIG[:100])), 200),
    "features_32bit_wav": ("POST", "/v1/features", dict(
        body=wav_bytes((SIG.astype(np.int32) << 16) - 7, width=4)), 200),
    # the stream, chunked in 1000 samples or as one body
    "stream": ("POST", "/v1/stream", dict(body=SIG.tobytes(),
                                          chunk_samples=1000), 200),
    "stream_mfcc": ("POST", "/v1/stream?mfcc=1", dict(
        body=SIG.tobytes(), chunk_samples=1000), 200),
    "stream_pitch": ("POST", "/v1/stream?pitch=1&min_confidence=0.4", dict(
        body=SIG.tobytes(), chunk_samples=1000), 200),
    "stream_pitch_mfcc": ("POST", "/v1/stream?pitch=1&mfcc=1", dict(
        body=SIG.tobytes(), chunk_samples=3000), 200),
    "stream_single_body": ("POST", "/v1/stream?mfcc=1", dict(
        body=SIG[:12800].tobytes(), headers={"Content-Type": RAW,
                                             "X-Sample-Rate": str(SR)}), 200),
    "get_config": ("GET", "/config", {}, 200),
    # every error path of tests/test_serve.py, and a few more
    "features_not_audio": ("POST", "/v1/features", dict(
        body=b"not audio at all", headers={"Content-Type": "audio/wav"}), 400),
    "features_empty_body": ("POST", "/v1/features", dict(
        body=b"", headers={"Content-Type": "audio/wav"}), 400),
    "post_unknown_path": ("POST", "/v1/nope", dict(body=WAV), 404),
    "get_unknown_path": ("GET", "/nope", {}, 404),
    "features_raw_without_rate": ("POST", "/v1/features", dict(
        body=SIG.tobytes(), headers={"Content-Type": RAW}), 400),
    "features_bad_rate_header": ("POST", "/v1/features", dict(
        body=SIG.tobytes(), headers={"Content-Type": RAW,
                                     "X-Sample-Rate": "abc"}), 400),
    "features_unsupported_type": ("POST", "/v1/features", dict(
        body=b"x" * 10, headers={"Content-Type": "text/plain"}), 400),
    "features_zero_rate_wav": ("POST", "/v1/features", dict(
        body=WAV[:24] + bytes(8) + WAV[32:]), 400),
    "pitch_fmin_not_a_number": ("POST", "/v1/pitch?fmin=abc",
                                dict(body=WAV), 400),
    "pitch_nan_confidence_inf_fmin": (
        "POST", "/v1/pitch?min_confidence=nan&fmin=inf", dict(body=WAV), 400),
    "pitch_fmin_above_fmax": ("POST", "/v1/pitch?fmin=400&fmax=50",
                              dict(body=WAV), 400),
    "pitch_nan_confidence": ("POST", "/v1/pitch?min_confidence=nan",
                             dict(body=WAV), 400),
    "pitch_infeasible_band": ("POST", "/v1/pitch?fmin=30&fmax=50",
                              dict(body=WAV), 400),
    "vad_over_the_cap": ("POST", "/v1/vad", dict(
        body=b"\x00\x00" * 40000, headers={"Content-Type": RAW,
                                           "X-Sample-Rate": "16"}), 413),
    "stream_nan_confidence": ("POST", "/v1/stream?pitch=1&min_confidence=nan",
                              dict(body=SIG[:4800].tobytes(), headers={
                                  "Content-Type": RAW}), 400),
    "stream_inf_confidence": ("POST", "/v1/stream?pitch=1&min_confidence=inf",
                              dict(body=SIG[:4800].tobytes(), headers={
                                  "Content-Type": RAW}), 400),
    "stream_confidence_not_a_number": (
        "POST", "/v1/stream?pitch=1&min_confidence=abc",
        dict(body=SIG[:4800].tobytes(), headers={"Content-Type": RAW}), 400),
    "stream_empty_body": ("POST", "/v1/stream", dict(
        body=b"", headers={"Content-Type": RAW}), 400),
    "stream_wav_content_type": ("POST", "/v1/stream", dict(
        body=WAV, headers={"Content-Type": "audio/wav"}), 400),
    "stream_foreign_rate": ("POST", "/v1/stream", dict(
        body=SIG[:4800].tobytes(), headers={"Content-Type": RAW,
                                            "X-Sample-Rate": "8000"}), 400),
    # errors past the 200 line: one in-band error row each
    "stream_mislabeled_wav": ("POST", "/v1/stream", dict(
        body=WAV, headers={"Content-Type": RAW}), 200),
    "stream_negative_chunk_size": ("POST", "/v1/stream", dict(
        raw=b"-5\r\n" + b"x" * 64 + b"\r\n0\r\n\r\n"), 200),
    "stream_trailer_flood": ("POST", "/v1/stream", dict(
        raw=b"0\r\n" + b"x: y\r\n" * 500), 200),
}


@pytest.mark.parametrize("name", list(PARITY))
def test_response_matches_the_jax_server(servers, name):
    method, path, kwargs, status = PARITY[name]
    got = send(servers[0], method, path, **kwargs)
    want = send(servers[1], method, path, **kwargs)
    assert (got[0], got[1]) == (want[0], want[1]) == (status, want[1]), (
        name, got[0], want[0])
    g, w = parse(got[1], got[2]), parse(want[1], want[2])
    assert_same(g, w, name)
    if status == 200 and isinstance(w, dict) and "num_frames" in w:
        if "shorter" not in name:
            assert int(w["num_frames"]) > 0 and int(np.sum(w["vad"])) > 0
        if "pitch" in name and "strict" not in name:
            assert np.sum(np.asarray(w["f0"]) > 0) > 10
    if name.startswith("stream") and status == 200:
        assert w[-1].get("done") or "error" in w[-1]


def test_healthz_matches_the_jax_server(servers):
    """Status and backend as the JAX server reports them (both on the CPU);
    the port counts the CPU as one device, the JAX test backend has 8."""
    got = parse(*send(servers[0], "GET", "/healthz")[1:])
    want = parse(*send(servers[1], "GET", "/healthz")[1:])
    assert got == {"status": "ok", "backend": "cpu", "device_count": 1}
    assert (want["status"], want["backend"]) == ("ok", "cpu")


# -- decode_audio: NumPy only, equal outputs and errors ----------------------

U8 = ((SIG[:4000].astype(np.int32) // 256) + 128).astype(np.uint8)
DECODE = {
    "wav16": (WAV, "audio/wav", None),
    "stereo": (wav_bytes(STEREO_44K, 44100, channels=2), "audio/wav", None),
    "wav32_negatives": (wav_bytes(np.array([-65537, -1, 65535, 65537],
                                           "<i4"), width=4), "audio/wav", None),
    "wav8": (wav_bytes(U8, width=1), "audio/wav", None),
    "riff_sniffed": (WAV, "", None),
    "raw_with_rate": (SIG[:999].tobytes() + b"\x01", RAW, 8000),
    "raw_without_rate": (SIG.tobytes(), RAW, None),
    "raw_zero_rate": (SIG.tobytes(), RAW, 0),
    "garbage_riff": (b"RIFFnotawav", "audio/wav", None),
    "empty": (b"", "audio/wav", None),
    "text": (b"x" * 10, "text/plain", None),
    "zero_rate_wav": (WAV[:24] + bytes(8) + WAV[32:], "audio/wav", None),
}


def _decode(fn, args):
    try:
        return fn(*args)
    except ValueError as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("name", list(DECODE))
def test_decode_audio_matches_the_jax_package(name):
    got = _decode(tserve.decode_audio, DECODE[name])
    want = _decode(jserve.decode_audio, DECODE[name])
    assert type(got[0]) is type(want[0]) and got[1] == want[1], name
    if isinstance(want[0], np.ndarray):
        assert got[0].dtype == want[0].dtype
        np.testing.assert_array_equal(got[0], want[0])


# -- the port's server alone (the server-only cases of tests/test_serve.py) --


def test_service_matches_its_pipeline_exactly():
    svc = tserve.FeatureService(device="cpu")
    res = svc.analyze(SIG, SR)
    block, _ = svc.pipe.process_signal_auto(SIG)
    for k in ("vad", "energy", "zcr", "entropy", "mfcc", "vad_adaptive"):
        np.testing.assert_array_equal(res[k], getattr(block, k).numpy())
    assert res["vad"].dtype == res["vad_adaptive"].dtype == np.int32
    assert res["num_frames"] == block.vad.shape[0] and res["vad"].sum() > 0


def test_service_short_and_empty_inputs():
    svc = tserve.FeatureService(device="cpu")
    res = svc.analyze(np.zeros((10,), np.int16), SR, want_pitch=True)
    assert res["num_frames"] == 0 and res["f0"].shape == (0,)
    assert res["mfcc"].shape == (0, svc.pipe.cfg.num_ceps)
    assert svc.analyze(np.zeros((0,), np.int16), SR)["num_frames"] == 0


def test_service_resamples_foreign_rates():
    svc = tserve.FeatureService(device="cpu")
    res = svc.analyze(SIG_8K, 8000, want_pitch=True)
    assert res["sample_rate"] == SR and res["num_samples"] == 3 * SR
    assert res["vad"].sum() > 0
    voiced = res["f0"][res["f0"] > 0]
    assert voiced.size > 10 and abs(np.median(voiced) - 130.0) < 5.0


def test_service_resamples_on_its_own_device(monkeypatch):
    """With ``TPU_DEVICE_RESAMPLE`` the resampler runs on the service's
    device (here the CPU), never on the default card."""
    from sspv_tpu_torch.ops import resample

    monkeypatch.setattr(Config, "TPU_DEVICE_RESAMPLE", True)
    svc = tserve.FeatureService(device="cpu")
    calls = resample.CALLS["resample"]
    res = svc.analyze(SIG_8K, 8000)
    assert resample.CALLS["resample"] == calls + 1
    assert res["num_samples"] == 3 * SR and res["vad"].sum() > 0


def test_pitch_band_routing_fused_vs_two_call(monkeypatch):
    """The default band takes the fused call, a custom band the two-call
    path, as in the JAX server; both give the same track on a clear tone."""
    svc = tserve.FeatureService(device="cpu")
    calls = []
    for name, tag in (("process_signal_pitch_auto", "fused"),
                      ("process_signal_auto", "auto"),
                      ("pitch_signal_auto", "pitch")):
        real = getattr(svc.pipe, name)
        monkeypatch.setattr(
            svc.pipe, name,
            lambda *a, __real=real, __tag=tag, **k: calls.append(__tag)
            or __real(*a, **k))
    t = np.arange(SR) / SR
    sig = (5000 * np.sin(2 * np.pi * 150 * t)).astype(np.int16)
    out_d = svc.analyze(sig, SR, want_pitch=True)
    assert calls == ["fused"]
    calls.clear()
    out_c = svc.analyze(sig, SR, want_pitch=True, fmin=80.0, fmax=300.0)
    assert calls == ["auto", "pitch"]
    for out in (out_d, out_c):
        v = out["f0"][out["f0"] > 0]
        assert v.size and abs(np.median(v) - 150) < 10


def test_warmup_order_and_no_build_on_the_cpu(monkeypatch):
    """Two analyze calls per bucket (the features family, the pitch
    family), every bucket with ``all_buckets``; on the CPU nothing builds."""
    svc = tserve.FeatureService(device="cpu")
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("built"))
    seen = []
    real = svc.analyze
    monkeypatch.setattr(
        svc, "analyze", lambda sig, sr, **kw: seen.append(
            (len(sig), kw["want_pitch"])) or real(sig[: 2 * SR], sr, **kw))
    svc.warmup(all_buckets=True)
    assert seen == [(s * SR, p) for s in svc.pipe.SIGNAL_BUCKET_SECONDS
                    for p in (False, True)]
    seen.clear()
    svc.warmup()
    first = svc.pipe.SIGNAL_BUCKET_SECONDS[0] * SR
    assert seen == [(first, False), (first, True)]


def test_warmup_builds_the_kernels_first_on_the_card(monkeypatch):
    """On a CUDA device warm-up loads the kernel library before any
    request (here a stand-in service: no card in this process)."""
    order = []
    monkeypatch.setattr(_build, "library", lambda: order.append("library"))
    pipe = types.SimpleNamespace(
        device=torch.device("cuda"), cfg=types.SimpleNamespace(
            sample_rate=SR, hop_size=160, frame_size=320),
        SIGNAL_BUCKET_SECONDS=(2,),
        stream=lambda chunks: order.append("stream") or iter(()),
        stream_pitch=lambda chunks: order.append("stream_pitch") or iter(()))
    svc = tserve.FeatureService(pipeline=pipe)
    monkeypatch.setattr(svc, "analyze", lambda sig, sr, want_pitch: order.append(
        ("analyze", want_pitch)))
    svc.warmup()
    assert order == ["library", ("analyze", False), ("analyze", True), "stream"]


def test_stream_matches_the_offline_pipeline(server):
    """Concatenated /v1/stream rows equal the offline pipeline over the
    whole signal, and tiny client chunks are coalesced before dispatch."""
    status, ctype, body = send(server, "POST", "/v1/stream",
                               body=SIG.tobytes(), chunk_samples=1000)
    rows = parse(ctype, body)
    assert status == 200 and rows[-1] == {"done": True, "blocks": len(rows) - 1}
    assert 0 < len(rows) - 1 < -(-len(SIG) // 1000) / 2
    svc = server.RequestHandlerClass.service
    block, _ = svc.pipe.process_signal(SIG)
    n = sum(r["frames"] for r in rows[:-1])
    assert n == block.vad.shape[0]
    for k in ("vad", "vad_adaptive", "zcr"):
        got = [v for r in rows[:-1] for v in r[k]]
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      getattr(block, k).numpy())
    got_e = np.array([v for r in rows[:-1] for v in r["energy"]], np.float32)
    assert _nmse(got_e, block.energy.numpy()) <= 1e-9
    assert "mfcc" not in rows[0] and "f0" not in rows[0]


def test_stream_pitch_rows_match_the_frames_track(server):
    """``?pitch=1``: the F0 equals the frames-path track gated on the
    streamed VAD."""
    status, ctype, body = send(server, "POST",
                               "/v1/stream?pitch=1&min_confidence=0.4",
                               body=SIG.tobytes(), chunk_samples=1000)
    data = parse(ctype, body)[:-1]
    assert status == 200
    assert all(len(r["f0"]) == len(r["pitch_confidence"]) == r["frames"]
               for r in data)
    svc = server.RequestHandlerClass.service
    vad = np.array([v for r in data for v in r["vad"]], np.int32)
    frames = svc.pipe.stream_frames(SIG)[: vad.shape[0]]
    want, _ = pitch_track(torch.from_numpy(frames), torch.from_numpy(vad),
                          min_confidence=0.4, acf_impl="dft")
    got = np.array([v for r in data for v in r["f0"]], np.float32)
    np.testing.assert_array_equal(got, want.numpy())
    assert (got > 0).any()


def test_errors_close_the_connection(server):
    host, port = server.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=30)
    try:
        conn.request("POST", "/v1/nope", body=b"leftover-bytes" * 100,
                     headers={"Content-Type": "audio/wav"})
        resp = conn.getresponse()
        assert resp.status == 404
        assert (resp.getheader("Connection") or "").lower() == "close"
        resp.read()
    finally:
        conn.close()
    assert send(server, "POST", "/v1/vad", body=wav_bytes(SIG[:4800]))[0] == 200


def test_concurrent_clients_share_one_pipeline(server):
    """8 clients with mixed endpoints; every response equals the serial
    one."""
    svc = server.RequestHandlerClass.service
    expect = {False: svc.analyze(SIG, SR), True: svc.analyze(SIG, SR,
                                                             want_pitch=True)}
    results = [None] * 8

    def worker(i):
        path = ("/v1/features", "/v1/vad", "/v1/pitch")[i % 3]
        status, ctype, body = send(server, "POST", path, body=WAV)
        results[i] = (path, status, parse(ctype, body))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT_S)
    assert not any(t.is_alive() for t in threads)
    for r in results:
        path, status, res = r
        assert status == 200
        want = expect[path == "/v1/pitch"]
        for k in res:
            if k in want and isinstance(want[k], np.ndarray):
                np.testing.assert_array_equal(
                    np.asarray(res[k], want[k].dtype), want[k], err_msg=k)


def test_healthz_probes_the_device(server):
    status, ctype, body = send(server, "GET", "/healthz")
    assert status == 200 and parse(ctype, body)["status"] == "ok"
    assert tserve._PROBE_STATE["ok"] is True


def test_health_probe_is_bounded_and_single(monkeypatch):
    """A probe that blocks answers within its bound, a poll meanwhile
    starts no second probe, and the probe's own end clears the flag."""
    release = threading.Event()

    def ones(shape, device):
        release.wait(TIMEOUT_S)
        return torch.ones(shape)

    monkeypatch.setattr(tserve, "torch", types.SimpleNamespace(ones=ones))
    monkeypatch.setattr(tserve, "_PROBE_STATE", {
        "ts": 0.0, "ok": None, "error": "", "inflight": False})
    ok, err = tserve._device_health("cpu", timeout_s=0.05, cache_s=0.0)
    assert not ok and "exceeded" in err
    ok, err = tserve._device_health("cpu", timeout_s=0.05, cache_s=0.0)
    assert not ok and err == "previous device probe still blocked"
    release.set()
    deadline = time.monotonic() + 30
    while tserve._PROBE_STATE["inflight"] and time.monotonic() < deadline:
        time.sleep(0.01)
    assert tserve._device_health("cpu", cache_s=60.0) == (True, "")
    assert tserve._device_health("cpu", cache_s=60.0) == (True, "")  # cached


def _metrics(server, query=""):
    status, ctype, body = send(server, "GET", "/metrics" + query)
    assert status == 200
    return ctype, parse(ctype, body)


def _settle(server, until):
    """The handler records a request after the client has the response:
    poll ``/metrics`` briefly instead of racing it."""
    deadline = time.monotonic() + 5.0
    while True:
        m = _metrics(server)[1]
        if until(m) or time.monotonic() > deadline:
            return m
        time.sleep(0.05)


def test_metrics_count_requests(server):
    before = _metrics(server)[1]
    b = before["routes"].get("/v1/features", {"requests": 0, "errors": 0})
    status, ctype, body = send(server, "POST", "/v1/features", body=WAV)
    assert status == 200
    n_frames = parse(ctype, body)["num_frames"]
    assert send(server, "POST", "/v1/features", body=b"not audio at all",
                headers={"Content-Type": "audio/wav"})[0] == 400
    m = _settle(server, lambda m: m["routes"]["/v1/features"]["requests"]
                >= b["requests"] + 2)
    r = m["routes"]["/v1/features"]
    assert r["requests"] == b["requests"] + 2
    assert r["errors"] == b["errors"] + 1
    assert r["latency_p50_s"] > 0 and r["latency_max_s"] >= r["latency_p50_s"]
    assert m["bytes_in_total"] >= before["bytes_in_total"] + len(WAV)
    assert m["frames_out_total"] >= before["frames_out_total"] + n_frames
    assert m["inflight"] >= 1  # this very /metrics request


def test_metrics_prometheus_exposition(server):
    send(server, "GET", "/healthz")
    ctype, text = _metrics(server, "?fmt=prom")
    assert ctype.startswith("text/plain")
    assert 'sspv_requests_total{route="/healthz"}' in text
    assert "# TYPE sspv_request_latency_seconds summary" in text
    assert "sspv_uptime_seconds" in text


def test_metrics_unknown_routes_fold_into_other(server):
    for k in range(3):
        assert send(server, "GET", f"/scan/{k}")[0] == 404
    m = _settle(server, lambda m: m["routes"].get("other", {"errors": 0})
                ["errors"] >= 3 and m["inflight"] == 1)
    assert m["routes"]["other"]["errors"] >= 3
    assert not any(r.startswith("/scan") for r in m["routes"])
    assert m["inflight"] == 1  # only the /metrics request itself


def test_snap_to_grid():
    assert tserve._snap_to_grid(52.0) == 50.0
    assert tserve._snap_to_grid(395.0) == 400.0
    assert tserve._snap_to_grid(-5.0) == 30.0
    with pytest.raises(ValueError):
        tserve._snap_to_grid(float("nan"))


def test_service_defaults_to_the_card():
    """The default device is the card: without one, the service (and so
    ``make_server()``) raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert tserve.FeatureService().pipe.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tserve.FeatureService()


def test_sigterm_drains_and_exits_cleanly():
    """``python -m sspv_tpu_torch.serve --device cpu`` exits 0 on SIGTERM
    after draining (the rolling-deploy contract)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), RTP_SERVE_HOST="127.0.0.1",
               RTP_SERVE_PORT="0", RTP_SERVE_WARMUP="0",
               RTP_SERVE_DRAIN_S="10")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sspv_tpu_torch.serve", "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    reader = threading.Thread(
        target=lambda: lines.extend(iter(proc.stdout.readline, "")),
        daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + TIMEOUT_S
        port = None
        while port is None and time.monotonic() < deadline:
            port = next((int(line.rsplit(":", 1)[1]) for line in list(lines)
                         if "serving on http://" in line), None)
            time.sleep(0.05)
        assert port, "server never came up: " + "".join(lines)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/config")
        assert conn.getresponse().status == 200
        conn.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        reader.join(timeout=10)


# -- the launch counters under threads ---------------------------------------


def test_launch_counts_add_up_across_threads():
    """``_build.count`` is a locked read-modify-write: more threads than
    cores, each switching often, lose no count."""
    before = dict(_build.LAUNCHES), dict(_build.ROUTES)
    n_threads, per_thread = 4 * (os.cpu_count() or 2), 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(per_thread):
                _build.count("frame_features", "frame_features_fft")
                _build.count("view_pitch")

        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT_S)
        assert not any(t.is_alive() for t in threads)
        total = n_threads * per_thread
        assert _build.LAUNCHES["frame_features"] == before[0]["frame_features"] + total
        assert _build.LAUNCHES["view_pitch"] == before[0]["view_pitch"] + total
        assert _build.ROUTES["frame_features_fft"] == (
            before[1]["frame_features_fft"] + total)
    finally:
        sys.setswitchinterval(interval)
        _build.LAUNCHES.update(before[0])
        _build.ROUTES.update(before[1])


def test_wrappers_count_through_the_lock():
    """No module of the port bumps a launch count outside ``_build.count``."""
    bare = re.compile(r"(LAUNCHES|ROUTES)\[[^\]]*\]\s*\+=")
    offenders = [str(p.relative_to(REPO))
                 for p in (REPO / "sspv_tpu_torch").rglob("*.py")
                 if p.name != "_build.py" and bare.search(p.read_text())]
    assert offenders == []
    for module, kernels in (("view_kernels", ('"view_features"',
                                              '"view_pitch"')),
                            ("frame_kernels", ('"frame_features"',))):
        text = (REPO / "sspv_tpu_torch" / "ops" / f"{module}.py").read_text()
        for kernel in kernels:
            assert f"_build.count({kernel}" in text, (module, kernel)
