#!/usr/bin/env python3
"""The port's spans (``utils/profiling.span``) on the CPU: they record only
while a ``torch.profiler`` profile is recording, land once in the store and
once in the profiler's Chrome trace, nest per thread, keep to their bound,
and mark the program's layers: the mesh programs with their stages and
kernel wrappers, and the engine's host loop."""

import gc
import json
import re
import sys
import threading
import time
import wave
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from sspv_tpu_torch.config import Config as TConfig
from sspv_tpu_torch.ops.pipeline import FeatureConfig, FeaturePipeline
from sspv_tpu_torch.parallel import BatchPipeline, make_mesh
from sspv_tpu_torch.runtime import AudioRuntime
from sspv_tpu_torch.runtime.audio_source import FileAudioSource
from sspv_tpu_torch.utils import profiling
from sspv_tpu_torch.utils.profiling import clear_spans, span, span_totals, spans

PORT = Path(__file__).resolve().parents[1] / "sspv_tpu_torch"
SR = 16000


@pytest.fixture(autouse=True)
def empty_store():
    clear_spans()
    yield
    clear_spans()


def speech(seconds: float, seed: int = 0) -> np.ndarray:
    """Tone bursts, noise bursts and a noise floor, as int16."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    seg = (t * 4).astype(int) % 3
    sig = rng.normal(0, 40, n)
    sig = np.where(seg == 1, 7000 * np.sin(2 * np.pi * 140 * t) + sig, sig)
    sig = np.where(seg == 2, rng.normal(0, 2000, n), sig)
    return np.clip(sig, -32768, 32767).astype(np.int16)


def _annotations(path) -> list:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e["name"].startswith("sspv.")]


def test_no_profiler_records_nothing():
    with span("sspv.test.outer") as req:
        with span("sspv.test.inner", req=7) as inner:
            pass
    assert req is None and inner is None
    assert spans() == ([], 0) and span_totals() == {}
    # the same shared no-op each time: nothing is made per call
    assert span("sspv.test.a") is span("sspv.test.b")


def test_active_step_only_and_the_chrome_trace(tmp_path):
    """The warm-up step records nothing; the active step records each span
    once in the store and once as a ``user_annotation`` of the exported
    trace, with the same names, counts and nesting. A thread started
    before the profiler records into the store (the profiler does not
    follow it)."""
    path = str(tmp_path / "trace.json")
    stop = threading.Event()
    started = threading.Event()

    def worker():
        started.set()
        while not stop.is_set():
            with span("sspv.test.worker"):
                torch.ones(4).add_(1)
            time.sleep(0.001)

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    started.wait(10)
    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                   on_trace_ready=lambda p: p.export_chrome_trace(path))
    prof.start()
    for _ in range(3):
        with span("sspv.test.warm"):
            torch.ones(4).sum()
    assert [r for r in spans()[0] if r.thread != th.ident] == []
    prof.step()  # the active step
    for i in range(3):
        with span("sspv.test.outer") as req:
            with span("sspv.test.inner") as inner:
                torch.ones(4).sum()
            assert inner == req
            if i == 0:
                with span("sspv.test.once"):
                    pass
    time.sleep(0.05)
    prof.step()
    prof.stop()
    stop.set()
    th.join(10)

    records, dropped = spans()
    assert dropped == 0
    main = [r for r in records if r.thread == threading.get_ident()]
    assert Counter(r.name for r in main) == {
        "sspv.test.outer": 3, "sspv.test.inner": 3, "sspv.test.once": 1}
    assert any(r.name == "sspv.test.worker" and r.thread == th.ident
               for r in records)
    ann = _annotations(path)
    assert Counter(e["name"] for e in ann) == Counter(r.name for r in main)
    # nesting: each inner annotation inside an outer one, as in the store
    outers = [e for e in ann if e["name"] == "sspv.test.outer"]
    for e in ann:
        if e["name"] != "sspv.test.outer":
            assert any(o["ts"] <= e["ts"] and e["ts"] + e["dur"]
                       <= o["ts"] + o["dur"] for o in outers), e
    by_index = {r.index: r for r in main}
    for r in main:
        if r.name == "sspv.test.outer":
            assert r.parent is None and r.req == r.index
        else:
            assert by_index[r.parent].name == "sspv.test.outer"
            assert r.req == r.parent


def test_nesting_and_self_time():
    with profile(activities=[ProfilerActivity.CPU]):
        with span("sspv.test.outer") as req:
            time.sleep(0.02)
            with span("sspv.test.inner"):
                time.sleep(0.03)
            with span("sspv.test.inner", req=41) as given:
                time.sleep(0.01)
    records, _ = spans()
    outer = next(r for r in records if r.name == "sspv.test.outer")
    inner = [r for r in records if r.name == "sspv.test.inner"]
    assert given == 41 and [r.req for r in inner] == [req, 41]
    assert all(r.parent == outer.index for r in inner)
    assert all(outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns
               for r in inner)
    t = span_totals()
    assert t["sspv.test.inner"]["count"] == 2
    assert t["sspv.test.inner"]["seconds"] == pytest.approx(
        sum(r.end_ns - r.start_ns for r in inner) / 1e9)
    assert t["sspv.test.inner"]["self_seconds"] == t["sspv.test.inner"][
        "seconds"]
    assert t["sspv.test.outer"]["self_seconds"] == pytest.approx(
        (outer.end_ns - outer.start_ns) / 1e9
        - t["sspv.test.inner"]["seconds"])
    assert 0.015 < t["sspv.test.outer"]["self_seconds"] < \
        t["sspv.test.outer"]["seconds"] - 0.035


def test_two_threads_have_their_own_stacks():
    """Spans open at once on two threads each nest under their own
    thread's span, never under the other's."""
    barrier = threading.Barrier(2)

    def work(tag):
        with span(f"sspv.test.{tag}"):
            barrier.wait(10)
            with span(f"sspv.test.{tag}_inner"):
                barrier.wait(10)

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for th in threads:
            th.start()
        for th in threads:
            th.join(10)
    records, _ = spans()
    by_index = {r.index: r for r in records}
    assert len(records) == 4
    for tag in "ab":
        inner = next(r for r in records if r.name == f"sspv.test.{tag}_inner")
        outer = by_index[inner.parent]
        assert outer.name == f"sspv.test.{tag}"
        assert outer.thread == inner.thread and outer.parent is None


def test_the_store_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(8):
            with span("sspv.test.many"):
                pass
    records, dropped = spans()
    assert len(records) == 5 and dropped == 3
    assert span_totals()["sspv.test.many"]["count"] == 5
    clear_spans()
    assert spans() == ([], 0)


def test_the_collector_stops_tracking_the_store():
    """Stored records are plain tuples of ints, a str and None: after one
    collection the collector no longer tracks them, so a full store adds
    nothing to a full collection (which stalls every thread)."""
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(100):
            with span("sspv.test.outer", req=3):
                with span("sspv.test.inner"):
                    pass
    gc.collect()
    assert len(profiling._records) == 200
    assert not any(gc.is_tracked(r) for r in profiling._records)


def test_threads_lose_no_record(monkeypatch):
    """More threads than cores record at once with a short switch
    interval: every span is stored or counted as dropped, and the store
    stops at its bound."""
    monkeypatch.setattr(profiling, "MAX_SPANS", 3000)
    threads, each = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            def work():
                for _ in range(each):
                    with span("sspv.test.outer"):
                        with span("sspv.test.inner"):
                            pass

            pool = [threading.Thread(target=work) for _ in range(threads)]
            for th in pool:
                th.start()
            for th in pool:
                th.join(60)
            assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(old)
    records, dropped = spans()
    assert len(records) == 3000 and len(records) + dropped == \
        2 * threads * each
    assert len({r.index for r in records}) == len(records)


def _names_inside(outer_name):
    """``{name: count}`` of the stored spans under the one ``outer_name``
    span (at any depth), and that span."""
    records, _ = spans()
    outer = [r for r in records if r.name == outer_name]
    assert len(outer) == 1, [r.name for r in records]
    by_index = {r.index: r for r in records}

    def under(r):
        while r.parent is not None:
            if r.parent == outer[0].index:
                return True
            r = by_index[r.parent]
        return False

    return Counter(r.name for r in records if under(r)), outer[0]


def test_process_long_pitch_records_its_stages():
    bp = BatchPipeline(make_mesh(1, device="cpu"))
    sig = speech(2.0)
    with profile(activities=[ProfilerActivity.CPU]):
        bp.process_long_pitch(sig)
    inside, outer = _names_inside("sspv.mesh.process_long_pitch")
    assert outer.parent is None and outer.req == outer.index
    assert inside == {
        "sspv.pipeline.upload": 1, "sspv.mesh.shard": 2,
        "sspv.k1.view_features": 1, "sspv.mesh.gather": 6,
        "sspv.k4.vad": 1, "sspv.k2.view_pitch": 1, "sspv.mesh.gate": 1}
    records, _ = spans()
    assert all(r.req == outer.index for r in records)


def test_process_batch_masked_records_its_stages():
    cfg = FeatureConfig(frame_size=400, hop_size=160, n_fft=400,
                        entropy_n_fft=400, num_filters=80,
                        window_type="hann")
    bp = BatchPipeline(make_mesh(1, device="cpu"), cfg)
    sig = np.stack([speech(1.0, seed) for seed in range(4)])
    lengths = [16000, 16000, 9000, 300]
    with profile(activities=[ProfilerActivity.CPU]):
        bp.process_batch_masked(sig, lengths)
    inside, _ = _names_inside("sspv.mesh.process_batch_masked")
    assert inside == {
        "sspv.mesh.rows.frame": 1, "sspv.pipeline.upload": 1,
        "sspv.k3.frame_features": 1, "sspv.mesh.rows.per_row": 4,
        "sspv.k4.vad": 1, "sspv.mesh.rows.collect": 1}


@pytest.mark.parametrize("rate", [48000, None, 16000])
def test_process_batch_masked_records_the_resample(rate):
    """At a source rate the call records ``sspv.mesh.resample`` and, inside
    it, the wrapper's ``sspv.k5.resample``, once a device, both under
    ``sspv.mesh.process_batch_masked``; at none or the configuration's
    own, neither."""
    cfg = FeatureConfig(frame_size=400, hop_size=160, n_fft=400,
                        entropy_n_fft=400, num_filters=80,
                        window_type="hann")
    bp = BatchPipeline(make_mesh(1, device="cpu"), cfg)
    src = rate or 16000
    sig = np.stack([speech(0.5 * src / SR, seed) for seed in range(2)])
    with profile(activities=[ProfilerActivity.CPU]):
        bp.process_batch_masked(sig, [sig.shape[1], sig.shape[1] // 2],
                                source_rate=rate)
    inside, _ = _names_inside("sspv.mesh.process_batch_masked")
    want = {"sspv.mesh.rows.frame": 1, "sspv.pipeline.upload": 1,
            "sspv.k3.frame_features": 1, "sspv.mesh.rows.per_row": 4,
            "sspv.k4.vad": 1, "sspv.mesh.rows.collect": 1}
    if rate == 48000:
        want.update({"sspv.mesh.resample": 1, "sspv.k5.resample": 1})
    assert inside == want
    records, _ = spans()
    by_index = {r.index: r for r in records}
    for r in records:
        if r.name == "sspv.k5.resample":
            assert by_index[r.parent].name == "sspv.mesh.resample"
        if r.name == "sspv.mesh.resample":
            assert by_index[r.parent].name == "sspv.mesh.rows.frame"


def test_the_engine_records_take_dispatch_and_publish(tmp_path):
    """A file source read to its end under a profiler: each block's
    dispatch and publish share one request id, the dispatch's own."""
    path = tmp_path / "clip.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(speech(3.0).tobytes())
    rt = AudioRuntime(FileAudioSource(str(path), sample_rate=SR),
                      pipeline=FeaturePipeline(
                          FeatureConfig.from_config(TConfig), device="cpu"))
    with profile(activities=[ProfilerActivity.CPU]):
        rt.set_audio_source(rt.audio_source, auto_stop_on_eof=True)
        rt.start()
        t0 = time.monotonic()
        while rt.is_running and time.monotonic() - t0 < 120:
            time.sleep(0.005)
        rt.stop()
    assert rt.last_error is None and rt.dispatch_count > 0
    records, dropped = spans()
    assert dropped == 0
    names = Counter(r.name for r in records)
    assert names["sspv.engine.dispatch"] == rt.dispatch_count
    assert names["sspv.engine.publish"] == rt.dispatch_count
    assert names["sspv.engine.take"] >= rt.dispatch_count
    dispatch = [r for r in records if r.name == "sspv.engine.dispatch"]
    publish = [r for r in records if r.name == "sspv.engine.publish"]
    assert all(r.req == r.index and r.parent is None for r in dispatch)
    assert sorted(r.req for r in publish) == sorted(r.req for r in dispatch)
    by_req = {r.req: r for r in dispatch}
    for r in publish:
        assert r.start_ns >= by_req[r.req].end_ns
    # the packed program runs inside its dispatch
    by_index = {r.index: r for r in records}
    for r in records:
        if r.name in ("sspv.pipeline.pack", "sspv.k1.view_features"):
            assert by_index[r.parent].name == "sspv.engine.dispatch"


def test_every_program_span_is_named_sspv():
    """Each span the port opens is named ``sspv.<layer>.<step>``: tools
    tell them from PyTorch's annotations by that, and none can pass for
    the profiler's ``ProfilerStep#`` window."""
    names = set()
    for path in PORT.rglob("*.py"):
        names |= set(re.findall(r'\bspan\(\s*"([^"]*)"', path.read_text()))
    assert len(names) >= 20, names
    bad = [n for n in names if not re.fullmatch(r"sspv(\.[a-z0-9_]+){2,3}", n)]
    assert not bad, bad
