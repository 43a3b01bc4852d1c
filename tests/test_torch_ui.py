#!/usr/bin/env python3
"""The port's UI (``sspv_tpu_torch.ui``): copies of ``sspv_tpu/ui`` that
are source-equal to them but for the package name and "(TPU)" -> "(CUDA)"
in the window titles, then the cases of ``tests/test_ui_headless.py`` and
``tests/test_ui_qt.py`` over the port's ``AudioRuntime`` on the CPU (the Qt
backend through the stub Qt of ``tests/qt_stubs.py``)."""

import importlib
import os
import sys
import time
import wave
from pathlib import Path

import numpy as np
import pytest

import qt_stubs
from test_torch_engine import DummyAudioSource

from sspv_tpu_torch.config import Config
from sspv_tpu_torch.runtime import AudioRuntime, FileAudioSource
from sspv_tpu_torch.ui import (
    HeadlessVisualizer,
    PlotModel,
    RangeTracker,
    VisualizationUI,
    collect_audio_files,
)

REPO = Path(__file__).resolve().parents[1]
UI_FILES = ("files.py", "plots.py", "headless.py", "qt.py", "__init__.py")
RUN_LIMIT_S = 60


@pytest.mark.parametrize("name", UI_FILES)
def test_ui_module_is_a_copy_of_the_original(name):
    ours = (REPO / "sspv_tpu_torch" / "ui" / name).read_text()
    theirs = (REPO / "sspv_tpu" / "ui" / name).read_text()
    assert "(TPU)" not in ours
    assert ours.replace("sspv_tpu_torch", "sspv_tpu").replace(
        "(CUDA)", "(TPU)") == theirs


def tone_source(duration_sec=0.25, freq_hz=440.0, signal=None):
    """The JAX tests' sine source, through the port's in-memory source."""
    if signal is None:
        t = np.arange(int(duration_sec * Config.SAMPLE_RATE)) / Config.SAMPLE_RATE
        signal = (0.5 * np.sin(2 * np.pi * freq_hz * t) * 32767).astype(np.int16)
    return DummyAudioSource(signal)


def runtime(seconds=0.1, **kw):
    return AudioRuntime(audio_source=tone_source(seconds, **kw), device="cpu")


def _write_wav(path, seconds=0.2, freq=330.0):
    sr = Config.SAMPLE_RATE
    t = np.arange(int(seconds * sr)) / sr
    sig = (np.sin(2 * np.pi * freq * t) * 12000).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(sig.tobytes())
    return str(path)


# -- the headless backend (tests/test_ui_headless.py) -------------------------


class FakeRuntime:
    """Minimal object honoring the 6-method UI contract."""

    def __init__(self, n=50):
        self.is_running = False
        rng = np.random.default_rng(0)
        self._audio = (rng.normal(0, 5000, 4096)).astype(np.int16)
        self._e = rng.uniform(0, 1e7, n)
        self._z = rng.uniform(0, 0.4, n)
        self._v = (rng.random(n) < 0.5).astype(int)
        self.audio_source = None

    def start(self):
        self.is_running = True

    def stop(self):
        self.is_running = False

    def get_recent_audio(self):
        return self._audio

    def get_recent_processed(self, max_display=None):
        return self._e, self._z, self._v

    def save_data(self, directory=None):
        return "fake.npz"


def test_range_tracker_policies():
    rt = RangeTracker("waveform")
    lo, hi = rt.update(np.array([-1000.0, 2000.0]))
    assert lo == -hi and hi >= 2000.0
    assert RangeTracker("vad").update(np.array([0, 1])) == (-0.1, 1.1)
    lo, hi = RangeTracker("energy").update(np.array([5.0, 10.0]))
    assert lo == 0.0 and hi >= 10.0
    assert RangeTracker("zcr").update(np.array([])) == (0.0, 0.5)


def test_plot_model_poll_and_summary():
    m = PlotModel(FakeRuntime())
    m.poll()
    assert m.energies.size == 50
    s = m.summary()
    assert "frames=50" in s and "voiced=" in s


def test_headless_visualizer_end_to_end(tmp_path):
    sr = Config.SAMPLE_RATE
    sig = (np.sin(np.arange(sr // 2) * 0.1) * 8000).astype(np.int16)
    p = tmp_path / "t.wav"
    with wave.open(str(p), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sr)
        wf.writeframes(sig.tobytes())
    rt = AudioRuntime(audio_source=FileAudioSource(str(p), sample_rate=sr),
                      device="cpu")
    rt.auto_stop_on_eof = True
    png = tmp_path / "snap.png"
    ui = VisualizationUI(rt, headless=True, duration=30.0, snapshot_path=str(png))
    assert ui._impl.title == "Real-time speech processing (CUDA)"
    ui.run()
    assert not rt.is_running and rt.last_error is None
    assert png.exists() and png.stat().st_size > 1000
    e, _, _ = rt.get_recent_processed()
    assert e.size > 0


def test_collect_audio_files(tmp_path):
    (tmp_path / "b.wav").write_bytes(b"x")
    (tmp_path / "a.WAV").write_bytes(b"x")
    (tmp_path / "notes.txt").write_bytes(b"x")
    (tmp_path / "sub").mkdir()
    got = collect_audio_files(str(tmp_path))
    assert [os.path.basename(f) for f in got] == ["a.WAV", "b.wav"]
    assert collect_audio_files(str(tmp_path / "missing")) == []


def test_headless_run_survives_missing_matplotlib(monkeypatch):
    v = HeadlessVisualizer(FakeRuntime(), duration=0.05,
                           snapshot_path="unused.png")
    monkeypatch.setattr(
        v, "render_png",
        lambda path: (_ for _ in ()).throw(ImportError("no matplotlib")))
    v.run()  # must not raise


def test_plot_model_reenable_autorange_clears_history():
    class Runtime:
        amplitude = 20000.0

        def get_recent_audio(self):
            return np.full(100, self.amplitude, dtype=np.float32)

        def get_recent_processed(self):
            return np.full(10, self.amplitude), np.full(10, 0.1), np.zeros(10)

    rt = Runtime()
    m = PlotModel(rt)
    m.poll()
    m.auto_range = False
    rt.amplitude = 10.0
    m.poll()
    m.auto_range = True
    m.poll()
    assert m.ranges["waveform"][1] <= 10 * 1.1 + 1e-6


def test_progress_reports_completion_after_close():
    class Playlist:
        _paths = ["a.wav", "b.wav", "c.wav"]
        _index = 0
        exhausted = True

    class Runtime:
        audio_source = Playlist()

    assert PlotModel(Runtime()).progress() == "file 3/3"


# -- the Qt backend through stub Qt (tests/test_ui_qt.py) ---------------------


@pytest.fixture
def qtvis(monkeypatch):
    """Stub Qt installed and ``sspv_tpu_torch.ui.qt`` (re)imported on it."""
    qt_stubs.install(monkeypatch)
    import sspv_tpu_torch.ui.qt as qt_mod

    importlib.reload(qt_mod)
    yield qt_mod
    sys.modules.pop("sspv_tpu_torch.ui.qt", None)


def _drive(rt, ui=None):
    """Run ``rt`` to its end (polling ``ui`` if given), within the limit."""
    deadline = time.time() + RUN_LIMIT_S
    polls = 0
    while time.time() < deadline:
        if ui is not None:
            ui.timer.timeout.emit()
            polls += 1
        if not rt.is_running:
            break
        time.sleep(0.01)
    assert not rt.is_running, "the engine did not reach its end"
    return polls


def _swap_source(monkeypatch, rt, seconds, auto_stop=None):
    """``set_audio_source`` installs a fresh tone source instead of the one
    the UI built (and ``auto_stop`` in place of the UI's choice, if set)."""
    def swap(src, auto_stop_on_eof=False):
        AudioRuntime.set_audio_source(
            rt, tone_source(seconds),
            auto_stop_on_eof=auto_stop_on_eof if auto_stop is None else auto_stop)

    monkeypatch.setattr(rt, "set_audio_source", swap)


def test_qt_visualizer_full_session(qtvis, monkeypatch, tmp_path):
    monkeypatch.setattr(Config, "SAVE_DIRECTORY", str(tmp_path))
    rt = runtime(0.3)
    ui = qtvis.QtVisualizer(rt, title="stub session")
    assert ui.win._title == "stub session"
    assert ui.timer._started and ui.timer._interval == Config.PLOT_UPDATE_INTERVAL
    assert set(ui.curves) == {"waveform", "energy", "zcr", "vad"}

    ui.radio_mic.setChecked(True)
    ui.radio_scan.setChecked(False)
    _swap_source(monkeypatch, rt, 0.3, auto_stop=True)
    ui._on_start()
    polls = _drive(rt, ui)
    ui._on_stop()
    assert not rt.is_running and rt.last_error is None

    qt_stubs.QMessageBox.next_clicked_index = 0  # "Continue"
    if not ui._prompted_eof:
        ui._was_running = True
    ui.timer.timeout.emit()
    prompts = [s for s in qt_stubs.QMessageBox.shown if s[0] == "question"]
    assert len(prompts) == 1 and "complete" in prompts[0][1].lower()
    assert not ui.app._quit_called
    ui.timer.timeout.emit()
    assert len([s for s in qt_stubs.QMessageBox.shown if s[0] == "question"]) == 1

    assert ui.curves["energy"].n_sets >= polls >= 1
    assert ui.curves["energy"].y.size > 0
    assert ui.curves["vad"].x is not None
    assert "frames=" in ui.result_label.text()
    assert ui.status_label.text() == "stopped"
    assert ui.btn_start.isEnabled() and not ui.btn_stop.isEnabled()

    ui._on_save()
    infos = [s for s in qt_stubs.QMessageBox.shown if s[0] == "information"]
    assert len(infos) == 1 and infos[0][2].endswith(".npz")


def test_qt_build_source_all_radio_states(qtvis, monkeypatch, tmp_path):
    from sspv_tpu_torch.runtime.audio_source import PlaylistAudioSource

    wavs = [_write_wav(tmp_path / f"{n}.wav") for n in ("a", "b", "c")]
    ui = qtvis.QtVisualizer(runtime())

    def choose(radio):
        for r in (ui.radio_mic, ui.radio_scan, ui.radio_custom):
            r.setChecked(r is radio)

    choose(ui.radio_mic)
    assert ui._build_source() is None
    choose(ui.radio_custom)
    ui.path_edit.setText(wavs[0])
    assert isinstance(ui._build_source(), FileAudioSource)
    ui.path_edit.setText(str(tmp_path))
    ui._refresh_combo(wavs)
    src = ui._build_source()
    assert isinstance(src, PlaylistAudioSource) and src._paths == wavs
    ui.file_combo.setCurrentIndex(1)
    assert ui._build_source()._paths == [wavs[1], wavs[2], wavs[0]]
    ui.radio_one.setChecked(True)
    ui.radio_all.setChecked(False)
    src = ui._build_source()
    assert isinstance(src, PlaylistAudioSource) and src._paths == [wavs[1]]
    choose(ui.radio_scan)
    monkeypatch.setattr(qtvis, "default_audio_dir", lambda: str(tmp_path / "none"))
    assert ui._build_source() is None
    qt_stubs.QFileDialog.next_file = wavs[2]
    ui._pick_file()
    assert ui.path_edit.text() == wavs[2] and ui.radio_custom.isChecked()
    qt_stubs.QFileDialog.next_dir = str(tmp_path)
    ui._pick_dir()
    assert ui.file_combo.count() == len(wavs)


def test_qt_start_failure_shows_message_box(qtvis, monkeypatch):
    rt = runtime()
    ui = qtvis.QtVisualizer(rt)
    monkeypatch.setattr(
        rt, "start", lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    ui._on_start()
    crits = [s for s in qt_stubs.QMessageBox.shown if s[0] == "critical"]
    assert len(crits) == 1 and "boom" in crits[0][2]


def test_visualization_ui_selects_qt_backend(qtvis):
    import sspv_tpu_torch.ui as ui_pkg

    vui = ui_pkg.VisualizationUI(runtime())
    assert type(vui._impl).__name__ == "QtVisualizer"
    assert vui._impl.win._title == "Real-time speech processing (CUDA)"
    assert vui.run() == 0
    assert vui._impl.win._visible


def test_qt_custom_bad_path_raises_not_mic(qtvis, tmp_path):
    ui = qtvis.QtVisualizer(runtime())
    ui.radio_custom.setChecked(True)
    ui.radio_scan.setChecked(False)
    ui.radio_mic.setChecked(False)
    ui.path_edit.setText(str(tmp_path / "typo.wav"))
    with pytest.raises(ValueError):
        ui._build_source()
    ui._on_start()
    crits = [s for s in qt_stubs.QMessageBox.shown if s[0] == "critical"]
    assert any("typo.wav" in c[2] for c in crits)


def test_qt_stale_combo_selection_does_not_leak_across_dirs(qtvis, tmp_path):
    from sspv_tpu_torch.runtime.audio_source import PlaylistAudioSource

    dir_a = tmp_path / "a"
    dir_a.mkdir()
    dir_b = tmp_path / "b"
    dir_b.mkdir()
    _write_wav(dir_a / "a1.wav")
    _write_wav(dir_a / "a2.wav")
    b1 = _write_wav(dir_b / "b1.wav")
    ui = qtvis.QtVisualizer(runtime())
    qt_stubs.QFileDialog.next_dir = str(dir_a)
    ui._pick_dir()
    assert ui.file_combo.count() == 2
    ui.path_edit.setText(str(dir_b))
    ui.radio_one.setChecked(True)
    src = ui._build_source()
    assert isinstance(src, PlaylistAudioSource) and src._paths == [b1]


def test_qt_autorange_toggle_releases_ranges_and_vad_clears(qtvis, monkeypatch):
    rt = runtime(0.3)
    ui = qtvis.QtVisualizer(rt)
    _swap_source(monkeypatch, rt, 0.3)
    ui.chk_autostop.setChecked(True)
    ui._on_start()
    t0 = time.time()
    while rt.is_running and time.time() - t0 < RUN_LIMIT_S:
        ui._update()
        time.sleep(0.01)
    ui._on_stop()
    ui._update()
    assert rt.last_error is None and len(rt.processed_data) > 0
    assert all(p.y_range is not None for p in ui.plots.values())
    for p in ui.plots.values():
        p.y_range = None
    ui.chk_autorange.setChecked(False)
    ui._update()
    assert all(p.y_range is None for p in ui.plots.values())
    assert ui.curves["vad"].y is not None and ui.curves["vad"].y.size > 0
    AudioRuntime.set_audio_source(rt, tone_source(0.1))
    ui._update()
    assert ui.curves["vad"].y.size == 0


def test_visualization_ui_falls_back_when_qt_constructor_fails(qtvis,
                                                               monkeypatch):
    import sspv_tpu_torch.ui as ui_pkg

    class Boom:
        def __init__(self, *a, **k):
            raise RuntimeError("xcb platform plugin failed")

    monkeypatch.setattr("sspv_tpu_torch.ui.qt.QtVisualizer", Boom)
    v = ui_pkg.VisualizationUI(runtime(), headless=False, snapshot_path=None)
    assert isinstance(v._impl, HeadlessVisualizer)


def test_qt_pitch_panel_appears_only_with_pitch_data(qtvis, monkeypatch):
    monkeypatch.setattr(Config, "TPU_ENGINE_PITCH", True)
    sr = Config.SAMPLE_RATE
    t = np.arange(int(0.4 * sr)) / sr
    rng = np.random.default_rng(0)
    sig = (9000 * np.sin(2 * np.pi * 150 * t)
           + rng.normal(0, 40, t.size)).astype(np.int16)
    rt = runtime(signal=sig)
    rt.auto_stop_on_eof = True
    ui = qtvis.QtVisualizer(rt, title="pitch session")
    assert set(ui.curves) == {"waveform", "energy", "zcr", "vad"}
    rt.start()
    _drive(rt)
    rt.stop()
    assert rt.last_error is None
    ui.timer.timeout.emit()
    assert "f0" in ui.curves and "f0" in ui.plots
    f0 = np.asarray(ui.curves["f0"].y)
    v = f0[f0 > 0]
    assert v.size and abs(float(np.median(v)) - 150) < 10
    assert ui.plots["f0"].y_range[0] == 0.0

    monkeypatch.setattr(Config, "TPU_ENGINE_PITCH", False)
    rt2 = runtime(signal=sig)
    rt2.auto_stop_on_eof = True
    ui2 = qtvis.QtVisualizer(rt2, title="plain session")
    rt2.start()
    _drive(rt2)
    rt2.stop()
    ui2.timer.timeout.emit()
    assert set(ui2.curves) == {"waveform", "energy", "zcr", "vad"}
