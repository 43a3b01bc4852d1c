#!/usr/bin/env python3
"""AudioRuntime: the streaming engine, in PyTorch on one device (the card
unless the caller asks for the CPU).

The port of ``sspv_tpu/runtime/engine.py``. Public surface matches the
reference engine exactly (``runtime/engine.py``):
``start() / stop() / set_audio_source(src, auto_stop_on_eof) /
get_recent_audio() / get_recent_processed(max_display) / save_data(directory)``
plus ``is_running`` and ``last_error`` — the 6-method duck-typed contract the
UI depends on (visualization.py:20-26).

Internally the design is block-parallel instead of a per-frame Python loop:

- a capture thread performs the blocking device/file reads (I/O needs a
  thread; that part of the reference architecture is sound);
- the processing thread sleeps until the capture thread appends audio
  (a condition it signals), then accumulates samples with a carried overlap tail
  (streaming semantics: full frames only, engine.py:240-242), splits it
  at the top of a small set of bucket sizes, and dispatches each block at
  its own frame count (the JAX engine pads it to its bucket; here the
  bucket sets only the VAD's summation order) to the device
  pipeline (features + composite VAD with carried packed ``VadState``) in
  ONE packed program. By default the payload is the RAW int16 sample block,
  framed on the device through the signal-view path (kernel K1; 4x fewer
  bytes than an f32 frame matrix); with ``TPU_STREAM_SAMPLES_DISPATCH=0``,
  and for every geometry the view kernels do not take, the host frames the
  block and the frames path (kernel K3) runs;
- dispatch is double-buffered through two slots (:class:`_Slot`), used in
  turn, each sized by the top bucket in the engine's dispatch mode: host
  staging (pinned on the card), a device input buffer, a host readback
  block and, on the card, an event. A dispatch stages its payload, then
  enqueues on the engine's own CUDA stream one body
  (:meth:`AudioRuntime._run`): the ``non_blocking`` copy of the staging
  into the device input, the mode's packed program on that device tensor,
  the write of the new state, and the ``non_blocking`` copy of the packed
  block into the readback block; then it records the slot's event. The
  block is read only when that event is done. Block k+1 is enqueued before
  block k is read back, so host framing, transfer and device compute overlap
  with readback — this replaces the reference's producer/consumer deque
  handoff (engine.py:90-103) as the concurrency mechanism;
- the engine hands the pipeline only tensors already on its device: no
  host array reaches ``FeaturePipeline._upload`` from an engine thread or a
  capture (that function's host branch serves the offline programs);
- on the card, a samples block of up to ``GRAPH_MAX_FRAMES`` frames (the
  live cadence: a few frames a capture chunk) replays a CUDA graph of that
  same body, one a block size and slot (:meth:`AudioRuntime._capture`):
  one copy into pinned staging and one launch in place of a dozen device
  operations reached through dozens of eager PyTorch calls. A replayed
  block is the eager block by construction. Larger blocks, the frames
  dispatch, pitch and the CPU run the body eagerly; every route reads and
  writes one static packed-state buffer, so the VAD state passes between
  them exactly;
- per-frame results land in the same ``processed_data`` deque-of-dicts shape
  (keys ``energy, zcr, vad, spec_entropy, vad_adaptive, mfcc``,
  engine.py:302-311) so downstream consumers are unchanged.

``save_data`` writes the byte-compatible 8-key ``.npz`` schema
(engine.py:385-395; dtypes per the committed sample files: energies/zcrs
float64, vads int32, spec_entropy/vads_adaptive float32, int32 scalars).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import logging
import threading
import time
import weakref
from collections import deque

import numpy as np

import torch

from ..config import Config
from ..config import parse_buckets as _parse_buckets
from ..ops import _build
from ..ops.pipeline import FeatureConfig, FeaturePipeline
from ..utils.framing import frame_i16_to_f32
from ..utils.profiling import span
from .audio_source import AudioSource, PyAudioSource

logger = logging.getLogger(__name__)

__all__ = ["AudioRuntime"]

# The longest the processing loop waits for audio before it looks at
# is_running again. The capture thread wakes it at once whenever it appends
# audio or ends, and stop() does, so this only bounds a flip of is_running
# from outside.
IDLE_WAIT_S = 0.1

# Samples blocks of up to this many frames (the first stream bucket by
# default) replay CUDA graphs on the card: one graph a size, so the bound
# also bounds the graphs an engine holds.
GRAPH_MAX_FRAMES = 32

# An engine's dispatch slots (_Slot): one block in flight, one being staged.
SLOTS = 2


def _parse_flag(value, default: bool, name: str) -> bool:
    """Defensive bool knob parsing (YAML overrides arrive uncoerced —
    ``TPU_LOW_LATENCY: 'true'`` is a string): garbage warns and keeps the
    default instead of aborting engine construction."""
    try:
        return bool(int(value or 0))
    except (TypeError, ValueError):
        s = str(value).strip().lower()
        if s in ("true", "yes", "on"):
            return True
        if s in ("false", "no", "off", ""):
            return False
        logger.warning("unparseable %s=%r; keeping default %s", name, value, default)
        return default


def _write_state(buf: torch.Tensor, packed) -> None:
    """Write a packed VAD state (a host array or a tensor) into the static
    buffer ``buf`` by raw bits, as int32: the last_voiced slot is an int32
    bitcast into the f32 packed state, and some of its values alias
    signaling-NaN f32 patterns that a float-typed copy could canonicalize
    (shifting the value by ~4.2M)."""
    if isinstance(packed, torch.Tensor):
        bits = packed.view(torch.int32)
    else:
        bits = torch.from_numpy(np.ascontiguousarray(packed).view(np.int32))
    buf.view(torch.int32).copy_(bits)


def _replays(device: torch.device, samples_dispatch: bool, pitch: bool,
             n: int, limit: int) -> bool:
    """Whether an ``n``-frame block takes the graph route: on the card, in
    the samples dispatch without pitch, up to ``limit`` frames."""
    return (device.type == "cuda" and samples_dispatch and not pitch
            and 0 < n <= limit)


# The raw handles of the streams live engines hold. PyTorch hands out the
# streams of a fixed pool in turn, so a new engine could draw a live one's:
# two engines on one stream would put one's eager work into the other's
# capture.
_claimed_streams: set[int] = set()
_claimed_lock = threading.Lock()
# draws from PyTorch's stream pool (32 streams a priority) before an engine
# gives up on a stream of its own
_STREAM_DRAWS = 64


def _own_stream(device: torch.device):
    """A stream of PyTorch's pool that no live engine holds, claimed for
    the caller (released when the caller is collected), or None where all
    are held."""
    with _claimed_lock:
        for _ in range(_STREAM_DRAWS):
            stream = torch.cuda.Stream(device)
            if stream.cuda_stream not in _claimed_streams:
                _claimed_streams.add(stream.cuda_stream)
                return stream
    return None


# Captures under way in this process, and whether the collector was
# enabled before the first of them (_collector_paused).
_captures = {"count": 0, "enabled": False}
_captures_lock = threading.Lock()


@contextlib.contextmanager
def _collector_paused():
    """Keep the garbage collector off while any engine captures: a
    collection runs in the thread that allocates, and one inside a capture
    that frees a graph, an event or pinned memory makes a CUDA call that
    the capture forbids, which invalidates it."""
    with _captures_lock:
        if _captures["count"] == 0:
            _captures["enabled"] = gc.isenabled()
            gc.disable()
        _captures["count"] += 1
    try:
        yield
    finally:
        with _captures_lock:
            _captures["count"] -= 1
            if _captures["count"] == 0 and _captures["enabled"]:
                gc.enable()


class _Slot:
    """One of an engine's two dispatch slots, each buffer sized by the
    engine's top bucket in its dispatch mode: host staging (pinned on the
    card) of a ``payload`` (the int16 samples of that many frames, or their
    float32 frame matrix), the device input the body copies it into, the
    host ``readback`` block the body copies the packed block into, and on
    the card the event recorded after a block's work. The engine keeps at
    most one block in flight and uses the slots in turn, so a slot's block
    is published before the slot is staged again."""

    def __init__(self, payload: tuple, dtype: torch.dtype, readback: tuple,
                 device: torch.device):
        pinned = device.type == "cuda"
        self.staging = torch.empty(payload, dtype=dtype, pin_memory=pinned)
        self.staged = self.staging.numpy()
        self.input = torch.empty(payload, dtype=dtype, device=device)
        self.readback = torch.empty(readback, pin_memory=pinned)
        self.done = torch.cuda.Event() if pinned else None


def _default_mic_source() -> PyAudioSource:
    return PyAudioSource(
        sample_rate=Config.SAMPLE_RATE,
        channels=Config.CHANNELS,
        format_const=Config.AUDIO_FORMAT,
        frames_per_buffer=Config.CHUNK_SIZE,
    )


class AudioRuntime:
    """Streaming audio → device feature/VAD engine with the reference
    surface. ``pipeline`` defaults to one of ``Config``'s geometry on
    ``device`` (the card by default)."""

    def __init__(
        self,
        audio_source: AudioSource | None = None,
        pipeline: FeaturePipeline | None = None,
        *,
        device="cuda",
    ):
        self.format = Config.AUDIO_FORMAT
        self.chunk = Config.CHUNK_SIZE
        self.audio_source: AudioSource = audio_source or _default_mic_source()
        # sources that only learn their rate in open() report 0 here; use
        # the model rate for backpressure sizing until the capture thread
        # refreshes it post-open
        self.rate = int(
            getattr(self.audio_source, "sample_rate", Config.SAMPLE_RATE)
            or Config.SAMPLE_RATE
        )
        self.channels = getattr(self.audio_source, "channels", Config.CHANNELS)
        self.frame_size = Config.FRAME_SIZE
        self.hop_size = Config.HOP_SIZE

        self.pipeline = pipeline or FeaturePipeline(
            FeatureConfig.from_config(Config), device=device
        )
        # surface parity with the reference engine (rtvp/engine.py:83), which
        # windows frames host-side in its per-frame loop; here the window is
        # applied on device, so expose the PIPELINE's window, as a host COPY:
        # mutating this public attribute must never reach the pipeline
        self.window = self.pipeline._window.cpu().numpy().copy()
        self.energy_threshold = Config.ENERGY_THRESHOLD
        self.zcr_threshold = Config.ZCR_THRESHOLD

        # display ring: raw audio chunks for the waveform plot, bounded by
        # SAMPLE count (not chunk count: sources that chronically return
        # short chunks — e.g. a playlist of sub-chunk files — would otherwise
        # hold less than a full WAVEFORM_DISPLAY_LENGTH window)
        self.audio_display_buffer: deque[np.ndarray] = deque()
        self._display_samples = 0
        self.processed_data: deque[dict] = deque(
            maxlen=Config.PROCESSED_DATA_BUFFER_SIZE
        )
        # opt-in real-time pitch (TPU_ENGINE_PITCH): (f0, confidence) per
        # frame, same retention as processed_data. A SEPARATE deque so the
        # reference-parity frame dicts and the frozen save_data npz schema
        # stay untouched; always appended under the same lock acquisition as
        # processed_data, so the two are index-aligned.
        self.pitch_data: deque[tuple] = deque(
            maxlen=Config.PROCESSED_DATA_BUFFER_SIZE
        )
        # host-side mirrors of the adaptive-VAD history (API parity; the
        # authoritative copy lives in the device VadState)
        hist_len = int(getattr(Config, "VAD_HISTORY_LEN", 256))
        self.energy_history: deque[float] = deque(maxlen=hist_len)
        self.zcr_history: deque[float] = deque(maxlen=hist_len)

        self.is_running = False
        self.last_error: Exception | None = None
        self.auto_stop_on_eof: bool = False
        self.lock = threading.Lock()
        # signalled (under ``lock``) when audio is appended to the backlog,
        # when the capture thread ends and on stop(): the idle processing
        # loop waits on it instead of polling
        self._audio_ready = threading.Condition(self.lock)
        # Device dispatches since construction (one packed program per
        # increment): soak harnesses log memory against it and measure the
        # effect of TPU_MIN_DISPATCH_INTERVAL coalescing.
        self.dispatch_count = 0
        # Of those, the ones that replayed a CUDA graph (_capture).
        self.graph_replays = 0
        # Monotonic count of frames materialized to the host since
        # construction (unlike ``processed_data``, never trimmed) — lets
        # serving harnesses track completion/throughput without polling the
        # bounded display deque (examples/multistream_bench.py, soak logs).
        self.frames_processed = 0

        self._capture_thread: threading.Thread | None = None
        self._process_thread: threading.Thread | None = None
        self._pending: list[np.ndarray] = []  # captured, not yet processed
        self._pending_samples = 0
        self._update_max_pending()
        # Every dispatch runs on the engine's own stream, so graphed and
        # eager blocks stay in order against the state. None on the CPU, and
        # where every stream of PyTorch's pool is another live engine's:
        # that engine then runs eagerly on the current stream.
        dev = self.pipeline.device
        self._stream = _own_stream(dev) if dev.type == "cuda" else None
        if self._stream is not None:
            weakref.finalize(self, _claimed_streams.discard,
                             self._stream.cuda_stream)
        # Streaming VAD state, packed into ONE static f32 buffer on the
        # pipeline's device (ops/vad.py pack_state) that every dispatch
        # reads and overwrites: it never round-trips.
        self._vad_state_packed = torch.empty(
            self.pipeline.initial_packed_state().shape, dtype=torch.float32,
            device=dev)
        with torch.cuda.stream(self._stream):
            _write_state(self._vad_state_packed,
                         self.pipeline.initial_packed_state())
        self._buckets = _parse_buckets(
            getattr(Config, "TPU_STREAM_BUCKETS", (32, 256, 2048))
        )
        self._graph_frames = min(self._buckets[0], GRAPH_MAX_FRAMES)
        # (n, slot) -> (the CUDA graph of the body of n-frame blocks in that
        # slot, the launches its capture counted); None where nothing
        # replays. The graphs of one engine share one memory pool: they run
        # one at a time on the engine's stream, and nothing they allocate
        # outlives a replay.
        self._graphs = {} if self._stream is not None else None
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self._stream is not None else None)
        # Low-latency mode: no in-flight block (each dispatch is materialized
        # immediately) + the JAX engine's extra small bucket, which there
        # spares a near-real-time cadence (a handful of frames per capture
        # chunk) the pad to 32; here it sets the VAD order of such blocks.
        self._low_latency = _parse_flag(
            getattr(Config, "TPU_LOW_LATENCY", 0), False, "TPU_LOW_LATENCY"
        )
        # Opt-in real-time pitch: dispatch the pitch-enabled packed programs
        # (two extra block columns, the same feature columns).
        self._pitch_enabled = _parse_flag(
            getattr(Config, "TPU_ENGINE_PITCH", 0), False, "TPU_ENGINE_PITCH"
        )
        try:
            self._pitch_min_conf = float(
                getattr(Config, "TPU_ENGINE_PITCH_MIN_CONF", 0.3)
            )
        except (TypeError, ValueError):
            logger.warning(
                "unparseable TPU_ENGINE_PITCH_MIN_CONF=%r; using 0.3",
                Config.TPU_ENGINE_PITCH_MIN_CONF,
            )
            self._pitch_min_conf = 0.3
        if self._low_latency and self._buckets[0] > 8:
            self._buckets = (8,) + self._buckets
        # Samples dispatch (default): ship raw int16 samples and frame ON
        # DEVICE via the signal-view path (K1, or K3 on the device-formed
        # frames in a view geometry K1 does not take) — 4x fewer bytes per
        # dispatch than the f32 frame-matrix layout (2x dtype, 2x the
        # 50%-overlap duplication). The frames layout (K3) serves every
        # other geometry.
        self._samples_dispatch = _parse_flag(
            getattr(Config, "TPU_STREAM_SAMPLES_DISPATCH", 1), True,
            "TPU_STREAM_SAMPLES_DISPATCH",
        ) and self.pipeline.supports_samples_dispatch() and (
            self.frame_size == self.pipeline.cfg.frame_size
            and self.hop_size == self.pipeline.cfg.hop_size
        )
        # parsed HERE (warn-and-default like every other knob), never inside
        # the processing thread: an unparseable value raising before that
        # thread's try block would kill it silently — is_running stuck True,
        # last_error None, capture spinning at backpressure forever
        try:
            self._min_dispatch_interval = max(
                0.0,
                float(getattr(Config, "TPU_MIN_DISPATCH_INTERVAL", 0.0) or 0.0),
            )
        except (TypeError, ValueError):
            logger.warning(
                "unparseable TPU_MIN_DISPATCH_INTERVAL=%r; using 0",
                Config.TPU_MIN_DISPATCH_INTERVAL,
            )
            self._min_dispatch_interval = 0.0
        # The mode's packed program, and the slots sized by the top bucket:
        # the largest block dispatch_split sends.
        top, c = self._buckets[-1], self.pipeline.cfg
        if self._samples_dispatch:
            payload = ((top - 1) * self.hop_size + self.frame_size,)
            dtype = torch.int16
            program = (self.pipeline.process_signal_packed_pitch
                       if self._pitch_enabled
                       else self.pipeline.process_signal_packed)
        else:
            payload, dtype = (top, self.frame_size), torch.float32
            program = (self.pipeline.process_block_packed_pitch
                       if self._pitch_enabled
                       else self.pipeline.process_block_packed)
        cols = (self.pipeline.PACKED_PREFIX_COLS + c.num_ceps
                + 2 * self._pitch_enabled)
        self._program = (functools.partial(
            program, min_confidence=self._pitch_min_conf)
            if self._pitch_enabled else program)
        self._slots = [_Slot(payload, dtype, (top, cols), dev)
                       for _ in range(SLOTS)]
        self._slot = 0

    def _update_max_pending(self) -> None:
        """Backpressure bound on the capture backlog (samples). The reference
        uses a lossy 4-chunk deque (engine.py:90); we block the producer
        instead so file/playlist input is lossless even when the device path
        stalls (e.g. the first kernel build). Recomputed whenever the source (and thus
        the sample rate) changes; non-positive configs fall back to 30 s."""
        try:
            seconds = float(getattr(Config, "TPU_MAX_PENDING_SECONDS", 30.0))
        except Exception:
            seconds = 30.0
        if seconds <= 0:
            seconds = 30.0
        self._max_pending = max(int(seconds * self.rate), Config.CHUNK_SIZE)

    # ------------------------------------------------------------------
    # source management
    # ------------------------------------------------------------------

    def set_audio_source(
        self, audio_source: AudioSource | None, auto_stop_on_eof: bool = False
    ) -> None:
        """Swap the input source (None → microphone); stops first and clears
        buffers and adaptive-VAD history (hangover state is intentionally
        preserved across swaps, as in the reference)."""
        # stop() UNCONDITIONALLY: after an auto-stop-on-EOF is_running is
        # already False but the processing thread may still be draining its
        # in-flight block — an is_running gate here would race that drain
        # against the buffer clears and the state reset below
        self.stop()
        self.audio_source = audio_source or _default_mic_source()
        # sources that only learn their rate in open() report 0 here; use
        # the model rate for backpressure sizing until the capture thread
        # refreshes it post-open
        self.rate = int(
            getattr(self.audio_source, "sample_rate", Config.SAMPLE_RATE)
            or Config.SAMPLE_RATE
        )
        self.channels = getattr(self.audio_source, "channels", Config.CHANNELS)
        self.auto_stop_on_eof = bool(auto_stop_on_eof)
        self._update_max_pending()
        with self.lock:
            self._pending.clear()
            self._pending_samples = 0
            self.processed_data.clear()
            self.pitch_data.clear()
            self.energy_history.clear()
            self.zcr_history.clear()
            self.audio_display_buffer.clear()
            self._display_samples = 0
        # reset history, keep hangover distance: the last_voiced slot is an
        # int32 bitcast into the f32 packed state, so both copies move raw
        # bits (_write_state); on the engine's stream, after its work
        fresh = self.pipeline.initial_packed_state()
        with torch.cuda.stream(self._stream):
            fresh.view(np.int32)[-1] = (
                self._vad_state_packed.cpu().numpy().view(np.int32)[-1]
            )
            _write_state(self._vad_state_packed, fresh)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> None:
        if self.is_running:
            return
        # join threads from a previous run that are still draining (e.g.
        # after an auto-stop-on-EOF with no intervening stop()): two process
        # loops must never share the VAD state or the pending buffers
        for t in (self._capture_thread, self._process_thread):
            if t is not None and t.is_alive():
                t.join()
        # a fresh run must not look failed to error-polling consumers (the
        # headless UI stops on any non-None last_error): a stale error from
        # a previous source would otherwise kill recovered sessions
        self.last_error = None
        self.is_running = True
        self._capture_thread = threading.Thread(target=self._capture_loop, daemon=True)
        self._process_thread = threading.Thread(target=self._process_loop, daemon=True)
        self._capture_thread.start()
        self._process_thread.start()

    def stop(self) -> None:
        # Always join: after an auto-stop-on-EOF the capture thread has
        # already flipped is_running, but the processing thread may still be
        # draining its in-flight block — callers expect stop() to return only
        # once results are final.
        self.is_running = False
        self._wake()
        for t in (self._capture_thread, self._process_thread):
            if t is not None and t.is_alive():
                t.join()
        self._capture_thread = None
        self._process_thread = None

    # ------------------------------------------------------------------
    # threads
    # ------------------------------------------------------------------

    def _wake(self) -> None:
        """Wake a processing loop that waits for audio."""
        with self._audio_ready:
            self._audio_ready.notify_all()

    def _capture_loop(self) -> None:
        opened = False
        try:
            self.audio_source.open()
            opened = True
            # FileAudioSource built without a target rate only learns its
            # true sample rate in open(); refresh so the backpressure window
            # (seconds -> samples) and the npz sample_rate field use the real
            # rate instead of the pre-open 0.
            sr = int(getattr(self.audio_source, "sample_rate", 0) or 0)
            if sr and sr != self.rate:
                self.rate = sr
                self._update_max_pending()
            while self.is_running:
                data = self.audio_source.read(self.chunk)
                if data is None or len(data) == 0:
                    if (
                        bool(getattr(self.audio_source, "exhausted", False))
                        and self.auto_stop_on_eof
                    ):
                        self.is_running = False
                        break
                    time.sleep(Config.THREAD_SLEEP_TIME)
                    continue
                arr = np.asarray(data, dtype=np.int16)
                # backpressure: block (not drop) while the device path digests
                while self._pending_samples >= self._max_pending and self.is_running:
                    time.sleep(Config.THREAD_SLEEP_TIME)
                with self.lock:
                    self._pending.append(arr)
                    self._pending_samples += len(arr)
                    self._audio_ready.notify_all()
                    self.audio_display_buffer.append(arr.copy())
                    self._display_samples += len(arr)
                    # evict whole chunks while the window stays full
                    while (
                        self._display_samples - len(self.audio_display_buffer[0])
                        >= Config.WAVEFORM_DISPLAY_LENGTH
                    ):
                        self._display_samples -= len(
                            self.audio_display_buffer.popleft()
                        )
        except Exception as e:
            self.last_error = e
            # Stop the engine: a dead capture thread can never produce data
            # or reach EOF, so leaving is_running True would hang headless
            # consumers forever. The error is preserved in last_error.
            self.is_running = False
            logger.exception("audio capture thread failed: %s", e)
        finally:
            try:
                if opened:
                    self.audio_source.close()
            except Exception:
                pass
            self._wake()

    def _take_frames(self, carry: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Pull pending samples, return (raw frame block, new carry)."""
        with self.lock:
            chunks = self._pending
            self._pending = []
            self._pending_samples = 0
        if chunks:
            carry = np.concatenate([carry] + chunks)
        if len(carry) < self.frame_size:
            return np.zeros((0, self.frame_size), np.float32), carry
        frames = frame_i16_to_f32(carry, self.frame_size, self.hop_size)
        return frames, carry[frames.shape[0] * self.hop_size :]

    def _take_samples(self, carry: np.ndarray) -> tuple[np.ndarray | None, np.ndarray]:
        """Pull pending samples, return (int16 sample block covering every
        complete frame, new carry). The block and the carry overlap by
        ``frame_size - hop_size`` samples (streaming framing semantics:
        frame n's tail is frame n+1's head)."""
        with self.lock:
            chunks = self._pending
            self._pending = []
            self._pending_samples = 0
        if chunks:
            carry = np.concatenate([carry] + chunks)
        if len(carry) < self.frame_size:
            return None, carry
        n = 1 + (len(carry) - self.frame_size) // self.hop_size
        block = carry[: (n - 1) * self.hop_size + self.frame_size]
        return block, carry[n * self.hop_size :]

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        # callers split blocks larger than the top bucket (_process_loop)
        return self._buckets[-1]

    def _run(self, slot: _Slot, size: int, n: int, bucket: int) -> None:
        """The body of every block, eager or captured, enqueued on the
        current stream: the staged payload (``size`` samples or frames) into
        the slot's device input, the mode's packed program on it with the
        packed-state buffer (the VAD order of ``bucket``), the new state
        into that buffer (it never leaves the device), and the ``n``-frame
        packed block into the slot's readback rows."""
        x = slot.input[:size]
        x.copy_(slot.staging[:size], non_blocking=True)
        out, new = self._program(x, self._vad_state_packed, size,
                                 route_frames=bucket)
        _write_state(self._vad_state_packed, new)
        slot.readback[:n].copy_(out, non_blocking=True)

    def _capture(self, n: int, size: int, bucket: int) -> None:
        """Capture the body of ``n``-frame blocks, one graph a slot, on the
        engine's stream (the caller's current stream), after that stream's
        work is done. Other engines capture and dispatch in their own
        threads meanwhile: the capture's error mode is thread-local."""
        self._stream.synchronize()
        for k, slot in enumerate(self._slots):
            graph = torch.cuda.CUDAGraph()
            with _collector_paused(), _build.recording() as launches:
                graph.capture_begin(pool=self._graph_pool,
                                    capture_error_mode="thread_local")
                try:
                    self._run(slot, size, n, bucket)
                finally:
                    graph.capture_end()
            self._graphs[n, k] = graph, tuple(launches)

    def _replay(self, n: int, k: int) -> None:
        """Replay the graph of ``n``-frame blocks in slot ``k``; each replay
        counts the launches its capture counted."""
        graph, launches = self._graphs[n, k]
        graph.replay()
        for kernel, route in launches:
            _build.count(kernel, route)

    def _dispatch(self, payload: np.ndarray, n: int):
        """Enqueue one block of ``n`` frames (its int16 samples, or its
        frame matrix in the frames dispatch) through the next slot on the
        engine's stream: wait until the slot's last block has left it,
        stage the payload, run the body (:meth:`_run`) or replay its graph,
        and record the slot's event. The block's bucket, the shape the JAX
        engine pads it to, sets only the VAD's summation order. A block that
        takes the graph route (:func:`_replays`) replays the graph of its
        size once one block of that size has run eagerly and the graphs are
        captured. Returns what :meth:`_materialize` takes: ``(host block,
        event, frames, the block's request id)``."""
        with (span("sspv.engine.dispatch") as req,
              torch.cuda.stream(self._stream)):
            k, self._slot = self._slot, (self._slot + 1) % SLOTS
            slot, size, bucket = self._slots[k], len(payload), self._bucket_for(n)
            graphed = self._graphs is not None and _replays(
                self.pipeline.device, self._samples_dispatch,
                self._pitch_enabled, n, self._graph_frames)
            replay = graphed and (n, 0) in self._graphs
            with (span("sspv.engine.replay") if replay
                  else contextlib.nullcontext()):
                if slot.done is not None:
                    slot.done.synchronize()
                slot.staged[:size] = payload
                if replay:
                    self._replay(n, k)
                else:
                    self._run(slot, size, n, bucket)
                if slot.done is not None:
                    slot.done.record(
                        self._stream if self._stream is not None
                        else torch.cuda.current_stream(self.pipeline.device))
            if replay:
                self.graph_replays += 1
            elif graphed:
                self._capture(n, size, bucket)
            self.dispatch_count += 1
            return slot.readback[:n], slot.done, n, req

    def _materialize(self, inflight) -> None:
        """Wait for one dispatched block's readback (its event) and publish
        the block: ONE packed array per block, split on the host. The
        publish span carries the block's request id, its dispatch's."""
        out, done, n, req = inflight
        if done is not None:
            with span("sspv.engine.readback_wait", req):
                done.synchronize()
        with span("sspv.engine.publish", req):
            self._publish(out.numpy(), n)

    def _publish(self, packed: np.ndarray, n: int) -> None:
        if self._pitch_enabled:
            host, f0, conf = self.pipeline.split_packed_block_pitch(packed, n)
        else:
            host = self.pipeline.split_packed_block(packed, n)
            f0 = conf = None
        energy = host.energy
        zcr = host.zcr
        entropy = host.entropy
        vad = host.vad
        vad_adaptive = host.vad_adaptive
        mfcc = host.mfcc
        with self.lock:
            self.frames_processed += n
            for i in range(n):
                self.energy_history.append(float(energy[i]))
                self.zcr_history.append(float(zcr[i]))
                self.processed_data.append(
                    {
                        "energy": float(energy[i]),
                        "zcr": float(zcr[i]),
                        "vad": int(vad[i]),
                        "spec_entropy": float(entropy[i]),
                        "vad_adaptive": int(vad_adaptive[i]),
                        "mfcc": mfcc[i].tolist(),
                    }
                )
                if f0 is not None:
                    self.pitch_data.append((float(f0[i]), float(conf[i])))

    def _process_loop(self) -> None:
        carry = np.zeros((0,), dtype=np.int16)
        inflight = None  # double buffer: one block in flight
        max_bucket = self._buckets[-1]
        min_interval = self._min_dispatch_interval
        last_dispatch = 0.0
        hop, frame = self.hop_size, self.frame_size

        def take(carry):
            """Mode-dependent pull: returns (payload or None, n_frames, carry)."""
            with span("sspv.engine.take"):
                if self._samples_dispatch:
                    block, carry = self._take_samples(carry)
                    if block is None:
                        return None, 0, carry
                    return block, 1 + (len(block) - frame) // hop, carry
                frames, carry = self._take_frames(carry)
                if frames.shape[0] == 0:
                    return None, 0, carry
                return frames, frames.shape[0], carry

        def poll_wait():
            with span("sspv.engine.poll_wait"):
                time.sleep(Config.THREAD_SLEEP_TIME)

        def wait_for_audio():
            """Wait until the capture thread appends audio or ends, or the
            engine stops: one wake a capture chunk, where 1 ms polls woke
            some sixty times (each wake costs the host CPU)."""
            with span("sspv.engine.poll_wait"), self._audio_ready:
                if not self._pending and self.is_running:
                    self._audio_ready.wait(IDLE_WAIT_S)

        def dispatch_split(payload, n, inflight):
            """Dispatch ``payload`` in <=max_bucket-frame slices, keeping
            exactly one block in flight (pipelining preserved). In low-latency mode nothing stays in flight: results
            are fetched as soon as each block is enqueued. In samples mode
            consecutive slices share the frame-overlap samples."""
            for lo in range(0, n, max_bucket):
                hi = min(n, lo + max_bucket)
                part = (payload[lo * hop : (hi - 1) * hop + frame]
                        if self._samples_dispatch else payload[lo:hi])
                nxt = self._dispatch(part, hi - lo)
                if inflight is not None:
                    self._materialize(inflight)
                if self._low_latency:
                    self._materialize(nxt)
                else:
                    inflight = nxt
            return inflight

        try:
            while self.is_running:
                if min_interval and time.monotonic() - last_dispatch < min_interval:
                    # publish the ready in-flight block while throttled —
                    # holding it would delay results by up to min_interval
                    # for no saved dispatch
                    if inflight is not None:
                        self._materialize(inflight)
                        inflight = None
                    poll_wait()
                    continue
                payload, n, carry = take(carry)
                if n == 0:
                    if inflight is not None:
                        self._materialize(inflight)
                        inflight = None
                    wait_for_audio()
                    continue
                last_dispatch = time.monotonic()
                inflight = dispatch_split(payload, n, inflight)
            # drain: publish the last in-flight block, then keep taking until
            # the capture thread has exited AND nothing remains pending — the
            # capture loop may append its final chunk AFTER is_running flips,
            # so a single take here could run before that append and strand
            # the last audio (it would then splice into the next session).
            if inflight is not None:
                self._materialize(inflight)
                inflight = None
            while True:
                cap = self._capture_thread
                cap_dead = cap is None or not cap.is_alive()
                payload, n, carry = take(carry)
                if n:
                    inflight = dispatch_split(payload, n, None)
                    if inflight is not None:  # low-latency already materialized
                        self._materialize(inflight)
                        inflight = None
                    continue
                if cap_dead:
                    # liveness was sampled BEFORE the take: a dead capture
                    # thread's final append happened-before that take, so an
                    # empty take here means truly drained
                    break
                poll_wait()
        except Exception as e:
            self.last_error = e
            self.is_running = False  # see capture-thread note: don't hang pollers
            logger.exception("processing thread failed: %s", e)

    # ------------------------------------------------------------------
    # data access
    # ------------------------------------------------------------------

    def get_recent_audio(self) -> np.ndarray:
        """Last <= WAVEFORM_DISPLAY_LENGTH raw int16 samples for display."""
        with self.lock:
            if not self.audio_display_buffer:
                return np.array([], dtype=np.int16)
            recent = np.concatenate(list(self.audio_display_buffer))
        limit = Config.WAVEFORM_DISPLAY_LENGTH
        return recent[-limit:] if len(recent) > limit else recent

    def get_recent_processed(self, max_display=None):
        """Last ``max_display`` frames as ``(energies, zcrs, vads)`` arrays."""
        if max_display is None:
            max_display = Config.MAX_DISPLAY_FRAMES
        with self.lock:
            if not self.processed_data:
                return np.array([]), np.array([]), np.array([])
            energies = [d["energy"] for d in self.processed_data]
            zcrs = [d["zcr"] for d in self.processed_data]
            vads = [d["vad"] for d in self.processed_data]
        if len(energies) > max_display:
            energies = energies[-max_display:]
            zcrs = zcrs[-max_display:]
            vads = vads[-max_display:]
        return np.array(energies), np.array(zcrs), np.array(vads)

    def get_recent_pitch(self, max_display=None):
        """Last ``max_display`` frames as ``(f0, confidence)`` arrays —
        empty when ``TPU_ENGINE_PITCH`` is off. Both deques are appended
        under one lock acquisition, but two separate accessor calls can
        straddle a block append — use :meth:`get_recent_display` when the
        pitch series must align with the feature series."""
        if max_display is None:
            max_display = Config.MAX_DISPLAY_FRAMES
        with self.lock:
            rows = list(self.pitch_data)
        return self._pitch_rows_to_arrays(rows, max_display)

    @staticmethod
    def _pitch_rows_to_arrays(rows, max_display):
        if not rows:
            return np.array([]), np.array([])
        if len(rows) > max_display:
            rows = rows[-max_display:]
        f0, conf = zip(*rows)
        return np.array(f0), np.array(conf)

    def get_recent_display(self, max_display=None):
        """One aligned snapshot for display polls:
        ``(energies, zcrs, vads, f0)`` taken under a SINGLE lock
        acquisition — separate ``get_recent_processed`` +
        ``get_recent_pitch`` calls can straddle a block materialization and
        shift the pitch panel against the others. ``f0`` is empty when
        pitch is off."""
        if max_display is None:
            max_display = Config.MAX_DISPLAY_FRAMES
        with self.lock:
            rows = list(self.processed_data)
            pitch_rows = list(self.pitch_data)
        if len(rows) > max_display:
            rows = rows[-max_display:]
        f0, _conf = self._pitch_rows_to_arrays(pitch_rows, max_display)
        return (
            np.array([d["energy"] for d in rows]),
            np.array([d["zcr"] for d in rows]),
            np.array([d["vad"] for d in rows]),
            f0,
        )

    def save_data(self, directory=None) -> str:
        """Write the 8-key ``.npz`` export; returns the file path.

        All five per-frame series are extracted from ONE snapshot of
        ``processed_data`` taken under a single lock acquisition, so the
        exported arrays are always aligned even while streaming is live.
        This deliberately diverges from the reference, whose export reads
        the deque twice under separate lock acquisitions
        (rtvp/engine.py:377-384) — a block materialized between the two reads
        misaligns the energy/zcr/vad arrays against entropy/adaptive there.
        """
        if directory is None:
            directory = Config.SAVE_DIRECTORY
        timestamp = time.strftime("%Y%m%d_%H%M%S")
        filename = f"{directory}/voice_processing_data_{timestamp}.npz"
        limit = Config.PROCESSED_DATA_BUFFER_SIZE
        with self.lock:
            snapshot = list(self.processed_data)[-limit:]
        energies = [d["energy"] for d in snapshot]
        zcrs = [d["zcr"] for d in snapshot]
        vads = [d["vad"] for d in snapshot]
        spec_entropies = [d.get("spec_entropy", np.nan) for d in snapshot]
        vads_adaptive = [d.get("vad_adaptive", np.nan) for d in snapshot]
        np.savez(
            filename,
            energies=np.asarray(energies, dtype=np.float64),
            zcrs=np.asarray(zcrs, dtype=np.float64),
            vads=np.asarray(vads, dtype=np.int32),
            spec_entropy=np.asarray(spec_entropies, dtype=np.float32),
            vads_adaptive=np.asarray(vads_adaptive, dtype=np.float32),
            sample_rate=np.int32(self.rate),
            frame_size=np.int32(self.frame_size),
            hop_size=np.int32(self.hop_size),
        )
        return filename
