#!/usr/bin/env python3
"""HTTP serving layer of the port: speech features / VAD / pitch as a
network service, the port's copy of ``sspv_tpu/serve.py``.

All requests share ONE ``FeaturePipeline`` on one device (the card unless
``--device`` says otherwise) and the per-request state is purely
functional, so a stdlib threaded HTTP server in front of the pipeline is all
the machinery a single-card deployment needs: each request thread launches
the kernels on the device's current stream, where they queue. Each request
runs at its own length (the JAX server pads it to a
``FeaturePipeline.SIGNAL_BUCKET_SECONDS`` bucket, which here sets only the
VAD's summation order); the largest bucket caps a request's duration and
the buckets are the warm-up's sizes. Requests, routes, status codes and
error messages are the JAX server's.

Endpoints
---------
- ``GET  /healthz``       -> backend + device count (touches the device: it
  IS the health probe).
- ``GET  /config``        -> JSON dump of every overridable Config attr.
- ``POST /v1/features``   -> per-frame energy/zcr/entropy/MFCC/VAD.
- ``POST /v1/vad``        -> just the composite + adaptive VAD decisions.
- ``POST /v1/pitch``      -> VAD-gated F0 track + confidence.
- ``POST /v1/stream``     -> STREAMING: chunked raw int16 PCM at the model
  rate in, chunked NDJSON out — one line per processed frame block as it
  lands (``FeaturePipeline.stream`` semantics: carried overlap tail +
  VadState, blocks split at the top engine bucket, so results are
  bit-identical to the offline pipeline under any chunking). ``?mfcc=1`` adds MFCC rows.
  Long-running clients should read the response concurrently with sending
  (results stream back while audio is still arriving); a send-everything-
  then-read client is fine up to OS socket-buffer scale.

Request body: a PCM WAV file (``Content-Type: audio/wav`` or a ``RIFF``
magic), or raw little-endian int16 PCM (``application/octet-stream``) with
the sample rate in an ``X-Sample-Rate`` header or ``?rate=`` query. Any
sample rate is accepted (polyphase resample to ``Config.SAMPLE_RATE``, the
same ladder as ``FileAudioSource``); multi-channel audio is mean-downmixed.
Response: JSON (default) or ``?fmt=npz`` for a compressed npz payload.

Run: ``python -m sspv_tpu_torch.serve [--device cpu]`` (env:
``RTP_SERVE_HOST``, ``RTP_SERVE_PORT``; ``RTP_SERVE_WARMUP=0`` skips the
warm-up, which builds the kernels and serves one request of each program
family, ``=all`` warms every signal bucket for production).
"""

from __future__ import annotations

import io
import json
import logging
import os
import urllib.parse
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .config import Config

logger = logging.getLogger(__name__)

_MAX_BODY_BYTES = 512 * 1024 * 1024  # 512 MB ~ 4.5 h of 16 kHz wav


class AudioDecodeError(ValueError):
    """Request body could not be decoded into PCM audio."""


def decode_audio(
    body: bytes, content_type: str = "", rate_hint: int | None = None
) -> tuple[np.ndarray, int]:
    """Decode a request body to mono int16 samples + sample rate.

    WAV (PCM 8/16/32-bit) via stdlib ``wave``; raw int16 PCM needs
    ``rate_hint``. Multi-channel is mean-downmixed (``FileAudioSource``
    default, runtime/audio_source.py).
    """
    if not body:
        raise AudioDecodeError("empty request body")
    ct = (content_type or "").split(";")[0].strip().lower()
    if body[:4] == b"RIFF" or ct in ("audio/wav", "audio/x-wav", "audio/wave"):
        try:
            with wave.open(io.BytesIO(body)) as w:
                sr = w.getframerate()
                nch = w.getnchannels()
                width = w.getsampwidth()
                raw = w.readframes(w.getnframes())
        except Exception as e:
            raise AudioDecodeError(f"invalid WAV: {e}") from e
        if width == 2:
            data = np.frombuffer(raw, dtype="<i2").astype(np.float32)
        elif width == 4:
            # arithmetic shift (floor), NOT a float divide-then-truncate:
            # the FileAudioSource ladder uses >>16, and the same file must
            # yield identical samples via HTTP and via the batch/analyze CLIs
            data = (np.frombuffer(raw, dtype="<i4") >> 16).astype(np.float32)
        elif width == 1:  # 8-bit WAV is unsigned
            data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) * 256.0
        else:
            raise AudioDecodeError(f"unsupported WAV sample width: {width}")
        if nch > 1:
            data = data[: (len(data) // nch) * nch].reshape(-1, nch).mean(axis=1)
        samples = np.clip(data, -32768.0, 32767.0).astype(np.int16)
        if not 1 <= int(sr) <= 768_000:
            # stdlib wave happily reads a fmt chunk claiming rate 0; an
            # unvalidated 0 would ZeroDivisionError in the duration cap
            raise AudioDecodeError(f"implausible WAV sample rate: {sr}")
        return samples, int(sr)
    if ct in ("application/octet-stream", "audio/l16", ""):
        if rate_hint is None:
            raise AudioDecodeError(
                "raw PCM needs a sample rate (X-Sample-Rate header or ?rate=)"
            )
        rate = int(rate_hint)
        if not 1 <= rate <= 768_000:
            raise AudioDecodeError(f"implausible sample rate: {rate}")
        if len(body) % 2:
            body = body[:-1]
        return np.frombuffer(body, dtype="<i2"), rate
    raise AudioDecodeError(f"unsupported content type: {content_type}")


class FeatureService:
    """Stateless per-request analysis over one shared ``FeaturePipeline``
    on ``device`` (the card unless the caller asks for another).

    Thread-safe: the pipeline's constants are shared and read-only, its
    kernels count their launches under a lock, and per-request VAD state is
    created fresh and discarded, so requests never observe each other. A
    process that serves from several threads keeps the float32 matmul
    precision at ``"highest"`` (``main`` pins it): ``ops.fp32.full_fp32``
    then writes nothing.
    """

    def __init__(self, pipeline=None, *, device="cuda"):
        from .ops.pipeline import FeatureConfig, FeaturePipeline

        self.pipe = pipeline or FeaturePipeline(
            FeatureConfig.from_config(Config), device=device
        )

    # -- helpers ---------------------------------------------------------

    def _to_model_rate(self, samples: np.ndarray, sr: int) -> np.ndarray:
        from .runtime.audio_source import _resample_to

        target = self.pipe.cfg.sample_rate
        return np.asarray(_resample_to(
            np.asarray(samples, dtype=np.int16), sr, target,
            device=self.pipe.device,
        ))

    # -- analysis --------------------------------------------------------

    def analyze(
        self,
        samples: np.ndarray,
        sample_rate: int,
        want_pitch: bool = False,
        fmin: float = 50.0,
        fmax: float = 400.0,
        min_confidence: float = 0.3,
    ) -> dict:
        """Full per-frame analysis of one utterance; returns numpy arrays."""
        c = self.pipe.cfg
        # stays int16 end-to-end: the host->device transfer ships half the
        # bytes and the cast to float32 happens on device, exactly
        sig = self._to_model_rate(samples, sample_rate)
        out: dict = {
            "sample_rate": c.sample_rate,
            "num_samples": int(len(sig)),
            "frame_size": c.frame_size,
            "hop_size": c.hop_size,
        }
        if len(sig) < c.frame_size:
            z = np.zeros((0,), np.float32)
            out.update(
                num_frames=0, energy=z, zcr=z, entropy=z,
                mfcc=np.zeros((0, c.num_ceps), np.float32),
                vad=np.zeros((0,), np.int32),
                vad_adaptive=np.zeros((0,), np.int32),
            )
            if want_pitch:
                out.update(f0=z, pitch_confidence=z)
            return out
        fused = want_pitch and (fmin, fmax) == (50.0, 400.0)
        if fused:
            # the JAX server's split, kept so that each route can be held
            # to its response: the default band takes the fused call
            # (features + VAD + VAD-gated pitch, the signal uploaded once),
            # a custom band the two-call path. Their outputs are equal.
            block, _state, f0, conf = self.pipe.process_signal_pitch_auto(
                sig, min_confidence=min_confidence
            )
        else:
            block, _state = self.pipe.process_signal_auto(sig)
        # np.asarray of a CUDA tensor raises: one explicit copy per field
        vad = block.vad.cpu().numpy()
        out.update(
            num_frames=int(vad.shape[0]),
            energy=block.energy.cpu().numpy(),
            zcr=block.zcr.cpu().numpy(),
            entropy=block.entropy.cpu().numpy(),
            mfcc=block.mfcc.cpu().numpy(),
            vad=vad.astype(np.int32),
            vad_adaptive=block.vad_adaptive.cpu().numpy().astype(np.int32),
        )
        if want_pitch:
            if not fused:  # custom band: the features' call, then the track
                f0, conf = self.pipe.pitch_signal_auto(
                    sig, vad, fmin=fmin, fmax=fmax,
                    min_confidence=min_confidence,
                )
            out["f0"], out["pitch_confidence"] = f0, conf
        return out

    def stream_blocks(self, chunks, pitch: bool = False,
                      min_confidence: float = 0.3):
        """Generator: iterable of int16 sample chunks (model rate) ->
        FeatureBlock per completed frame block, with overlap tail and VAD
        state carried across chunks (``FeaturePipeline.stream``). With
        ``pitch=True`` yields ``(block, f0, conf)`` from the fused
        streaming program (``FeaturePipeline.stream_pitch``, default band —
        same single-dispatch-per-block budget)."""
        if pitch:
            return self.pipe.stream_pitch(chunks, min_confidence=min_confidence)
        return self.pipe.stream(chunks)

    def warmup(self, all_buckets: bool = False) -> None:
        """Build and load the kernel library (on a CUDA device: nvcc, some
        seconds, unless a library of the current sources is on disk), then
        serve one request of each program family so the first client does
        not pay for it: features and pitch at the smallest signal bucket,
        and one ``/v1/stream`` block at the smallest stream bucket.

        Nothing compiles per shape in the port, so ``all_buckets=True`` (a
        production server whose clients send arbitrary-length payloads)
        buys less than in the JAX package: each bucket's first run grows
        the CUDA caching allocator to that bucket's working set, creates
        the library handles its shapes need, and fills the pipeline's lazy
        tables; it also warms every stream bucket and the streaming pitch
        family (``/v1/stream?pitch=1``)."""
        from .config import parse_buckets
        from .ops import _build

        if self.pipe.device.type == "cuda":
            _build.library()
        c = self.pipe.cfg
        sr = c.sample_rate
        buckets = (
            self.pipe.SIGNAL_BUCKET_SECONDS
            if all_buckets else self.pipe.SIGNAL_BUCKET_SECONDS[:1]
        )
        for sec in buckets:
            sig = np.zeros((sec * sr,), np.int16)
            # both program families: the plain masked program serves
            # /v1/features and /v1/vad, the fused one serves /v1/pitch
            self.analyze(sig, sr, want_pitch=False)
            self.analyze(sig, sr, want_pitch=True)
        stream_buckets = parse_buckets(
            getattr(Config, "TPU_STREAM_BUCKETS", (32, 256, 2048))
        )
        for b in stream_buckets if all_buckets else stream_buckets[:1]:
            n = (b - 1) * c.hop_size + c.frame_size
            for _block in self.pipe.stream(iter([np.zeros((n,), np.int16)])):
                pass
            if all_buckets:
                # production servers also warm the fused streaming pitch
                # family (/v1/stream?pitch=1, default band)
                for _row in self.pipe.stream_pitch(
                    iter([np.zeros((n,), np.int16)])
                ):
                    pass


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------

import threading as _threading
import time as _time

_PROBE_LOCK = _threading.Lock()
_PROBE_STATE = {"ts": 0.0, "ok": None, "error": "", "inflight": False}


def _device_health(device, timeout_s: float = 2.0, cache_s: float = 15.0):
    """One bounded round trip to ``device`` for /healthz: a small sum
    there, read back (which synchronizes). Results are cached for
    ``cache_s`` and at most ONE probe is ever in flight: a hung device
    BLOCKS calls rather than failing them, so an unbounded probe — or one
    probe thread per poll — would pile up blocked threads exactly when the
    load balancer polls hardest."""
    now = _time.monotonic()
    with _PROBE_LOCK:
        if _PROBE_STATE["ok"] is not None and now - _PROBE_STATE["ts"] < cache_s:
            return _PROBE_STATE["ok"], _PROBE_STATE["error"]
        if _PROBE_STATE["inflight"]:
            return False, "previous device probe still blocked"
        _PROBE_STATE["inflight"] = True
    result = {"ok": False, "error": ""}

    def run():
        try:
            total = float(torch.ones((8, 8), device=device).sum())
            if total != 64.0:
                raise RuntimeError(f"device probe summed to {total}, not 64")
            result["ok"] = True
        except Exception as e:
            result["error"] = str(e)
        finally:
            with _PROBE_LOCK:
                _PROBE_STATE.update(
                    ts=_time.monotonic(), ok=result["ok"],
                    error=result["error"], inflight=False,
                )

    th = _threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        # leave inflight=True — run()'s finally clears it when (if) the
        # blocked dispatch returns; meanwhile polls get the cheap answer
        err = f"device probe exceeded {timeout_s:.0f}s (device hung?)"
        with _PROBE_LOCK:
            _PROBE_STATE.update(ts=_time.monotonic(), ok=False, error=err)
        return False, err
    return result["ok"], result["error"]

class _Metrics:
    """In-process request metrics behind ``GET /metrics`` (stdlib-only; no
    Prometheus client in the image, so the text exposition is hand-rolled).
    Counters + latency quantiles per route under one lock; quantiles come
    from a fixed ring of the most recent observations, so memory is bounded
    no matter how long the server runs. Routes are normalized to the known
    set before recording — unmatched paths fold into ``"other"`` so a
    client scanning random URLs cannot grow label cardinality unboundedly."""

    RING = 512
    ROUTES = frozenset({
        "/healthz", "/config", "/metrics",
        "/v1/stream", "/v1/features", "/v1/vad", "/v1/pitch",
    })

    def __init__(self) -> None:
        self._lock = _threading.Lock()
        self._started = _time.time()
        self._routes: dict[str, dict] = {}
        self._bytes_in = 0
        self._frames_out = 0
        self._inflight = 0

    def normalize(self, path: str) -> str:
        return path if path in self.ROUTES else "other"

    def enter(self) -> None:
        with self._lock:
            self._inflight += 1

    def observe(
        self, route: str, status: int, dt_s: float,
        bytes_in: int = 0, frames: int = 0,
    ) -> None:
        """Record one finished request (also decrements the in-flight
        gauge ``enter()`` raised)."""
        with self._lock:
            self._inflight -= 1
            r = self._routes.setdefault(route, {
                "requests": 0, "errors": 0, "latency_sum_s": 0.0,
                "latency_max_s": 0.0, "ring": [], "pos": 0,
            })
            r["requests"] += 1
            if status >= 400:
                r["errors"] += 1
            r["latency_sum_s"] += dt_s
            r["latency_max_s"] = max(r["latency_max_s"], dt_s)
            if len(r["ring"]) < self.RING:
                r["ring"].append(dt_s)
            else:
                r["ring"][r["pos"]] = dt_s
                r["pos"] = (r["pos"] + 1) % self.RING
            self._bytes_in += bytes_in
            self._frames_out += frames

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def snapshot(self) -> dict:
        with self._lock:
            routes = {}
            for name, r in self._routes.items():
                lat = sorted(r["ring"])

                def q(p, lat=lat):
                    return round(lat[min(len(lat) - 1, int(p * len(lat)))], 6)

                routes[name] = {
                    "requests": r["requests"],
                    "errors": r["errors"],
                    "latency_avg_s": round(
                        r["latency_sum_s"] / r["requests"], 6
                    ),
                    "latency_p50_s": q(0.50),
                    "latency_p95_s": q(0.95),
                    "latency_max_s": round(r["latency_max_s"], 6),
                }
            return {
                "uptime_s": round(_time.time() - self._started, 1),
                "inflight": self._inflight,
                "bytes_in_total": self._bytes_in,
                "frames_out_total": self._frames_out,
                "routes": routes,
            }

    def prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4) of ``snapshot()``."""
        s = self.snapshot()
        lines = [
            "# TYPE sspv_uptime_seconds gauge",
            f"sspv_uptime_seconds {s['uptime_s']}",
            "# TYPE sspv_inflight_requests gauge",
            f"sspv_inflight_requests {s['inflight']}",
            "# TYPE sspv_bytes_in_total counter",
            f"sspv_bytes_in_total {s['bytes_in_total']}",
            "# TYPE sspv_frames_out_total counter",
            f"sspv_frames_out_total {s['frames_out_total']}",
            "# TYPE sspv_requests_total counter",
        ]
        for name, r in s["routes"].items():
            lines.append(f'sspv_requests_total{{route="{name}"}} {r["requests"]}')
        lines.append("# TYPE sspv_request_errors_total counter")
        for name, r in s["routes"].items():
            lines.append(f'sspv_request_errors_total{{route="{name}"}} {r["errors"]}')
        lines.append("# TYPE sspv_request_latency_seconds summary")
        for name, r in s["routes"].items():
            for label, key in (("0.5", "latency_p50_s"), ("0.95", "latency_p95_s")):
                lines.append(
                    f'sspv_request_latency_seconds{{route="{name}",'
                    f'quantile="{label}"}} {r[key]}'
                )
        return "\n".join(lines) + "\n"


_METRICS = _Metrics()


# Allowed pitch-band edges (Hz). fmin/fmax snap to the nearest grid point:
# they set the lag band, so the grid bounds the number of ACF basis sets
# the pipeline keeps for clients (<= |grid|^2 / 2, in practice only the
# requested ones), as it bounds the JAX server's compiled pitch programs.
_PITCH_GRID_HZ = (
    30, 40, 50, 60, 80, 100, 120, 150, 200, 250, 300, 400, 500, 600, 800,
    1000, 1500, 2000,
)


def _snap_to_grid(hz: float) -> float:
    if not np.isfinite(hz):
        raise ValueError(f"non-finite frequency: {hz}")
    return float(min(_PITCH_GRID_HZ, key=lambda g: abs(g - hz)))


_VAD_KEYS = ("num_frames", "vad", "vad_adaptive")
_FEATURE_KEYS = _VAD_KEYS + ("energy", "zcr", "entropy", "mfcc")
_PITCH_KEYS = _VAD_KEYS + ("f0", "pitch_confidence")
_META_KEYS = ("sample_rate", "num_samples", "frame_size", "hop_size")


def _select(result: dict, keys: tuple) -> dict:
    return {k: result[k] for k in _META_KEYS + keys}


def _jsonify(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj


class _Handler(BaseHTTPRequestHandler):
    # set by make_server()
    service: FeatureService = None  # type: ignore[assignment]
    protocol_version = "HTTP/1.1"
    # socket timeout: an idle client (opened /v1/stream, went silent) must
    # not pin a server thread forever — reads raise timeout and the handler
    # exits instead of leaking one thread per stalled connection
    timeout = 600

    # -- plumbing ---------------------------------------------------------

    def log_message(self, fmt, *args):  # route through stdlib logging
        logger.info("%s %s", self.address_string(), fmt % args)

    def send_response(self, code, message=None):  # capture for /metrics
        self._status = code
        super().send_response(code, message)

    def _timed(self, handler) -> None:
        """Run one request handler with metrics: in-flight gauge, status,
        wall latency, body bytes, and frames emitted."""
        route = _METRICS.normalize(urllib.parse.urlparse(self.path).path)
        self._status = 0
        self._bytes_in = 0
        self._frames_out = 0
        t0 = _time.monotonic()
        _METRICS.enter()
        try:
            handler()
        finally:
            # status 0 = the handler died before any response line (socket
            # error/timeout); count it as a 500-class failure
            _METRICS.observe(
                route, self._status or 500, _time.monotonic() - t0,
                self._bytes_in, self._frames_out,
            )

    def do_GET(self):  # noqa: N802 (stdlib naming)
        self._timed(self._handle_get)

    def do_POST(self):  # noqa: N802
        self._timed(self._handle_post)

    def _reply(self, code: int, payload: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(payload)

    def _reply_json(self, code: int, obj: dict) -> None:
        body = json.dumps(
            {k: _jsonify(v) for k, v in obj.items()}
        ).encode("utf-8")
        self._reply(code, body, "application/json")

    def _reply_error(self, code: int, message: str) -> None:
        # Error paths may leave the request body unread; on an HTTP/1.1
        # keep-alive connection those bytes would be parsed as the next
        # request line (garbage 400s for every later request on the
        # connection, up to _MAX_BODY_BYTES of them on the 413 path), so
        # errors always close the connection instead of draining.
        self.close_connection = True
        self._reply_json(code, {"error": message})

    # -- streaming plumbing -------------------------------------------------

    # Per-yield read bound: a within-limits 512 MB body must arrive as many
    # small pieces, never one giant allocation (downstream framing would
    # multiply one huge chunk into multi-GB index/frame matrices).
    _READ_SLICE = 1 << 20  # 1 MB

    def _read_sliced(self, length: int):
        remaining = int(length)
        while remaining:
            part = self.rfile.read(min(remaining, self._READ_SLICE))
            if not part:
                raise ValueError("truncated body")
            remaining -= len(part)
            self._bytes_in += len(part)
            yield part

    def _iter_request_chunks(self, max_total: int):
        """Yield raw body chunks (each <= _READ_SLICE bytes):
        Transfer-Encoding chunked (RFC 9112 §7.1) or, for simpler clients,
        sliced reads of a Content-Length body."""
        te = (self.headers.get("Transfer-Encoding") or "").lower()
        if "chunked" in te:
            total = 0
            while True:
                line = self.rfile.readline(1026)
                if not line:
                    raise ValueError("truncated chunked body")
                size = int(line.split(b";")[0].strip() or b"0", 16)
                if size < 0:
                    # int(..., 16) accepts "-5"; rfile.read(-5) would read
                    # to EOF, buffering unbounded data PAST max_total
                    raise ValueError("negative chunk size")
                if size == 0:
                    # consume optional trailers up to the final blank line —
                    # bounded, or endless trailer lines pin this thread
                    for _ in range(100):
                        t = self.rfile.readline(1026)
                        if t in (b"\r\n", b"\n", b""):
                            break
                    else:
                        raise ValueError("too many trailer lines")
                    return
                total += size
                if total > max_total:
                    raise ValueError("chunked body too large")
                yield from self._read_sliced(size)
                self.rfile.read(2)  # trailing CRLF
        else:
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                raise ValueError("missing request body")
            if length > max_total:
                raise ValueError("request body too large")
            yield from self._read_sliced(length)

    def _write_response_chunk(self, payload: bytes) -> None:
        self.wfile.write(f"{len(payload):x}\r\n".encode() + payload + b"\r\n")

    def _do_stream(self, query) -> None:
        """POST /v1/stream: raw int16 PCM in (chunked or single body) at the
        model sample rate; NDJSON per frame block out (chunked)."""
        sr_expect = self.service.pipe.cfg.sample_rate
        rate_hint = self.headers.get("X-Sample-Rate") or (
            query["rate"][0] if "rate" in query else str(sr_expect)
        )
        if int(rate_hint) != sr_expect:
            # chunk-wise resampling would need stateful polyphase carry;
            # streaming clients must send model-rate PCM
            self._reply_error(
                400, f"/v1/stream requires {sr_expect} Hz int16 PCM"
            )
            return
        ct = (self.headers.get("Content-Type") or "").split(";")[0].strip().lower()
        if ct not in ("application/octet-stream", "audio/l16", ""):
            # a WAV body would be parsed as raw samples (header bytes become
            # garbage audio and its real rate is never checked) — refuse
            self._reply_error(
                400, f"/v1/stream takes raw int16 PCM, not {ct}; "
                "use /v1/features for container formats",
            )
            return
        # validate what CAN be validated before the 200 goes out: a
        # ValueError raised lazily inside the generator lands after headers
        # are sent and would surface as an in-band error row under HTTP 200
        te = (self.headers.get("Transfer-Encoding") or "").lower()
        if "chunked" not in te:
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                self._reply_error(400, "missing request body")
                return
            if length > _MAX_BODY_BYTES:
                self._reply_error(413, "request body too large")
                return
        want_mfcc = query.get("mfcc", ["0"])[0] not in ("0", "false", "")
        want_pitch = query.get("pitch", ["0"])[0] not in ("0", "false", "")
        try:
            min_conf = float(query.get("min_confidence", ["0.3"])[0])
            if not np.isfinite(min_conf):  # nan gates every frame to f0=0
                raise ValueError  # silently; same 400 as /v1/pitch
        except ValueError:
            self._reply_error(400, "min_confidence must be a finite float")
            return

        # Coalesce tiny client chunks before dispatch: one device call per
        # 10 ms chunk would pay a launch and a read-back for each and let
        # one client crowd the shared device queue. Floor = one
        # smallest-engine-bucket block of samples (~0.33 s at the defaults)
        # — bounded added latency, engine-grade dispatch granularity.
        from .config import parse_buckets

        c = self.service.pipe.cfg
        min_bucket = parse_buckets(
            getattr(Config, "TPU_STREAM_BUCKETS", (32, 256, 2048))
        )[0]
        min_bytes = 2 * ((min_bucket - 1) * c.hop_size + c.frame_size)

        def sample_chunks():
            buf = bytearray()
            first = True
            for raw in self._iter_request_chunks(_MAX_BODY_BYTES):
                if first:
                    first = False
                    if raw[:4] == b"RIFF":
                        raise ValueError(
                            "body looks like a WAV container; /v1/stream "
                            "takes raw int16 PCM"
                        )
                buf += raw
                if len(buf) < min_bytes:
                    continue
                usable = len(buf) - (len(buf) % 2)
                yield np.frombuffer(bytes(buf[:usable]), dtype="<i2")
                del buf[:usable]
            usable = len(buf) - (len(buf) % 2)
            if usable:
                yield np.frombuffer(bytes(buf[:usable]), dtype="<i2")

        # connection becomes ours: chunked response, then close
        self.close_connection = True
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Connection", "close")
        self.end_headers()
        emitted = 0
        try:
            for item in self.service.stream_blocks(
                sample_chunks(), pitch=want_pitch, min_confidence=min_conf
            ):
                if want_pitch:
                    block, f0, conf = item
                else:
                    block = item
                row = {
                    "block": emitted,
                    "frames": int(block.vad.shape[0]),
                    "energy": block.energy.cpu().numpy().tolist(),
                    "zcr": block.zcr.cpu().numpy().tolist(),
                    "entropy": block.entropy.cpu().numpy().tolist(),
                    "vad": block.vad.cpu().numpy().astype(int).tolist(),
                    "vad_adaptive": block.vad_adaptive.cpu().numpy()
                    .astype(int).tolist(),
                }
                if want_mfcc:
                    row["mfcc"] = block.mfcc.cpu().numpy().tolist()
                if want_pitch:
                    row["f0"] = np.asarray(f0).tolist()
                    row["pitch_confidence"] = np.asarray(conf).tolist()
                self._write_response_chunk(
                    json.dumps(row).encode("utf-8") + b"\n"
                )
                self._frames_out += row["frames"]
                emitted += 1
            self._write_response_chunk(
                json.dumps({"done": True, "blocks": emitted}).encode() + b"\n"
            )
        except Exception as e:
            # headers are already sent; best effort is an error line
            logger.exception("stream failed")
            try:
                self._write_response_chunk(
                    json.dumps({"error": str(e)}).encode() + b"\n"
                )
            except Exception:
                pass
        try:
            self.wfile.write(b"0\r\n\r\n")
        except OSError:
            pass  # client dropped mid-stream (routine for Ctrl-C'd pipes)

    # -- GET ---------------------------------------------------------------

    def _handle_get(self):
        parsed = urllib.parse.urlparse(self.path)
        path = parsed.path
        if path == "/metrics":
            fmt = urllib.parse.parse_qs(parsed.query).get("fmt", ["json"])[0]
            if fmt == "prom":
                self._reply(
                    200, _METRICS.prometheus().encode("utf-8"),
                    "text/plain; version=0.0.4",
                )
            else:
                self._reply_json(200, _METRICS.snapshot())
        elif path == "/healthz":
            device = self.service.pipe.device
            try:
                backend = device.type
                n = torch.cuda.device_count() if backend == "cuda" else 1
            except Exception as e:  # device down: report, don't crash
                self._reply_json(503, {"status": "unavailable", "error": str(e)})
                return
            # the device count is the driver's, read without touching the
            # card; the probe must actually run an op there (bounded — a
            # hung device blocks calls rather than failing them)
            ok, err = _device_health(device)
            if not ok:
                self._reply_json(503, {
                    "status": "degraded", "backend": backend,
                    "device_count": n, "error": err,
                })
                return
            self._reply_json(
                200, {"status": "ok", "backend": backend, "device_count": n}
            )
        elif path == "/config":
            cfg = {k: getattr(Config, k) for k in Config._overridable()}
            self._reply_json(200, {k: _jsonify(v) for k, v in cfg.items()})
        else:
            self._reply_error(404, f"unknown path: {path}")

    # -- POST ---------------------------------------------------------------

    def _handle_post(self):
        parsed = urllib.parse.urlparse(self.path)
        query = urllib.parse.parse_qs(parsed.query)

        if parsed.path == "/v1/stream":
            try:
                self._do_stream(query)
            except ValueError as e:
                self._reply_error(400, str(e))
            return

        route = {
            "/v1/features": (_FEATURE_KEYS, False),
            "/v1/vad": (_VAD_KEYS, False),
            "/v1/pitch": (_PITCH_KEYS, True),
        }.get(parsed.path)
        if route is None:
            self._reply_error(404, f"unknown path: {parsed.path}")
            return

        # Validate client-controlled knobs BEFORE reading the body: bad
        # values are a 400, not a 500, and the pitch band snaps to a fixed
        # grid, as in the JAX server — fmin/fmax set the lag-band geometry,
        # and the pipeline keeps one set of ACF bases per band it has
        # seen, so free-form floats would let clients grow that cache.
        try:
            def qfloat(name: str, default: float) -> float:
                return float(query[name][0]) if name in query else default

            fmin = _snap_to_grid(qfloat("fmin", 50.0))
            fmax = _snap_to_grid(qfloat("fmax", 400.0))
            if fmin >= fmax:
                raise ValueError(f"fmin {fmin} must be < fmax {fmax} (after "
                                 f"snapping to the {_PITCH_GRID_HZ} Hz grid)")
            mc = qfloat("min_confidence", 0.3)
            if not np.isfinite(mc):
                # NaN would silently clamp and change the gating
                raise ValueError(f"non-finite min_confidence: {mc}")
            # clamp to the normalized-ACF range [-1, 1], PRESERVING negative
            # values: a negative threshold disables confidence gating (the
            # documented library semantics pitch_track_signal_jit keeps and
            # tests assert) — clamping to 0 would silently zero every frame
            # with confidence in [-1, 0)
            min_confidence = min(1.0, max(-1.0, mc))
            if route[1]:  # pitch route: the band must be feasible for the
                # frame geometry (e.g. fmax=50 Hz needs lag 320 but a
                # 320-sample frame tops out at 319) — reject as a client
                # error instead of failing in the pipeline
                from .ops.pitch import _lag_band

                c = self.service.pipe.cfg
                _lag_band(c.sample_rate, fmin, fmax, c.frame_size)
        except ValueError as e:
            self._reply_error(400, f"bad query parameter: {e}")
            return

        try:
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                self._reply_error(400, "missing request body")
                return
            if length > _MAX_BODY_BYTES:
                self._reply_error(413, "request body too large")
                return
            body = self.rfile.read(length)
            self._bytes_in += len(body)
            rate_hint = self.headers.get("X-Sample-Rate") or (
                query["rate"][0] if "rate" in query else None
            )
            samples, sr = decode_audio(
                body,
                self.headers.get("Content-Type", ""),
                int(rate_hint) if rate_hint else None,
            )
        except AudioDecodeError as e:
            self._reply_error(400, str(e))
            return
        except Exception as e:
            self._reply_error(400, f"bad request: {e}")
            return

        # Cap duration at the largest signal bucket, as the JAX server does
        # (there, longer inputs would compile a program per length): it
        # bounds one request's device memory and time. Batch workloads
        # beyond the cap belong to sspv_tpu_torch.batch / the library API.
        max_s = self.service.pipe.SIGNAL_BUCKET_SECONDS[-1]
        if len(samples) > max_s * sr:
            self._reply_error(
                413,
                f"audio too long: {len(samples) / sr:.0f} s > {max_s} s "
                f"cap; use sspv_tpu_torch.batch for long files",
            )
            return

        keys, want_pitch = route
        try:
            result = self.service.analyze(
                samples, sr,
                want_pitch=want_pitch,
                fmin=fmin,
                fmax=fmax,
                min_confidence=min_confidence,
            )
        except Exception as e:  # analysis failure is a server-side error
            logger.exception("analysis failed")
            self._reply_error(500, f"analysis failed: {e}")
            return
        selected = _select(result, keys)
        self._frames_out += int(result.get("num_frames", 0))
        fmt = query.get("fmt", ["json"])[0]
        if fmt == "npz":
            buf = io.BytesIO()
            np.savez_compressed(buf, **selected)
            self._reply(200, buf.getvalue(), "application/octet-stream")
        else:
            self._reply_json(200, selected)


def make_server(
    host: str = "127.0.0.1",
    port: int = 0,
    service: FeatureService | None = None,
) -> ThreadingHTTPServer:
    """Build (not start) a threaded HTTP server bound to ``host:port``;
    ``port=0`` picks a free port (``server.server_address[1]``)."""
    svc = service or FeatureService()  # on the card
    handler = type("BoundHandler", (_Handler,), {"service": svc})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m sspv_tpu_torch.serve",
        description="HTTP speech feature / VAD / pitch service.")
    parser.add_argument("--device", default="cuda",
                        help="device to serve from: cuda (default) or cpu")
    args = parser.parse_args(argv)
    Config.setup_logging()
    yaml_path = os.environ.get("RTP_CONFIG_YAML")
    if yaml_path:  # same override layers as main/analyze/batch
        Config.load_from_yaml(yaml_path)
    Config.load_from_env()
    Config.setup_logging()  # re-apply a LOG_LEVEL override
    # one process-wide float32 matmul precision for every request thread:
    # ops.fp32.full_fp32 then never writes the setting (it is not safe
    # against threads that overlap it)
    torch.set_float32_matmul_precision("highest")
    host = os.environ.get("RTP_SERVE_HOST", "127.0.0.1")
    port = int(os.environ.get("RTP_SERVE_PORT", "8571"))
    server = make_server(host, port, FeatureService(device=args.device))
    warm = os.environ.get("RTP_SERVE_WARMUP", "1")
    if warm not in ("0", "false", "no"):
        # without it the first requests wait on the kernel build (nvcc,
        # about 10 s: far inside the handler's 600 s socket timeout)
        logger.info("warming up on %s: building the kernels and serving one "
                    "request of each program family", args.device)
        t0 = _time.monotonic()
        server.RequestHandlerClass.service.warmup(all_buckets=(warm == "all"))
        logger.info("warm-up done in %.1f s", _time.monotonic() - t0)
    logger.info("serving on http://%s:%d", *server.server_address[:2])

    # Graceful drain: SIGTERM/SIGINT stop the accept loop, then wait (up to
    # RTP_SERVE_DRAIN_S, default 30 s) for in-flight requests to finish
    # before closing the socket — a rolling deploy must not cut off a
    # half-written NDJSON stream. shutdown() must run off the signal-handler
    # thread (it joins the serve_forever loop, which the handler interrupts).
    import signal

    drain_s = float(os.environ.get("RTP_SERVE_DRAIN_S", "30"))

    def _on_signal(signum, _frame):
        logger.info("signal %d: stopping accept loop, draining", signum)
        _threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        deadline = _time.monotonic() + drain_s
        while _METRICS.inflight > 0 and _time.monotonic() < deadline:
            _time.sleep(0.1)
        left = _METRICS.inflight
        if left:
            logger.warning("drain timeout: %d request(s) still in flight", left)
        server.server_close()


if __name__ == "__main__":
    main()
