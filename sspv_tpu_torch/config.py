#!/usr/bin/env python3
"""System configuration of the port: a copy of ``sspv_tpu/config.py``.

The port cannot import the JAX package's ``Config`` (importing anything
under ``sspv_tpu`` imports jax), so it keeps this copy with the same
attribute names, defaults and override layers (``RTP_``-prefixed
environment variables, optional YAML) and ``parse_buckets``;
``tests/test_torch_engine.py`` holds the two equal. It is a separate class:
overriding one leaves the other alone.

The ``TPU_*`` knobs keep their names so one configuration file serves both
packages. What each means in the port is noted beside it.
"""

from __future__ import annotations

import logging
import os

# paInt16 == 8 in PyAudio; fall back to the numeric constant when PyAudio is
# not installed (reference: config.py:18-22).
try:  # pragma: no cover - depends on environment
    import pyaudio as _pyaudio  # type: ignore

    _AUDIO_FORMAT_DEFAULT = _pyaudio.paInt16
except Exception:  # pragma: no cover
    _AUDIO_FORMAT_DEFAULT = 8


class Config:
    """Static configuration for the speech signal-processing system.

    Mirrors the reference ``Config`` (config.py:24-136) attribute-for-attribute.
    """

    # --- audio capture -----------------------------------------------------
    AUDIO_FORMAT = _AUDIO_FORMAT_DEFAULT  # pyaudio.paInt16
    CHANNELS = 1
    SAMPLE_RATE = 16000  # Hz, standard speech sample rate
    CHUNK_SIZE = 1024  # samples per device read
    FRAME_DURATION = 20  # ms
    FRAME_SIZE = int(SAMPLE_RATE * FRAME_DURATION / 1000)  # 320 samples
    HOP_SIZE = FRAME_SIZE // 2  # 160 samples, 50% overlap

    # --- signal processing -------------------------------------------------
    WINDOW_TYPE = "hamming"  # "hamming" | "hanning" | "rectangular"
    PREEMPHASIS_ALPHA = 0.97

    # --- frequency-domain features ----------------------------------------
    NUM_MFCC = 13
    MFCC_N_FFT = 512
    MEL_FILTERS = 26
    MFCC_LIFTER = 22
    SPECTRAL_ENTROPY_N_FFT = 512

    # --- voice-activity detection ------------------------------------------
    ENERGY_THRESHOLD = 1000  # fixed-threshold VAD energy gate
    ZCR_THRESHOLD = 0.3  # voiced frames have LOW zcr (config.py:106)

    # adaptive-VAD legacy/compat parameters (config.py:109-111)
    ADAPTIVE_VAD_HISTORY_MIN = 20
    ADAPTIVE_VAD_ENERGY_K = 3.0
    ADAPTIVE_VAD_ZCR_K = 1.0
    # composite VAD gating and smoothing (config.py:113-116)
    USE_ADAPTIVE_VAD = True
    SPECTRAL_ENTROPY_VOICE_MAX = 0.65  # entropy below this suggests voice
    VAD_HANGOVER_ON = 3  # frames to hold after voice onset
    VAD_RELEASE_OFF = 2  # consecutive silent frames needed to release

    # --- visualization ------------------------------------------------------
    PLOT_UPDATE_INTERVAL = 50  # ms
    MAX_DISPLAY_FRAMES = 100
    WAVEFORM_DISPLAY_LENGTH = 4096

    # --- buffering ----------------------------------------------------------
    # AUDIO_BUFFER_SIZE exists for name parity with the reference
    # (config.py:124), where it sizes a LOSSY 4-chunk capture deque that
    # silently drops audio whenever the consumer falls behind
    # (rtvp/engine.py:90). This rebuild deliberately diverges: the engine
    # bounds the capture backlog with LOSSLESS blocking backpressure sized in
    # seconds (``TPU_MAX_PENDING_SECONDS`` below), so no samples are ever
    # dropped on file/playlist input. Consequently this knob — and its
    # ``RTP_AUDIO_BUFFER_SIZE`` env override — is accepted but INERT.
    # Rationale and measurement: docs/architecture.md ("Backpressure").
    AUDIO_BUFFER_SIZE = 4  # chunks (inert; see note above)
    PROCESSED_DATA_BUFFER_SIZE = 100  # frames

    # --- threading ----------------------------------------------------------
    THREAD_SLEEP_TIME = 0.001  # s

    # --- persistence --------------------------------------------------------
    SAVE_DIRECTORY = "."

    # --- logging ------------------------------------------------------------
    LOG_LEVEL = "INFO"
    LOG_FORMAT = "[%(asctime)s] %(levelname)s %(name)s: %(message)s"
    LOG_DATEFMT = "%H:%M:%S"

    # ------------------------------------------------------------------
    # Additions beyond the reference surface (names shared with sspv_tpu)
    # ------------------------------------------------------------------
    # History window of the adaptive-VAD trailing mean (reference
    # engine.py:96-97 uses deque(maxlen=256)).
    VAD_HISTORY_LEN = 256
    # Opt-in, NOT reference behavior: multiplies the adaptive energy
    # threshold (1.0 = reference semantics).
    VAD_ADAPTIVE_ENERGY_MARGIN = 1.0
    # Opt-in, NOT reference behavior: "or" (reference) or "and" composite.
    VAD_COMPOSITE_MODE = "or"
    # Frame-block bucket sizes of the streaming engine and
    # FeaturePipeline.stream: blocks pad to one of these under a mask.
    TPU_STREAM_BUCKETS = (32, 256, 2048)
    # Capture backlog (seconds of audio) before the engine's producer
    # blocks: lossless backpressure instead of the reference's lossy deque.
    TPU_MAX_PENDING_SECONDS = 30.0
    # Minimum seconds between the engine's device dispatches (0 = as fast
    # as frames arrive); larger values coalesce frames into fewer calls.
    TPU_MIN_DISPATCH_INTERVAL = 0.0
    # Kept for a like-for-like FeatureConfig; the port's kernels always run
    # on CUDA tensors and are fp32, so these choose nothing in the port.
    TPU_USE_PALLAS = True
    TPU_MATMUL_PRECISION = "high"
    TPU_DFT_LAYOUT = "merged"
    TPU_VIEW_LAYOUT = "hop_phase"
    TPU_VIEW_KERNEL = 1
    TPU_VIEW_BLOCK_FRAMES = 1024
    TPU_VIEW_ORIENT = "auto"
    # Adaptive-VAD trailing sums: "blocked" (two-level cumsums; direct
    # window sums when the length is not a multiple of VAD_HISTORY_LEN) or
    # "conv" (direct window sums).
    TPU_VAD_TRAILING_IMPL = "blocked"
    # Engine dispatch layout: 1 = ship raw int16 samples and frame on the
    # device through the view path (kernel K1); 0 = host-framed float32
    # frames through the frames path (kernel K3), which also serves every
    # geometry the view kernels do not take.
    TPU_STREAM_SAMPLES_DISPATCH = 1
    # Low-latency streaming: publish each block as soon as it is dispatched
    # (no block in flight) and add an 8-frame bucket.
    TPU_LOW_LATENCY = False
    # Opt-in real-time pitch in the engine: the packed programs append a
    # VAD-gated F0 track (AudioRuntime.get_recent_pitch); the frame dicts
    # and the save_data schema are unchanged.
    TPU_ENGINE_PITCH = False
    # Confidence gate of the engine's pitch track.
    TPU_ENGINE_PITCH_MIN_CONF = 0.3
    # On-device resampling of whole files (ops/resample.py): with this set,
    # a resample of at least TPU_DEVICE_RESAMPLE_MIN_SECONDS of audio runs
    # on the card, shorter arrays on the host through SciPy. A failure of
    # the device call raises; nothing falls back to the host.
    TPU_DEVICE_RESAMPLE = False
    TPU_DEVICE_RESAMPLE_MIN_SECONDS = 1.0

    @staticmethod
    def setup_logging() -> None:
        """Initialise stdlib logging (reference: config.py:138-148).

        Safe to call again after ``load_from_env``/``load_from_yaml``:
        ``basicConfig`` no-ops once a handler exists, so the explicit
        ``setLevel`` below is what lets a late ``LOG_LEVEL`` override (e.g.
        ``RTP_LOG_LEVEL=DEBUG``) actually take effect — the CLIs call this
        once before loading overrides and once after."""
        level = getattr(logging, str(Config.LOG_LEVEL).upper(), logging.INFO)
        logging.basicConfig(
            level=level, format=Config.LOG_FORMAT, datefmt=Config.LOG_DATEFMT
        )
        logging.getLogger().setLevel(level)

    @staticmethod
    def print_config() -> None:
        """Log the full configuration (reference: config.py:150-185).

        The reference's dump stops after the adaptive-VAD line; this one
        continues through the composite-VAD gating, visualization, buffering,
        threading, persistence, and logging sections — a strict superset, so
        every reference-printed field appears with the same formatting.
        """
        logging.info("%s", "=" * 50)
        logging.info("Real-time speech signal processing (PyTorch port) - configuration")
        logging.info("%s", "=" * 50)
        logging.info("audio format: %s (paInt16)", Config.AUDIO_FORMAT)
        logging.info("channels: %d", Config.CHANNELS)
        logging.info("sample rate: %d Hz", Config.SAMPLE_RATE)
        logging.info("chunk size: %d", Config.CHUNK_SIZE)
        logging.info(
            "frame: %d samples (%dms), hop: %d samples",
            Config.FRAME_SIZE,
            Config.FRAME_DURATION,
            Config.HOP_SIZE,
        )
        logging.info("window: %s", Config.WINDOW_TYPE)
        logging.info("pre-emphasis alpha: %.2f", Config.PREEMPHASIS_ALPHA)
        logging.info(
            "MFCC: num=%d, n_fft=%d, mel_filters=%d, lifter=%d",
            Config.NUM_MFCC,
            Config.MFCC_N_FFT,
            Config.MEL_FILTERS,
            Config.MFCC_LIFTER,
        )
        logging.info("spectral entropy n_fft: %d", Config.SPECTRAL_ENTROPY_N_FFT)
        logging.info("energy threshold: %.2f", Config.ENERGY_THRESHOLD)
        logging.info("zcr threshold: %.3f", Config.ZCR_THRESHOLD)
        logging.info(
            "adaptive VAD: history_min=%d, energy_k=%.2f, zcr_k=%.2f",
            Config.ADAPTIVE_VAD_HISTORY_MIN,
            Config.ADAPTIVE_VAD_ENERGY_K,
            Config.ADAPTIVE_VAD_ZCR_K,
        )
        logging.info(
            "composite VAD: use_adaptive=%s, entropy_voice_max=%.2f, "
            "hangover_on=%d, release_off=%d",
            Config.USE_ADAPTIVE_VAD,
            Config.SPECTRAL_ENTROPY_VOICE_MAX,
            Config.VAD_HANGOVER_ON,
            Config.VAD_RELEASE_OFF,
        )
        logging.info(
            "visualization: update=%dms, max_display_frames=%d, waveform_len=%d",
            Config.PLOT_UPDATE_INTERVAL,
            Config.MAX_DISPLAY_FRAMES,
            Config.WAVEFORM_DISPLAY_LENGTH,
        )
        logging.info(
            "buffering: audio_buffer=%d chunks (inert; lossless backpressure "
            "%.1fs), processed_buffer=%d frames",
            Config.AUDIO_BUFFER_SIZE,
            Config.TPU_MAX_PENDING_SECONDS,
            Config.PROCESSED_DATA_BUFFER_SIZE,
        )
        logging.info("thread sleep: %.4fs", Config.THREAD_SLEEP_TIME)
        logging.info("save directory: %s", Config.SAVE_DIRECTORY)
        logging.info("log level: %s", Config.LOG_LEVEL)
        logging.info(
            "tpu: precision=%s, dft_layout=%s, view_layout=%s, "
            "view_kernel=%d, view_orient=%s, vad_impl=%s, "
            "samples_dispatch=%d, engine_pitch=%d, device_resample=%d",
            Config.TPU_MATMUL_PRECISION,
            Config.TPU_DFT_LAYOUT,
            Config.TPU_VIEW_LAYOUT,
            Config.TPU_VIEW_KERNEL,
            Config.TPU_VIEW_ORIENT,
            Config.TPU_VAD_TRAILING_IMPL,
            Config.TPU_STREAM_SAMPLES_DISPATCH,
            Config.TPU_ENGINE_PITCH,
            Config.TPU_DEVICE_RESAMPLE,
        )

    # Names of the data attributes eligible for env/YAML override: every
    # ALL-CAPS class attribute. Computed fresh each call so attributes added
    # at runtime (tests monkeypatching Config) participate too.
    @staticmethod
    def _overridable() -> list[str]:
        return [k for k in vars(Config) if k.isupper()]

    @staticmethod
    def _coerce(raw: str, template: object) -> object:
        """Parse ``raw`` to the type of ``template`` (the attribute's current
        value). Bools accept 1/true/yes/on vs 0/false/no/off; tuples/lists
        parse comma- or space-separated elements against the first element's
        type (e.g. ``RTP_TPU_STREAM_BUCKETS="64,512"``); strings pass through
        unchanged; raises on anything unparseable so callers keep the
        default."""
        if isinstance(template, bool):
            s = raw.strip().lower()
            if s in {"1", "true", "yes", "on"}:
                return True
            if s in {"0", "false", "no", "off"}:
                return False
            # A typo ("treu") must not silently flip the flag to False.
            raise ValueError(raw)
        if isinstance(template, int):
            return int(raw)
        if isinstance(template, float):
            return float(raw)
        if isinstance(template, (tuple, list)):
            elem = template[0] if len(template) else ""
            parts = [p for p in raw.replace(",", " ").split() if p]
            if not parts:
                raise ValueError(raw)
            vals = [Config._coerce(p, elem) for p in parts]
            return tuple(vals) if isinstance(template, tuple) else vals
        return raw

    @staticmethod
    def _coerce_any(val: object, template: object) -> object:
        """Coerce an already-typed value (YAML mapping entry) to the
        template's type; raises on anything unparseable so the caller can
        warn and keep the default. Coercing once here is what lets every
        Config consumer (engine, pipeline.stream, UI) read knobs without
        its own defensive parser."""
        if isinstance(template, bool):
            if isinstance(val, bool):
                return val
            return Config._coerce(str(val).strip(), template)
        if isinstance(template, int):
            if isinstance(val, bool):
                raise ValueError(val)
            return int(str(val).strip()) if isinstance(val, str) else int(val)
        if isinstance(template, float):
            if isinstance(val, bool):
                raise ValueError(val)
            return float(str(val).strip()) if isinstance(val, str) else float(val)
        if isinstance(template, (tuple, list)):
            if isinstance(val, str):
                return Config._coerce(val, template)
            elem = template[0] if len(template) else ""
            vals = [Config._coerce_any(v, elem) for v in val]
            return tuple(vals) if isinstance(template, tuple) else vals
        if isinstance(template, str):
            return str(val)
        return val

    @staticmethod
    def load_from_env(prefix: str = "RTP_") -> None:
        """Override attributes from ``<prefix><NAME>`` environment variables
        (e.g. ``RTP_SAMPLE_RATE``), type-cast against each attribute's current
        value; a failed cast logs and keeps the default (reference behavior,
        config.py:187-216).

        Iterates the *attribute* surface rather than the environment, so only
        ALL-CAPS data attributes are overridable — an env var aimed at a
        method name (e.g. ``RTP_print_config``) can never clobber it (a
        latent hazard of the reference's environ-driven loop).
        """
        for key in Config._overridable():
            raw = os.environ.get(prefix + key)
            if raw is None:
                continue
            try:
                setattr(Config, key, Config._coerce(raw, getattr(Config, key)))
            except (ValueError, TypeError):
                logging.warning(
                    "env var %s%s=%s failed to cast; keeping default",
                    prefix, key, raw,
                )

    @staticmethod
    def load_from_yaml(path: str) -> bool:
        """Override attributes from a YAML mapping file; unknown keys are
        ignored. Returns True only when a mapping was loaded and applied
        (reference: config.py:218-252). Needs ``pyyaml``."""
        try:
            import yaml  # type: ignore
        except Exception:  # pragma: no cover
            logging.warning("pyyaml not installed; skipping YAML config: %s", path)
            return False

        try:
            with open(path, "r", encoding="utf-8") as f:
                data = yaml.safe_load(f)
        except Exception as e:
            logging.error("failed to load YAML config: %s (%s)", path, e)
            return False
        if data is None:
            data = {}
        if not isinstance(data, dict):
            logging.warning("YAML config must be a mapping; ignoring: %s", path)
            return False
        known = set(Config._overridable())
        for key in known.intersection(data):
            # coerce against the attribute's current type (same contract as
            # load_from_env): a raw `TPU_MIN_DISPATCH_INTERVAL: 50ms` string
            # must warn and keep the default here, not kill a consumer
            # thread later
            try:
                setattr(
                    Config, key, Config._coerce_any(data[key], getattr(Config, key))
                )
            except (ValueError, TypeError):
                logging.warning(
                    "YAML key %s=%r failed to cast; keeping default",
                    key, data[key],
                )
        logging.info("loaded config from YAML: %s", path)
        return True


def parse_buckets(value) -> tuple[int, ...]:
    """Normalize ``TPU_STREAM_BUCKETS`` from a tuple/list or a string like
    ``"64,512"`` (a YAML/env value that bypassed coercion, or a direct test
    monkeypatch); falls back to the default set on garbage. The ONE
    implementation shared by the streaming engine and ``FeaturePipeline
    .stream`` — two parsers of the same knob had already drifted once."""
    default = (32, 256, 2048)
    try:
        if isinstance(value, str):
            value = [p for p in value.replace(",", " ").split() if p]
        buckets = tuple(sorted(int(v) for v in value))
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(value)
        return buckets
    except Exception:
        logging.warning("invalid TPU_STREAM_BUCKETS %r; using %r", value, default)
        return default


if __name__ == "__main__":
    Config.setup_logging()
    Config.print_config()
