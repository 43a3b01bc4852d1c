#!/usr/bin/env python3
"""Application entry point of the port: the copy of ``sspv_tpu/main.py``.

Flow matches the reference ``main.py:18-50``: logging setup → optional YAML
config (``RTP_CONFIG_YAML``) → env overrides (``RTP_`` prefix) → env-driven
source selection (``RTP_INPUT_FILE`` → FileAudioSource, ``RTP_INPUT_DIR`` →
PlaylistAudioSource over sorted supported files) → runtime + UI event loop.

Extra env knobs for display-less operation:
- ``RTP_HEADLESS=1``   force the headless visualizer
- ``RTP_DURATION=<s>`` stop after N seconds (headless)
- ``RTP_SNAPSHOT=<p>`` PNG path for the final plot snapshot (headless)

The engine runs on ``--device`` (the card by default):

    RTP_INPUT_FILE=speech.wav RTP_HEADLESS=1 python -m sspv_tpu_torch.main --device cpu
"""

from __future__ import annotations

import argparse
import logging
import os

from .config import Config

logger = logging.getLogger(__name__)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m sspv_tpu_torch.main",
        description="Real-time speech processing with a live or headless UI.")
    parser.add_argument("--device", default="cuda",
                        help="device to run the engine on: cuda (default) or cpu")
    args = parser.parse_args(argv)
    Config.setup_logging()
    yaml_path = os.environ.get("RTP_CONFIG_YAML")
    if yaml_path:
        Config.load_from_yaml(yaml_path)
    Config.load_from_env(prefix="RTP_")
    # re-apply so a LOG_LEVEL override from YAML/env takes effect
    Config.setup_logging()

    from .runtime.audio_source import FileAudioSource, PlaylistAudioSource
    from .runtime.engine import AudioRuntime
    from .ui import VisualizationUI, collect_audio_files

    audio_source = None
    input_file = os.environ.get("RTP_INPUT_FILE")
    input_dir = os.environ.get("RTP_INPUT_DIR")
    if input_file:
        audio_source = FileAudioSource(input_file, sample_rate=Config.SAMPLE_RATE)
    elif input_dir:
        files = collect_audio_files(input_dir)
        if files:
            audio_source = PlaylistAudioSource(files, sample_rate=Config.SAMPLE_RATE)
        else:
            # a typo'd/empty RTP_INPUT_DIR must not silently open the mic
            logger.warning(
                "RTP_INPUT_DIR=%s has no supported audio files; "
                "falling back to the microphone", input_dir,
            )
    elif os.environ.get("RTP_INTERACTIVE", "").lower() in {"1", "true", "yes"}:
        audio_source = interactive_choose_audio_source()

    runtime = AudioRuntime(audio_source=audio_source, device=args.device)
    if audio_source is not None:
        runtime.auto_stop_on_eof = True

    headless = os.environ.get("RTP_HEADLESS", "").lower() in {"1", "true", "yes"}
    kwargs = {}
    if headless:
        kwargs["headless"] = True
    duration = os.environ.get("RTP_DURATION")
    if duration:
        try:
            kwargs["duration"] = float(duration)
            kwargs.setdefault("headless", True)
        except ValueError:
            logger.warning("RTP_DURATION=%s is not a number; ignoring", duration)
    snapshot = os.environ.get("RTP_SNAPSHOT")
    if snapshot:
        kwargs.setdefault("headless", True)
        kwargs["snapshot_path"] = snapshot

    ui = VisualizationUI(runtime, **kwargs)
    ui.run()


def interactive_choose_audio_source():
    """Console source chooser (opt-in via RTP_INTERACTIVE=1): pick a path or
    auto-scan the default audio directory, then test all files or one.
    Returns an AudioSource or None (microphone)."""
    from .runtime.audio_source import FileAudioSource, PlaylistAudioSource
    from .ui import collect_audio_files, default_audio_dir

    def pick_from(files):
        if not files:
            return None
        print(f"found {len(files)} audio file(s).")
        print("1) test all  2) test one")
        if (input("choose 1/2 [1]: ").strip() or "1") == "2":
            for i, f in enumerate(files, 1):
                print(f"{i}. {os.path.basename(f)}")
            try:
                idx = int(input("file number [1]: ") or "1")
            except ValueError:
                idx = 1
            files = [files[max(1, min(idx, len(files))) - 1]]
        return PlaylistAudioSource(files, sample_rate=Config.SAMPLE_RATE)

    try:
        default_dir = default_audio_dir()
        print("\naudio source:")
        print(f"1) auto-scan default directory: {default_dir}")
        print("2) custom path (file or directory)")
        choice = input("choose 1/2 [1]: ").strip() or "1"
        if choice == "2":
            path = input("file or directory path: ").strip().strip('"')
            if os.path.isfile(path):
                return FileAudioSource(path, sample_rate=Config.SAMPLE_RATE)
            if os.path.isdir(path):
                src = pick_from(collect_audio_files(path))
                if src is not None:
                    return src
            print("path invalid or empty; falling back to the default dir.")
        src = pick_from(collect_audio_files(default_dir))
        if src is None:
            print("no audio files found; using the microphone.")
        return src
    except Exception as e:
        print(f"source selection failed ({e}); using the microphone.")
        return None


if __name__ == "__main__":
    main()
