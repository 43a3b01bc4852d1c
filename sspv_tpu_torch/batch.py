#!/usr/bin/env python3
"""Batch corpus processor: many audio files through the batched pipeline.

The port's copy of ``sspv_tpu/batch.py``: walk files/directories, decode on
host threads, group files into device batches, and run each batch through
the batch program of ``parallel.BatchPipeline`` (``_exact_batch``) — a
(B, L) batch with B split over the mesh's "data" axis, every file carrying
its own VAD state. The JAX package pads each batch to a
``FeaturePipeline.SIGNAL_BUCKET_SECONDS`` bucket and to the full batch size
to bound its compiles; here files group by that bucket (which still sets the
order of the VAD's window sums), sorted by length so that rows of similar
length share a batch, a batch pads only to its longest row, and only each
file's own frames reach the kernels: one K3 launch per batch and device.

On one card the same code runs with a 1-device mesh (the batch still
amortizes launches across files); with several cards the "data" axis fans
the rows out with no communication between them.

Usage:
    python -m sspv_tpu_torch.batch INPUT... [--out-dir DIR] [--batch 8]
        [--pitch] [--jsonl SUMMARY.jsonl] [--resume] [--no-npz]
        [--device cuda]

Prints one JSON summary line per file (same fields as
``sspv_tpu_torch.analyze``) plus a final aggregate line on stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .config import Config
from .utils.export import export_features_npz, summarize_features

__all__ = ["collect_inputs", "process_corpus", "main"]

_FIELDS = ("energy", "zcr", "entropy", "mfcc", "vad", "vad_adaptive")


def collect_inputs(paths: list[str]) -> list[str]:
    """Expand files/directories into a sorted list of supported audio files."""
    from .runtime.audio_source import SUPPORTED_EXTENSIONS

    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                for name in sorted(names):
                    if os.path.splitext(name)[1].lower() in SUPPORTED_EXTENSIONS:
                        out.append(os.path.join(root, name))
        elif os.path.isfile(p):
            out.append(p)
        else:
            raise FileNotFoundError(p)
    return sorted(dict.fromkeys(out))


def _decode(path: str) -> np.ndarray:
    """Decode one file to int16 samples at the model rate (same ladder as
    the streaming engine's FileAudioSource)."""
    from .runtime.audio_source import FileAudioSource

    src = FileAudioSource(path, sample_rate=Config.SAMPLE_RATE)
    src.open()
    pcm = src.read(1 << 62)
    src.close()
    return np.asarray(pcm, dtype=np.int16)


def _bucket_len(num_samples: int, buckets_seconds,
                sample_rate: int) -> int | None:
    """The samples of the smallest bucket that holds a file, None past
    the largest."""
    for s in buckets_seconds:
        if num_samples <= s * sample_rate:
            return s * sample_rate
    return None  # beyond the largest bucket


def _unique_npz_path(out_dir: str, path: str, used: set) -> str:
    """Collision-proof output name: a recursive corpus walk can hold several
    same-named files (sess1/take.wav, sess2/take.wav); basename-only output
    would silently overwrite. Deterministic given input order."""
    base = os.path.splitext(os.path.basename(path))[0]
    name, k = base, 1
    while name in used:
        k += 1
        name = f"{base}_{k}"
    used.add(name)
    return os.path.join(out_dir, name + ".npz")


def _load_manifest(
    manifest: str, out_dir: str | None, want_pitch: bool
) -> dict[str, dict]:
    """Read a summary-JSONL checkpoint; return ``{file_path: summary}`` for
    entries that can be SKIPPED on resume. An entry is skippable only if it
    completed (no ``error`` — errored files get another chance), its npz is
    still on disk when one was promised, and it already carries pitch when
    this run wants pitch. A torn final line (crash mid-write) is ignored."""
    done: dict[str, dict] = {}
    if not os.path.exists(manifest):
        return done
    with open(manifest, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                s = json.loads(line)
            except ValueError:
                continue  # torn tail line from an interrupted run
            path = s.get("file")
            if not isinstance(path, str) or "error" in s:
                continue
            if out_dir:
                npz = s.get("npz")
                if not npz or not os.path.exists(npz):
                    continue  # features were promised but are gone
            if want_pitch and "median_f0_hz" not in s:
                continue  # this run needs pitch; the entry has none
            done[path] = s
    return done


def _host_block(block) -> dict:
    """The block's fields as host arrays (one device->host copy each)."""
    out = {k: getattr(block, k).cpu().numpy() for k in _FIELDS}
    for k in ("vad", "vad_adaptive"):
        out[k] = out[k].astype(np.int32)
    return out


def process_corpus(
    files: list[str],
    out_dir: str | None = None,
    batch_size: int = 8,
    want_pitch: bool = False,
    decode_workers: int = 4,
    mesh=None,
    files_per_pass: int = 256,
    manifest: str | None = None,
    resume: bool = False,
    device="cuda",
    seconds: dict | None = None,
) -> list[dict]:
    """Process ``files``; returns one summary dict per file (input order).

    Files are decoded in windows of ``files_per_pass`` (bounded host
    memory: one window of PCM plus one batch of features in flight),
    grouped by signal bucket within each window and sorted by length
    there, stacked into (B, L) batches of at most ``batch_size`` files (L
    the longest file's length, B rounded up to a mesh-divisible size with
    zero-length rows), and each batch is one batched device call over the
    files' own frames. Feature npz files are written as each file
    completes, named in the window's bucket order as the JAX package names
    them. Oversized files (beyond the largest bucket) run individually
    through ``process_signal(_pitch)_auto``.

    ``mesh`` defaults to ``parallel.make_mesh(device=device)``: every card,
    or with ``device="cpu"`` one CPU device. ``seconds``, when given, is
    filled with the host-clock seconds spent in ``decode``, ``device``
    (the device calls and their results' copies to the host) and ``write``
    (summaries and npz files).

    ``manifest`` names a JSONL checkpoint: every summary is appended and
    flushed the moment its file completes, so an interrupted multi-hour
    corpus run loses at most the in-flight batch. With ``resume=True`` the
    manifest is read first and completed files are skipped (their summaries
    returned from the checkpoint, marked ``"resumed": True``); errored
    entries, entries whose npz vanished, and entries missing a
    now-requested pitch track are reprocessed.
    """
    from .ops.pipeline import FeatureConfig, FeaturePipeline
    from .parallel import BatchPipeline, make_mesh

    if resume and not manifest:
        raise ValueError("resume=True requires a manifest path")

    mesh = mesh or make_mesh(device=device)
    bp = BatchPipeline(mesh, FeatureConfig.from_config(Config))
    pipe: FeaturePipeline = bp.pipe
    c = pipe.cfg
    dp = mesh.devices.shape[0]
    buckets = pipe.SIGNAL_BUCKET_SECONDS
    spent = {"decode": 0.0, "device": 0.0, "write": 0.0}

    used_names: set = set()

    done = _load_manifest(manifest, out_dir, want_pitch) if (
        manifest and resume
    ) else {}
    # reserve npz basenames already claimed by resumed entries so fresh
    # files in this run can never overwrite a checkpointed export
    for s in done.values():
        if "npz" in s:
            used_names.add(os.path.splitext(os.path.basename(s["npz"]))[0])

    sink = open(manifest, "a", encoding="utf-8") if manifest else None

    def record(summary: dict) -> None:
        if sink:
            sink.write(json.dumps(summary) + "\n")
            sink.flush()  # checkpoint granularity = one file

    npz_paths: dict[int, str] = {}

    def finish(i: int, path: str, pcm_len: int, sl: dict) -> None:
        """Summarize + write npz immediately so feature arrays free per file."""
        t0 = time.perf_counter()
        summary = summarize_features(path, pcm_len, sl, c.sample_rate)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            npz_path = npz_paths.pop(i)
            export_features_npz(
                npz_path, sl, c.sample_rate, c.frame_size, c.hop_size
            )
            summary["npz"] = npz_path
        summaries[i] = summary
        record(summary)
        spent["write"] += time.perf_counter() - t0

    def _decode_safe(path: str):
        """One undecodable file must not abort a 10k-file corpus run."""
        try:
            return _decode(path)
        except Exception as e:
            return e

    summaries: list = [None] * len(files)
    todo: list[int] = []
    for i, path in enumerate(files):
        prev = done.get(path)
        if prev is not None:
            summaries[i] = dict(prev, resumed=True)
        else:
            todo.append(i)

    try:
        for wlo in range(0, len(todo), files_per_pass):
            window = todo[wlo : wlo + files_per_pass]
            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=decode_workers) as pool:
                signals = dict(zip(window, pool.map(
                    _decode_safe, (files[i] for i in window)
                )))
            spent["decode"] += time.perf_counter() - t0

            # group this window's file indices by bucket length;
            # undecodable files become error summaries instead of aborting
            groups: dict[int | None, list[int]] = {}
            for i in window:
                if isinstance(signals[i], Exception):
                    summaries[i] = {"file": files[i], "error": str(signals[i])}
                    record(summaries[i])
                    continue
                groups.setdefault(
                    _bucket_len(len(signals[i]), buckets, c.sample_rate), []
                ).append(i)

            if out_dir:  # names claimed in the bucket order of the window
                for idxs in groups.values():
                    for i in idxs:
                        npz_paths[i] = _unique_npz_path(out_dir, files[i],
                                                        used_names)
            for target, idxs in groups.items():
                if target is None:  # huge files: one call each
                    for i in idxs:
                        sig = signals[i]  # int16: half the bytes, cast on device
                        t0 = time.perf_counter()
                        if want_pitch:
                            # one upload for features and pitch
                            block, _, f0, conf = pipe.process_signal_pitch_auto(sig)
                        else:
                            block, _ = pipe.process_signal_auto(sig)
                        sl = _host_block(block)
                        if want_pitch:
                            sl["f0"], sl["pitch_confidence"] = f0, conf
                        spent["device"] += time.perf_counter() - t0
                        finish(i, files[i], len(sig), sl)
                    continue
                # the frames of the JAX package's (B, bucket) batch: the
                # order of the VAD's window sums
                route = 1 + (target - c.frame_size) // c.hop_size
                idxs = sorted(idxs, key=lambda i: len(signals[i]))
                for lo in range(0, len(idxs), batch_size):
                    chunk = idxs[lo : lo + batch_size]
                    # rows for the chunk's files, rounded up to a multiple
                    # of the mesh's data axis with zero-length rows
                    b_pad = -(-len(chunk) // dp) * dp
                    width = max(len(signals[i]) for i in chunk)
                    batch = np.zeros((b_pad, width), np.int16)
                    lengths = np.zeros((b_pad,), np.int32)
                    for row, i in enumerate(chunk):
                        sig = signals[i]
                        batch[row, : len(sig)] = sig
                        lengths[row] = len(sig)
                    t0 = time.perf_counter()
                    # features + VAD (+ VAD-gated pitch) of the batch in one
                    # call, one upload of the (B, L) batch
                    block, f0_b, conf_b = bp._exact_batch(
                        batch, lengths, route,
                        (50.0, 400.0) if want_pitch else None)
                    if want_pitch:
                        f0_b, conf_b = f0_b.cpu().numpy(), conf_b.cpu().numpy()
                    host = _host_block(block)
                    spent["device"] += time.perf_counter() - t0
                    n_max = int(host["vad"].shape[1])
                    row_n = np.where(
                        lengths >= c.frame_size,
                        1 + (lengths - c.frame_size) // c.hop_size,
                        0,
                    ).astype(np.int32)
                    for row, i in enumerate(chunk):
                        n = min(int(row_n[row]), n_max)
                        sl = {k: v[row][:n] for k, v in host.items()}
                        if want_pitch:
                            sl["f0"] = f0_b[row][:n]
                            sl["pitch_confidence"] = conf_b[row][:n]
                        finish(i, files[i], int(lengths[row]), sl)
            signals.clear()

    finally:
        if sink:
            sink.close()
        if seconds is not None:
            seconds.update(spent)

    if any(s is None for s in summaries):
        raise RuntimeError("process_corpus left files without a summary")
    return summaries


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("inputs", nargs="+", help="audio files or directories")
    parser.add_argument("--out-dir", help="write per-file feature npz here")
    parser.add_argument("--jsonl", help="append summaries to this JSONL as "
                        "each file completes (crash-safe checkpoint)")
    parser.add_argument("--resume", action="store_true",
                        help="skip files already completed in --jsonl "
                        "(errored entries and entries whose npz vanished "
                        "are retried)")
    parser.add_argument("--batch", type=int, default=8,
                        help="max files per device batch")
    parser.add_argument("--pitch", action="store_true",
                        help="also compute the VAD-gated F0 track")
    parser.add_argument("--no-npz", action="store_true",
                        help="summaries only, no feature export")
    parser.add_argument("--device", default="cuda",
                        help="device to run on: cuda (default, every card) "
                        "or cpu")
    args = parser.parse_args(argv)

    Config.setup_logging()
    yaml_path = os.environ.get("RTP_CONFIG_YAML")
    if yaml_path:  # same override layers as the analyze CLI
        Config.load_from_yaml(yaml_path)
    Config.load_from_env()
    Config.setup_logging()  # re-apply a LOG_LEVEL override
    files = collect_inputs(args.inputs)
    if not files:
        print(json.dumps({"error": "no supported audio files found"}))
        return 1
    if args.resume and not args.jsonl:
        parser.error("--resume requires --jsonl")
    t0 = time.time()
    out_dir = None if args.no_npz else (args.out_dir or ".")
    seconds: dict = {}
    summaries = process_corpus(
        files, out_dir=out_dir, batch_size=args.batch, want_pitch=args.pitch,
        manifest=args.jsonl, resume=args.resume, device=args.device,
        seconds=seconds,
    )
    wall = time.time() - t0
    for s in summaries:
        print(json.dumps(s))
    errors = sum(1 for s in summaries if "error" in s)
    resumed = sum(1 for s in summaries if s.get("resumed"))
    # throughput counts only THIS run's work, not checkpointed audio
    total_audio = sum(
        s.get("duration_s", 0.0) for s in summaries if not s.get("resumed")
    )
    print(json.dumps({
        "files": len(summaries),
        "errors": errors,
        "resumed": resumed,
        "audio_s": round(total_audio, 1),
        "wall_s": round(wall, 2),
        "audio_s_per_s": round(total_audio / wall, 1) if wall else None,
        "seconds": {k: round(v, 3) for k, v in seconds.items()},
    }), file=sys.stderr)
    return 0 if errors == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
