#!/usr/bin/env python3
"""Batch-process a directory of audio files into per-file feature exports.

Production-style offline pipeline: decode all files host-side, then run the
fused frame→MFCC→VAD pipeline. With a mesh of more than one device (and
more than one file) the files are zero-padded to a common length and
processed **data-parallel over the mesh** via
``sspv_tpu_torch.parallel.BatchPipeline`` (the masked batch programs, K3);
per-file outputs are truncated back to each file's own frame count (padding
follows the real audio, so it cannot affect preceding frames' adaptive
state). A one-device mesh processes the files one at a time (K1 for the
features, K2 for the pitch).

    python -m sspv_tpu_torch.examples.process_files INPUT_DIR [OUTPUT_DIR]
        [--device cuda] [--cpu-devices N]

On ``cuda`` the mesh spans the cards there are; with ``--device cpu`` it
spans ``N`` logical CPU devices (default 1), so a CPU run can take the
sharded branch too. Writes ``<name>.features.npz`` per input file with keys
``energies, zcrs, vads, spec_entropy, vads_adaptive, mfcc, f0, sample_rate,
frame_size, hop_size`` (the engine's export schema plus MFCC and pitch).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..utils.device import card_line, resolve_device, synchronize


def _decode(path, sample_rate):
    from ..runtime.audio_source import FileAudioSource

    src = FileAudioSource(path, sample_rate=sample_rate)
    src.open()
    pcm = src.read(1 << 62)
    src.close()
    return pcm


# The sharded path materializes a dense (batch, max_len) float32 matrix; keep
# it bounded so one long outlier file can't exhaust the host's memory.
_SHARDED_MATRIX_LIMIT_BYTES = 2 << 30


def _blocks_sequential(pipe, files, sample_rate):
    """Bounded-memory path: decode and process one file at a time."""
    for path in files:
        pcm = _decode(path, sample_rate)
        block, _ = pipe.process_signal_auto(pcm)
        synchronize(pipe.device)
        yield pcm, block


def _blocks_sharded(pipe, mesh, files, sample_rate, hop, frame):
    """Mesh-sharded batch path: decode all, pad to a common length and a
    mesh-divisible batch, then slice each file's rows back out. Falls back to
    the sequential generator when the padded matrix would be too large."""
    from ..parallel import BatchPipeline

    pcms = [_decode(p, sample_rate) for p in files]
    dp = mesh.devices.shape[0]
    max_len = max(len(p) for p in pcms)
    b = -(-len(pcms) // dp) * dp
    if b * max_len * 4 > _SHARDED_MATRIX_LIMIT_BYTES:
        print("padded batch too large for the sharded path; going sequential")
        for path, pcm in zip(files, pcms):
            block, _ = pipe.process_signal_auto(pcm)
            synchronize(pipe.device)
            yield pcm, block
        return
    bp = BatchPipeline(mesh, pipe.cfg)
    # masked batch API: padded frames are masked out of each signal's VAD
    # state on device, so there is no hand-rolled truncation arithmetic to
    # keep in sync with the framing formula (the per-file frame counts below
    # are only used to slice the outputs back out)
    signals = np.zeros((b, max_len), dtype=np.int16)
    for i, pcm in enumerate(pcms):
        signals[i, : len(pcm)] = np.asarray(pcm, np.int16)
    lengths = np.array([len(p) for p in pcms] + [0] * (b - len(pcms)), np.int32)
    batch_block, _ = bp.process_batch_masked(signals, lengths)
    batch_block = type(batch_block)(*(x.cpu() for x in batch_block))
    for i, pcm in enumerate(pcms):
        nf = max(0, 1 + (len(pcm) - frame) // hop) if len(pcm) >= frame else 0
        yield pcm, type(batch_block)(*(x[i][:nf] for x in batch_block))


def _mesh(device, cpu_devices: int):
    """The cards there are, or ``cpu_devices`` logical CPU devices."""
    from ..parallel import make_mesh

    if device.type == "cuda":
        return make_mesh(device="cuda")
    return make_mesh(cpu_devices, device=device.type)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sspv_tpu_torch.examples.process_files")
    ap.add_argument("in_dir")
    ap.add_argument("out_dir", nargs="?", default=None,
                    help="default: the input directory")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--cpu-devices", type=int, default=1,
                    help="logical CPU devices of the mesh with --device cpu")
    args = ap.parse_args(argv)
    in_dir = args.in_dir
    out_dir = args.out_dir or in_dir
    device = resolve_device(args.device)

    from ..config import Config
    from ..ops.pipeline import FeatureConfig, FeaturePipeline
    from ..ui.files import collect_audio_files

    files = collect_audio_files(in_dir)
    if not files:
        print(f"no supported audio files in {in_dir}")
        return 1
    os.makedirs(out_dir, exist_ok=True)

    pipe = FeaturePipeline(FeatureConfig.from_config(Config), device=device)
    mesh = _mesh(device, args.cpu_devices)
    total_audio = 0.0

    t_start = time.perf_counter()
    sharded = mesh.devices.size > 1 and len(files) > 1
    blocks = (
        _blocks_sharded(pipe, mesh, files, Config.SAMPLE_RATE,
                        Config.HOP_SIZE, Config.FRAME_SIZE)
        if sharded
        else _blocks_sequential(pipe, files, Config.SAMPLE_RATE)
    )
    for path, (pcm, block) in zip(files, blocks):
        total_audio += len(pcm) / Config.SAMPLE_RATE
        # the single production pitch path (analyze CLI, batch CLI, serving
        # layer): the bucketed signal-view track (K2), int16 shipped to the
        # device, no host frame matrix — exported f0 matches the serving
        # layer's output for the same file
        host = type(block)(*(x.cpu().numpy() for x in block))
        f0, _conf = pipe.pitch_signal_auto(pcm, host.vad)
        name = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(out_dir, f"{name}.features.npz")
        np.savez(
            out,
            energies=np.asarray(host.energy, np.float64),
            zcrs=np.asarray(host.zcr, np.float64),
            vads=np.asarray(host.vad, np.int32),
            spec_entropy=np.asarray(host.entropy, np.float32),
            vads_adaptive=np.asarray(host.vad_adaptive, np.float32),
            mfcc=np.asarray(host.mfcc, np.float32),
            f0=np.asarray(f0, np.float32),
            sample_rate=np.int32(Config.SAMPLE_RATE),
            frame_size=np.int32(Config.FRAME_SIZE),
            hop_size=np.int32(Config.HOP_SIZE),
        )
        print(f"{path}: {host.energy.shape[0]} frames -> {out}")

    elapsed = time.perf_counter() - t_start
    if elapsed > 0:
        mode = f"mesh-sharded over {mesh.devices.size}" if sharded else "sequential"
        print(
            f"processed {total_audio:.1f}s of audio in {elapsed:.2f}s "
            f"({total_audio/elapsed:.1f}x real-time, {mode}, kernels' build "
            f"included) on {device} ({card_line(device)})"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
