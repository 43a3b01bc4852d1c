#!/usr/bin/env python3
"""Multi-device throughput demonstration.

Processes a batch of signals data-parallel over a device mesh via
``sspv_tpu_torch.parallel.BatchPipeline`` (one K3 launch per "data" device
over all its rows' frames) and reports aggregate audio-seconds per second.
On ``cuda`` the mesh spans the cards there are; on the CPU it exercises the
same code over ``--cpu-devices`` logical devices:

    python -m sspv_tpu_torch.examples.sharded_throughput [--device cuda]
        [--cpu-devices N]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..utils.device import card_line, resolve_device, synchronize


def run(per_signal_s: float = 60.0, device="cuda", cpu_devices: int = 1) -> dict:
    from ..ops import LAUNCHES
    from ..parallel import BatchPipeline, make_mesh

    device = resolve_device(device)
    if device.type == "cuda":
        mesh = make_mesh(device="cuda")
    else:
        mesh = make_mesh(cpu_devices, device=device.type)
    n_dev = mesh.devices.size
    dp = mesh.devices.shape[0]
    print(f"devices={n_dev} mesh={mesh.shape}")

    sr = 16000
    rng = np.random.default_rng(0)
    batch = max(dp, n_dev)
    signals = rng.normal(0, 2000, (batch, int(per_signal_s * sr))).astype(np.float32)

    bp = BatchPipeline(mesh)
    first = mesh.devices.flat[0]
    before = dict(LAUNCHES)
    block, states = bp.process_batch(signals)  # the kernels' build + run
    synchronize(first)

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        block, _ = bp.process_batch(signals)
        synchronize(first)
        times.append(time.perf_counter() - t0)
    best = min(times)
    total_audio = batch * per_signal_s
    print(
        f"batch={batch} x {per_signal_s}s audio in {best*1000:.1f}ms -> "
        f"{total_audio/best:.0f}x real-time aggregate "
        f"({total_audio/best/n_dev:.0f}x per device) on {device} "
        f"({card_line(device)})"
    )
    return {"batch": batch, "seconds_each": per_signal_s,
            "best_s": best, "aggregate_x_realtime": total_audio / best,
            "frames": int(block.vad.shape[1]),
            "k3_launches": LAUNCHES["frame_features"] - before["frame_features"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sspv_tpu_torch.examples.sharded_throughput")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--cpu-devices", type=int, default=1,
                    help="logical CPU devices of the mesh with --device cpu")
    args = ap.parse_args(argv)
    run(device=args.device, cpu_devices=args.cpu_devices)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
