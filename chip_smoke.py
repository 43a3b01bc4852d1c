#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sspv_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. checks for a CUDA device (exits non-zero without one), turns TF32 off,
   and prints the card's name and power limit;
2. builds the three kernels from ``sspv_tpu_torch/csrc`` with nvcc;
3. holds each kernel against its plain PyTorch version on the card: the
   view kernels K1/K2 on random rows of 1 to 100 000 frames, the frames
   kernel K3 on random frames of 1 to 100 000 rows at frame 320 and 400,
   with a Hann window and with a separate 1024-point entropy spectrum, and
   each again on its main path's own input, the engine's bucket-padded
   blocks included (zcr exactly equal, energy/entropy/mfcc and pitch
   confidence NMSE <= 1e-9, F0 equal on >= 99.9 % of frames);
4. drives the offline view path on one hour of synthetic speech-like audio
   (``bench.synth_signal``): ``process_signal_device`` (features + VAD) and
   ``pitch_track_signal`` on the uploaded rows view, then
   ``process_signal_pitch_auto`` on a 37 s clip; it requires K1 and K2 to
   have launched, feature NMSE <= 1e-5 against the NumPy oracle and VAD
   decisions equal to the sequential engine oracle on the first 600 s, and a
   median voiced F0 within 5 Hz of the 130 Hz tone;
5. drives the offline frames path: ``process_signal_device`` on the same
   hour at the 400/160 framing (359,998 frames); it requires K3 (and no
   view kernel) to have launched, feature NMSE <= 1e-5 against the oracle
   on windowed 400-sample frames and VAD equal to the engine oracle on the
   first 600 s;
6. runs the streaming engine ``AudioRuntime`` over 600 s of the same audio
   from an in-memory source, read as fast as it goes: once with the samples
   dispatch (K1) and once with ``TPU_STREAM_SAMPLES_DISPATCH=0`` (K3); each
   must end without error with all 59,999 frames, its kernel launched,
   features equal to the plain versions' ``process_signal`` on the CPU
   (zcr and VAD exactly, the rest NMSE <= 1e-9), VAD equal to the engine
   oracle, and the kernel equal to its plain version on every block the
   run gave it; a third, 30 s run
   with ``TPU_ENGINE_PITCH=1`` must give a median voiced F0 within 5 Hz of
   130 Hz; ``save_data`` must write the 8-key npz schema;
7. times each kernel against its plain version at its main path's shape,
   and the end-to-end calls, with CUDA events (median of 10 calls each),
   and the engine's audio-seconds per second on the host clock;
8. bounds each kernel by the least work of its function: the operations
   of the features or ACF computed with real FFTs and a sparse mel
   filterbank, or the bytes it must move, whichever takes longer; it also
   prints the bound of the kernels' own design (DFT and ACF as dense fp32
   GEMMs).

Any failed check raises. The last lines are the card, one JSON object with
every kernel's launches, error, times and bound, and the
``{"ok": true, "device": ...}`` summary.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SR = 16000
MAIN_SECONDS = 3600
CHECK_SECONDS = 600
CLIP_SECONDS = 37
KERNEL_SIZES = (1, 17, 1023, 1025, 100_000)
FRAME_KERNEL_SIZES = (1, 7, 8, 255, 257, 100_000)
# K3 cases: (frame_size, window, entropy_n_fft)
FRAME_KERNEL_CASES = ((320, "hamming", 512), (400, "hamming", 512),
                      (400, "hanning", 512), (400, "hamming", 1024))
ASR_FRAME, HOP = 400, 160  # the offline frames path's 25 ms / 10 ms framing
ENGINE_SECONDS = 600
PITCH_ENGINE_SECONDS = 30
# The least time of a kernel's work on an H100 SXM (NVIDIA's data sheet, at
# its full 700 W): fp32 operations outside the tensor cores, device memory.
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
NMSE_KERNEL = 1e-9  # fp32 kernel vs fp32 plain version: rounding order only
NMSE_ORACLE = 1e-5  # the repo's feature-parity gate against the oracle
F0_MATCH = 0.999  # argmax picks may flip where two lags tie to rounding


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nmse(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12))


def host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def pitch_kernel_kwargs(pipe) -> dict:
    """K2's arguments for the default 50-400 Hz band of ``pipe``."""
    from sspv_tpu_torch.ops.pitch import _lag_band

    lag_min, lag_max = _lag_band(SR, 50.0, 400.0, pipe.cfg.frame_size)
    merged, nyq_b, inv_live, inv_nyq = pipe._acf_bases(lag_max)
    return dict(merged=merged, nyq_b=nyq_b, inv_live=inv_live,
                inv_nyq=inv_nyq, lag_min=lag_min, lag_max=lag_max,
                sample_rate=SR)


def feature_parity(name: str, x, consts: dict, err: dict) -> tuple:
    """One features kernel (``view_features`` on rows, ``frame_features``
    on frames) against its plain version on the same input on the card:
    ``(zcr equal, NMSE of the rest)``. ``err`` keeps each kernel's largest
    absolute difference."""
    from sspv_tpu_torch.ops import frame_kernels as fk
    from sspv_tpu_torch.ops import view_kernels as vk

    fused, plain = {
        "view_features": (vk.fused_view_features, vk.view_features_plain),
        "frame_features": (fk.fused_features, fk.frame_features_plain),
    }[name]
    got, want = fused(x, **consts), plain(x, **consts)
    zcr_equal = bool(np.array_equal(host(got["zcr"]), host(want["zcr"])))
    e = {k: nmse(host(got[k]), host(want[k]))
         for k in ("energy", "entropy", "mfcc")}
    for k in got:
        err[name] = max(
            err[name],
            float(np.max(np.abs(host(got[k]) - host(want[k])), initial=0)),
        )
    return zcr_equal, e


def compare_kernels(pipe, rows_list, err: dict) -> None:
    """Each view kernel against its plain version on the same rows (tensors
    on the card)."""
    from sspv_tpu_torch.ops import view_kernels as vk

    feat = pipe._view_consts
    pkw = pitch_kernel_kwargs(pipe)
    for rows_t in rows_list:
        n = rows_t.shape[0] - 1
        zcr_equal, e = feature_parity("view_features", rows_t, feat, err)
        f0_k, conf_k = vk.fused_view_pitch(rows_t, **pkw)
        f0_p, conf_p = vk.view_pitch_plain(rows_t, **pkw)
        match = float(np.mean(host(f0_k) == host(f0_p)))
        conf_e = nmse(host(conf_k), host(conf_p))
        err["view_pitch"] = max(
            err["view_pitch"], float(np.max(np.abs(host(conf_k) - host(conf_p))))
        )
        print(f"kernel-vs-plain n={n}: zcr_equal={zcr_equal} nmse="
              + json.dumps(e) + f" f0_match={match} conf_nmse={conf_e}")
        require(zcr_equal, f"K1 zcr equal at n={n}")
        require(max(e.values()) <= NMSE_KERNEL, f"K1 nmse {e} at n={n}")
        require(match >= F0_MATCH, f"K2 f0 match {match} at n={n}")
        require(conf_e <= NMSE_KERNEL, f"K2 conf nmse {conf_e} at n={n}")


def random_rows(device, sizes, seed: int = 0) -> list:
    import torch

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 1000, (n + 1, 160))
                             .astype(np.float32)).to(device) for n in sizes]


def check_zero_frames(pipe, device) -> None:
    """All-zero frames (bucket padding): f0 = sr / lag_min, conf 0, exactly,
    from the kernel and from the plain version."""
    import torch

    from sspv_tpu_torch.ops import view_kernels as vk

    pkw = pitch_kernel_kwargs(pipe)
    zeros = torch.zeros((41, 160), device=device)
    for f0, conf in (vk.fused_view_pitch(zeros, **pkw),
                     vk.view_pitch_plain(zeros, **pkw)):
        want = np.float32(SR) / np.float32(pkw["lag_min"])
        require(bool(np.all(host(f0) == want)) and not np.any(host(conf)),
                "zero frames give sr/lag_min and conf 0")


def frame_pipes(device) -> dict:
    """One pipeline per K3 case, keyed by the case."""
    from sspv_tpu_torch import FeatureConfig, FeaturePipeline

    return {
        case: FeaturePipeline(FeatureConfig(
            frame_size=case[0], hop_size=HOP, window_type=case[1],
            entropy_n_fft=case[2]), device=device)
        for case in FRAME_KERNEL_CASES
    }


def compare_frame_kernel(consts: dict, frames_list, err: dict,
                         label: str) -> None:
    """K3 against its plain version on the same frames (tensors on the
    card)."""
    for frames in frames_list:
        zcr_equal, e = feature_parity("frame_features", frames, consts, err)
        print(f"K3 vs plain {label} F={frames.shape[0]}: zcr_equal="
              f"{zcr_equal} nmse=" + json.dumps(e))
        require(zcr_equal, f"K3 zcr equal ({label}, F={frames.shape[0]})")
        require(max(e.values()) <= NMSE_KERNEL,
                f"K3 nmse {e} ({label}, F={frames.shape[0]})")


def random_frames(device, frame: int, seed: int) -> list:
    import torch

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 1000, (n, frame))
                             .astype(np.float32)).to(device)
            for n in FRAME_KERNEL_SIZES]


def oracle_frames_features(sig: np.ndarray, frame: int, hop: int) -> dict:
    """The NumPy oracle (``tests/oracle.py``) on windowed streaming frames."""
    import oracle

    n = 1 + (len(sig) - frame) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    windowed = (sig[idx].astype(np.float32)
                * oracle.hamming(frame)).astype(np.float32)
    return {
        "energy": oracle.short_time_energy(windowed),
        "zcr": oracle.zero_crossing_rate(windowed),
        "entropy": oracle.spectral_entropy(windowed, 512),
        "mfcc": oracle.mfcc(windowed, SR, lifter=22),
    }


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_launches() -> None:
    from sspv_tpu_torch.ops import LAUNCHES

    for k in LAUNCHES:
        LAUNCHES[k] = 0


def frames_path(pipe, device, sig: np.ndarray, check_seconds: int) -> dict:
    """The offline frames path through ``process_signal_device`` at the
    pipeline's (400/160) framing, checked against the oracle."""
    import torch

    import oracle
    from sspv_tpu_torch.ops import LAUNCHES

    c = pipe.cfg
    sig_t = torch.from_numpy(sig).to(device)
    sync(device)
    reset_launches()
    block, _ = pipe.process_signal_device(sig_t)
    sync(device)
    launches = dict(LAUNCHES)
    print("frames-path launches: " + json.dumps(launches))
    require(launches["frame_features"] > 0, "K3 launched on the frames path")
    require(launches["view_features"] == 0 and launches["view_pitch"] == 0,
            "no view kernel on the frames path")
    n = 1 + (len(sig) - c.frame_size) // c.hop_size
    require(block.energy.shape == (n,) and block.mfcc.shape == (n, 13),
            "frames-path shapes")
    for k in ("energy", "zcr", "entropy", "mfcc"):
        require(bool(torch.isfinite(getattr(block, k)).all()), f"{k} finite")
    head = sig[: check_seconds * SR]
    want = oracle_frames_features(head, c.frame_size, c.hop_size)
    vf = want["energy"].shape[0]
    feat_nmse = {k: nmse(host(getattr(block, k)[:vf]), want[k])
                 for k in ("energy", "zcr", "entropy", "mfcc")}
    print(f"frames path {n} frames of {c.frame_size}/{c.hop_size}: feature "
          f"nmse vs oracle (first {check_seconds} s): " + json.dumps(feat_nmse))
    require(max(feat_nmse.values()) <= NMSE_ORACLE, "frames-path nmse vs oracle")
    ref_vad, ref_adp = oracle.EngineVadOracle().run_all(
        host(block.energy[:vf]), host(block.zcr[:vf]), host(block.entropy[:vf])
    )
    vad_equal = bool(np.array_equal(host(block.vad[:vf]), ref_vad)
                     and np.array_equal(host(block.vad_adaptive[:vf]), ref_adp))
    print(f"frames-path vad equal to engine oracle: {vad_equal}")
    require(vad_equal, "frames-path VAD equals the engine oracle")
    return {"launches": launches, "signal": sig_t,
            "frames": pipe._device_stream_frames(sig_t)}


# The pipeline's name of each features kernel's wrapper.
PIPELINE_WRAPPERS = {"view_features": "fused_view_features",
                     "frame_features": "fused_features"}


def run_engine(device, sig16: np.ndarray, samples_dispatch: int,
               pitch: bool = False, record: str | None = None) -> dict:
    """One ``AudioRuntime`` run over an in-memory int16 source, read as fast
    as it goes, to its end. Returns the engine, its launches and seconds,
    and with ``record`` the name of a features kernel, a copy of the input
    and the constants of each call the run made to its wrapper."""
    from sspv_tpu_torch import AudioRuntime, Config
    from sspv_tpu_torch.ops import LAUNCHES
    from sspv_tpu_torch.ops import pipeline as pipeline_mod
    from sspv_tpu_torch.runtime.audio_source import AudioSource

    class MemorySource(AudioSource):
        def __init__(self, data):
            self.sample_rate, self.channels = SR, 1
            self._data, self._pos, self.exhausted = data, 0, False

        def open(self):
            self._pos, self.exhausted = 0, False

        def read(self, num_frames):
            chunk = self._data[self._pos : self._pos + num_frames]
            self._pos += len(chunk)
            self.exhausted = self._pos >= len(self._data)
            return chunk

        def close(self):
            pass

    n = 1 + (len(sig16) - 320) // 160
    Config.PROCESSED_DATA_BUFFER_SIZE = n
    Config.TPU_STREAM_SAMPLES_DISPATCH = samples_dispatch
    Config.TPU_ENGINE_PITCH = pitch
    rt = AudioRuntime(audio_source=MemorySource(sig16), device=device)
    require(rt._samples_dispatch == bool(samples_dispatch), "dispatch mode")
    calls = []
    if record is not None:
        wrapper = getattr(pipeline_mod, PIPELINE_WRAPPERS[record])

        def recording(x, **consts):
            calls.append((x.clone(), consts))
            return wrapper(x, **consts)

        setattr(pipeline_mod, PIPELINE_WRAPPERS[record], recording)
    sync(rt.pipeline.device)
    reset_launches()
    t0 = time.perf_counter()
    try:
        rt.auto_stop_on_eof = True
        rt.start()
        while rt.is_running and time.perf_counter() - t0 < 600:
            time.sleep(0.005)
        rt.stop()
    finally:
        if record is not None:
            setattr(pipeline_mod, PIPELINE_WRAPPERS[record], wrapper)
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    mode = "samples" if samples_dispatch else "frames"
    print(f"engine ({mode} dispatch{', pitch' if pitch else ''}): "
          f"{rt.frames_processed} frames in {rt.dispatch_count} dispatches, "
          f"{seconds:.3f} s, launches " + json.dumps(launches))
    require(rt.last_error is None, f"engine error: {rt.last_error!r}")
    require(not rt.is_running, "engine reached the end of its source")
    require(rt.frames_processed == n, f"engine frames {rt.frames_processed}")
    return {"rt": rt, "launches": launches, "seconds": seconds,
            "calls": calls}


def engine_kernel_parity(kernel: str, calls: list, err: dict) -> None:
    """The kernel against its plain version on every input the engine run
    gave it (bucket-padded blocks: zero rows past the audio)."""
    shapes = sorted({tuple(x.shape) for x, _ in calls})
    worst, zcr_equal = 0.0, True
    for x, consts in calls:
        eq, e = feature_parity(kernel, x, consts, err)
        zcr_equal &= eq
        worst = max(worst, *e.values())
    print(f"engine {kernel} vs plain on the run's {len(calls)} inputs "
          f"(shapes {shapes}): zcr_equal={zcr_equal} max nmse={worst}")
    require(len(calls) > 0, f"engine called the {kernel} wrapper")
    require(zcr_equal, f"engine {kernel} zcr equals its plain version")
    require(worst <= NMSE_KERNEL, f"engine {kernel} nmse {worst}")


def engine_runs(device, sig: np.ndarray, err: dict) -> dict:
    """Both dispatch modes over ENGINE_SECONDS, each held against the plain
    versions (``process_signal`` of a CPU pipeline, and each kernel call
    of the run) and the engine oracle, then a short pitch run and the npz
    export."""
    from sspv_tpu_torch import FeaturePipeline

    import oracle

    sig16 = np.clip(sig[: ENGINE_SECONDS * SR], -32768, 32767).astype(np.int16)
    plain, _ = FeaturePipeline(device="cpu").process_signal(sig16)
    want = {k: host(getattr(plain, k)) for k in ("energy", "zcr", "entropy",
                                                 "mfcc")}
    want_vad = host(plain.vad), host(plain.vad_adaptive)
    out = {}
    for mode, kernel in ((1, "view_features"), (0, "frame_features")):
        run = run_engine(device, sig16, mode, record=kernel)
        require(run["launches"][kernel] > 0, f"engine launched {kernel}")
        engine_kernel_parity(kernel, run.pop("calls"), err)
        rt = run["rt"]
        rows = list(rt.processed_data)
        got = {
            "energy": np.array([d["energy"] for d in rows], np.float32),
            "zcr": np.array([d["zcr"] for d in rows], np.float32),
            "entropy": np.array([d["spec_entropy"] for d in rows], np.float32),
            "mfcc": np.array([d["mfcc"] for d in rows], np.float32),
        }
        zcr_equal = bool(np.array_equal(got["zcr"], want["zcr"]))
        e = {k: nmse(got[k], want[k]) for k in ("energy", "entropy", "mfcc")}
        vad = np.array([d["vad"] for d in rows], np.int32)
        adp = np.array([d["vad_adaptive"] for d in rows], np.int32)
        ref_vad, ref_adp = oracle.EngineVadOracle().run_all(
            got["energy"], got["zcr"], got["entropy"]
        )
        vad_equal = bool(np.array_equal(vad, ref_vad)
                         and np.array_equal(adp, ref_adp))
        vad_plain = bool(np.array_equal(vad, want_vad[0])
                         and np.array_equal(adp, want_vad[1]))
        print(f"engine vs plain process_signal (CPU): zcr_equal={zcr_equal} "
              f"vad_equal={vad_plain} nmse=" + json.dumps(e)
              + f"; vad equal to engine oracle: {vad_equal}")
        require(zcr_equal, "engine zcr equals the plain process_signal")
        require(max(e.values()) <= NMSE_KERNEL, f"engine nmse {e}")
        require(vad_equal, "engine VAD equals the engine oracle")
        out[kernel] = run
        if mode == 1:
            with tempfile.TemporaryDirectory() as d:
                with np.load(rt.save_data(d)) as z:
                    dtypes = {k: str(z[k].dtype) for k in z.files}
                    n_saved = z["energies"].shape[0]
            print(f"save_data: {n_saved} frames, " + json.dumps(dtypes))
            require(dtypes == NPZ_DTYPES, f"save_data schema {dtypes}")
            require(n_saved == len(rows), "save_data frame count")
    run = run_engine(device, sig16[: PITCH_ENGINE_SECONDS * SR], 1,
                     pitch=True)
    f0, _ = run["rt"].get_recent_pitch(max_display=10**7)
    voiced = f0[f0 > 0]
    median_f0 = float(np.median(voiced)) if voiced.size else 0.0
    print(f"engine pitch: voiced frames {voiced.size} of {f0.size}, median "
          f"f0 {median_f0:.3f} Hz")
    require(f0.size == run["rt"].frames_processed, "one f0 per frame")
    require(abs(median_f0 - 130.0) < 5.0, "engine median voiced f0 near 130 Hz")
    return out


NPZ_DTYPES = {"energies": "float64", "zcrs": "float64", "vads": "int32",
              "spec_entropy": "float32", "vads_adaptive": "float32",
              "sample_rate": "int32", "frame_size": "int32",
              "hop_size": "int32"}


def main_path(pipe, device, seconds: int, check_seconds: int,
              clip_seconds: int) -> dict:
    """Features + VAD + pitch through the public entry points, checked."""
    import torch

    from bench import _oracle_features, synth_signal
    from sspv_tpu_torch.ops import LAUNCHES, pitch_track_signal

    sys.path.insert(0, str(ROOT / "tests"))
    import oracle

    sig = synth_signal(seconds, SR)
    rows = torch.from_numpy(pipe.host_rows_view(sig)).to(device)
    clip = sig[: clip_seconds * SR]
    if device.type == "cuda":
        torch.cuda.synchronize()
    reset_launches()
    block, _ = pipe.process_signal_device(rows)
    f0, conf = pitch_track_signal(rows, block.vad, min_confidence=0.3)
    clip_out = pipe.process_signal_pitch_auto(clip)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print("view-path launches: " + json.dumps(launches))
    require(launches["view_features"] > 0 and launches["view_pitch"] > 0,
            "both view kernels launched")

    n = rows.shape[0] - 1
    require(block.energy.shape == (n,) and block.mfcc.shape == (n, 13)
            and f0.shape == (n,), "output shapes")
    for k in ("energy", "zcr", "entropy", "mfcc"):
        require(bool(torch.isfinite(getattr(block, k)).all()), f"{k} finite")
    vf = 1 + (check_seconds * SR - 320) // 160
    want = _oracle_features(sig[: check_seconds * SR])
    feat_nmse = {k: nmse(host(getattr(block, k)[:vf]), want[k])
                 for k in ("energy", "zcr", "entropy", "mfcc")}
    print("feature nmse vs oracle (first %d s): %s"
          % (check_seconds, json.dumps(feat_nmse)))
    require(max(feat_nmse.values()) <= NMSE_ORACLE, "feature nmse vs oracle")
    ref_vad, ref_adp = oracle.EngineVadOracle().run_all(
        host(block.energy[:vf]), host(block.zcr[:vf]), host(block.entropy[:vf])
    )
    vad_equal = bool(np.array_equal(host(block.vad[:vf]), ref_vad)
                     and np.array_equal(host(block.vad_adaptive[:vf]), ref_adp))
    print(f"vad equal to engine oracle (first {check_seconds} s): {vad_equal}")
    require(vad_equal, "VAD decisions equal the engine oracle")
    voiced = host(f0)[host(f0) > 0]
    median_f0 = float(np.median(voiced)) if voiced.size else 0.0
    print(f"voiced frames {voiced.size} of {n}, median f0 {median_f0:.3f} Hz")
    require(abs(median_f0 - 130.0) < 5.0, "median voiced f0 near 130 Hz")

    cblock, _, cf0, cconf = clip_out
    two_block, _ = pipe.process_signal_auto(clip)
    two_f0, two_conf = pipe.pitch_signal_auto(clip, two_block.vad)
    clip_same = all(
        torch.equal(a, b) for a, b in zip(cblock, two_block)
    ) and np.array_equal(cf0, two_f0) and np.array_equal(cconf, two_conf)
    nc = 1 + (clip_seconds * SR - 320) // 160
    print(f"clip {clip_seconds} s: frames {cblock.vad.shape[0]}, voiced "
          f"{int((cf0 > 0).sum())}, fused == two-call: {clip_same}")
    require(cblock.vad.shape == (nc,) and cf0.shape == (nc,), "clip shapes")
    require(bool(clip_same), "process_signal_pitch_auto == auto + pitch_auto")
    return {"launches": launches, "rows": rows, "signal": sig}


def time_ms(fn, reps: int = 5) -> list[float]:
    """Device milliseconds of ``reps`` warm calls of ``fn``, each between
    its own pair of CUDA events (the gap a host-bound call leaves on the
    stream counts)."""
    import torch

    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, stop in events:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(stop) for start, stop in events]


def timings(pipe, rows, pipe400, frames_run, card: str) -> dict:
    """Median device ms of each kernel and of its plain version at its main
    path's shape, 10 calls each in turns (plain, kernel, kernel, plain) so
    drift lands on both; then the end-to-end features+VAD and pitch calls
    on the device-resident rows, and the frames path's features+VAD on the
    device-resident signal."""
    from sspv_tpu_torch.ops import frame_kernels as fk
    from sspv_tpu_torch.ops import pitch_track_signal
    from sspv_tpu_torch.ops import view_kernels as vk

    pk = pitch_kernel_kwargs(pipe)
    feat = pipe._view_consts
    fc = pipe400._frame_consts
    frames, sig400 = frames_run["frames"], frames_run["signal"]
    block, _ = pipe.process_signal_device(rows)
    runs = {
        "view_features": lambda: vk.fused_view_features(rows, **feat),
        "view_features_plain": lambda: vk.view_features_plain(rows, **feat),
        "view_pitch": lambda: vk.fused_view_pitch(rows, **pk),
        "view_pitch_plain": lambda: vk.view_pitch_plain(rows, **pk),
        "frame_features": lambda: fk.fused_features(frames, **fc),
        "frame_features_plain": lambda: fk.frame_features_plain(frames, **fc),
        "features_vad": lambda: pipe.process_signal_device(rows),
        "pitch": lambda: pitch_track_signal(rows, block.vad,
                                            min_confidence=0.3),
        "frames_features_vad": lambda: pipe400.process_signal_device(sig400),
    }
    samples = {k: [] for k in runs}
    for a, b in (("view_features_plain", "view_features"),
                 ("view_pitch_plain", "view_pitch"),
                 ("frame_features_plain", "frame_features"),
                 ("features_vad", "pitch")):
        for name in (a, b, b, a):
            samples[name] += time_ms(runs[name])
    samples["frames_features_vad"] += time_ms(runs["frames_features_vad"], 10)
    out = {k: float(np.median(v)) for k, v in samples.items()}
    spread = {k: [float(min(v)), float(max(v))] for k, v in samples.items()}
    audio_s = (rows.shape[0] - 1) * 160 / SR
    print(f"median device ms of 10 calls at {rows.shape[0] - 1} frames of "
          f"320 and {frames.shape[0]} of {frames.shape[1]} ({audio_s:.0f} s "
          f"of audio) on {card}: " + json.dumps(out))
    print("min/max ms: " + json.dumps(spread))
    print(f"features+VAD {audio_s / out['features_vad'] * 1e3:.1f} audio-s/s, "
          f"pitch {audio_s / out['pitch'] * 1e3:.1f} audio-s/s, frames-path "
          f"features+VAD {audio_s / out['frames_features_vad'] * 1e3:.1f} "
          f"audio-s/s on {card}")
    return out


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """The least ms of the work on the card and what bounds it."""
    t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def rfft_ops(n: int) -> float:
    """Operations of one real-input FFT of ``n`` points: half the
    ``5 n log2 n`` of a radix-2 complex FFT."""
    return 2.5 * n * math.log2(n)


def kernel_bounds(pipe, rows, pipe400, frames) -> dict:
    """Each kernel's bounds at its main-path shape, as ``{name: ((ms, what
    bounds it), design ms)}``. Both count the bytes the function must move
    (each input read once, each output written once) and fp32 operations
    (a multiply-add is 2). The first counts the least operations of the
    function: the power spectrum and the ACF by real FFTs, the mel
    filterbank by its nonzero weights. The second, the ceiling of the
    kernels' design, counts the DFT, the ACF and the filterbank as the
    dense GEMMs the kernels run."""
    c = pipe.cfg
    n, hop = rows.shape[0] - 1, rows.shape[1]
    frame, bins = 2 * hop, c.n_fft // 2 + 1
    nf, nc = c.num_filters, c.num_ceps
    fb_nnz = int((pipe._view_consts["fb_t"] != 0).sum())
    # power, mel, log, DCT, lifter, entropy
    tail = 3 * bins + 2 * fb_nnz + nf + 2 * nf * nc + nc + 5 * bins
    tail_gemm = tail + 2 * (bins * nf - fb_nnz)
    frame_ops = 3 * frame  # window, energy, sign changes
    out_bytes = 4 * (3 + nc)
    const_bytes = 4 * (bins * nf + nf * nc + nc)
    k1_bytes = (4 * (n + 1) * hop + 4 * (frame * c.n_fft + 2 * frame)
                + const_bytes + n * out_bytes)
    k1 = (n * (rfft_ops(c.n_fft) + frame_ops + tail),
          n * (2 * frame * c.n_fft + frame_ops + tail_gemm), k1_bytes)
    pk = pitch_kernel_kwargs(pipe)
    nfft_acf, (half, n_lags) = pk["merged"].shape[1], pk["inv_live"].shape
    # frame energy, power spectrum, normalization and peak pick
    acf_rest = 2 * frame + 3 * half + 3 * n_lags
    k2_bytes = (4 * (n + 1) * hop + 4 * (frame * nfft_acf + frame
                                         + half * n_lags + n_lags) + 8 * n)
    k2 = (n * (2 * rfft_ops(nfft_acf) + acf_rest),
          n * (2 * frame * nfft_acf + 2 * half * n_lags + acf_rest), k2_bytes)
    m, fr = frames.shape
    c4 = pipe400.cfg
    bins4, nf4, nc4 = c4.n_fft // 2 + 1, c4.num_filters, c4.num_ceps
    nnz4 = int((pipe400._frame_consts["fb_t"] != 0).sum())
    tail4 = 3 * bins4 + 2 * nnz4 + nf4 + 2 * nf4 * nc4 + nc4 + 5 * bins4
    k3_bytes = (4 * m * fr + 4 * (fr + 2 * fr * bins4 + bins4 * nf4
                                  + nf4 * nc4 + nc4) + m * 4 * (3 + nc4))
    k3 = (m * (rfft_ops(c4.n_fft) + 3 * fr + tail4),
          m * (4 * fr * bins4 + 3 * fr + tail4 + 2 * (bins4 * nf4 - nnz4)),
          k3_bytes)
    return {name: (bound(ops, nbytes), bound(gemm_ops, nbytes)[0])
            for name, (ops, gemm_ops, nbytes) in
            (("view_features", k1), ("view_pitch", k2),
             ("frame_features", k3))}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    sys.path.insert(0, str(ROOT))
    from sspv_tpu_torch import FeatureConfig, FeaturePipeline
    from sspv_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    path, log = _build.build()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {path.name}")
    for line in log.splitlines():
        if "registers" in line or "error" in line.lower():
            print("  " + line.strip())

    pipe = FeaturePipeline(device=device)
    err = {"view_features": 0.0, "view_pitch": 0.0, "frame_features": 0.0}
    compare_kernels(pipe, random_rows(device, KERNEL_SIZES), err)
    check_zero_frames(pipe, device)
    for i, (case, fpipe) in enumerate(frame_pipes(device).items()):
        compare_frame_kernel(fpipe._frame_consts,
                             random_frames(device, case[0], seed=i), err,
                             "frame=%d %s entropy_n_fft=%d" % case)

    main = main_path(pipe, device, MAIN_SECONDS, CHECK_SECONDS, CLIP_SECONDS)
    compare_kernels(pipe, [main["rows"]], err)  # at the main path's shape
    pipe400 = FeaturePipeline(FeatureConfig(frame_size=ASR_FRAME, hop_size=HOP),
                              device=device)
    frames_run = frames_path(pipe400, device, main["signal"], CHECK_SECONDS)
    compare_frame_kernel(pipe400._frame_consts, [frames_run["frames"]], err,
                         "frames path")
    engine = engine_runs(device, main["signal"], err)

    ms = timings(pipe, main["rows"], pipe400, frames_run, card)
    for kernel, run in engine.items():
        mode = "samples" if kernel == "view_features" else "frames"
        print(f"engine {mode} dispatch: {ENGINE_SECONDS / run['seconds']:.1f} "
              f"audio-s/s (host clock, {ENGINE_SECONDS} s of audio) on {card}")
    bounds = kernel_bounds(pipe, main["rows"], pipe400, frames_run["frames"])
    print("design bound ms (DFT/ACF/filterbank as dense fp32 GEMMs): "
          + json.dumps({k: v[1] for k, v in bounds.items()}))
    require("jax" not in sys.modules and "sspv_tpu" not in sys.modules,
            "no jax and no sspv_tpu imported")

    sources = {
        "view_features": ("sspv_tpu_torch/csrc/view_features.cu",
                          "sspv_tpu/ops/pallas_view.py:169", main),
        "view_pitch": ("sspv_tpu_torch/csrc/view_pitch.cu",
                       "sspv_tpu/ops/pallas_view.py:476", main),
        "frame_features": ("sspv_tpu_torch/csrc/frame_features.cu",
                           "sspv_tpu/ops/pallas_kernels.py:43", frames_run),
    }
    # library_ms: no single PyTorch call computes any of these functions
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": path["launches"][name], "max_abs_err": err[name],
         "ms": ms[name], "plain_ms": ms[name + "_plain"],
         "bound_ms": bounds[name][0][0], "bound_by": bounds[name][0][1],
         "library_ms": None}
        for name, (src, rep, path) in sources.items()
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
