#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sspv_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. checks for a CUDA device (exits non-zero without one), turns TF32 off,
   and prints the card's name and power limit;
2. builds the kernels from ``sspv_tpu_torch/csrc`` with nvcc (one nvcc per
   source, all at once);
3. holds each kernel against its plain PyTorch version on the card: the
   view kernels K1/K2 on random rows of 1 to 100 000 frames, the frames
   kernel K3 on random frames of 1 to 100 000 rows at frame 320 and 400,
   with a Hann window and with a separate 1024-point entropy spectrum
   (its FFT route), and with an odd and a non-power-of-two ``n_fft``,
   Whisper's framing (``n_fft`` 400, Hann, 80 mel bands) and frames of
   1,030 and 1,600 samples at ``n_fft`` 512 (its dense route: the DFT pair
   on the tensor cores in 3xTF32), and each again on its main path's own
   input, the engine's blocks included (zcr exactly equal, energy/entropy/mfcc
   and pitch confidence NMSE <= 1e-9, F0 equal on >= 99.9 % of frames);
   then K4, the VAD kernel (``vad_kernel_runs``), on random rows of 1 to
   400,000 frames and on eight rows at 4,096 frames and at 2,048 s, each
   with a random state, no mask, a prefix mask with random counts and a
   mask with holes, on the float32 threshold ties of
   ``tests/vad_inputs.py``, with the direct and the blocked window sums,
   and on its lengths path (``vad_lengths_runs``: rows of ragged lengths,
   one for all rows or one each, of 255 to 359,999 frames, none a
   multiple of 256, in the blocked order of a padded count and in the
   direct order), twice each (the second call on the state the first
   left): decisions, adaptive decisions and every field of the new state
   EQUAL to the plain version's. Every later phase requires K4's launches
   (one per features+VAD call, engine dispatch, batch on each "data"
   device and ``process_long`` call) and holds K4 to its plain version on
   every VAD input of the view path, the frames path, the engine runs and
   the corpus, each of which must give K4 lengths and no mask (no pad,
   mask or mask sum around it);
4. drives the offline view path on one hour of synthetic speech-like audio
   (``utils.synth.synth_signal``): ``process_signal_device`` (features + VAD) and
   ``pitch_track_signal`` on the uploaded rows view, then
   ``process_signal_pitch_auto`` on a 37 s clip; it requires K1 and K2 to
   have launched, feature NMSE <= 1e-5 against the NumPy oracle and VAD
   decisions equal to the sequential engine oracle on the first 600 s, and a
   median voiced F0 within 5 Hz of the 130 Hz tone;
5. drives the offline frames path: ``process_signal_device`` on the same
   hour at the 400/160 framing (359,998 frames); it requires K3's FFT route
   (and no view kernel) to have launched, feature NMSE <= 1e-5 against the oracle
   on windowed 400-sample frames and VAD equal to the engine oracle on the
   first 600 s;
6. runs the streaming engine ``AudioRuntime`` over 600 s of the same audio
   from an in-memory source, read as fast as it goes: once with the samples
   dispatch (K1) and once with ``TPU_STREAM_SAMPLES_DISPATCH=0`` (K3); each
   must end without error with all 59,999 frames, its kernel launched,
   features equal to the plain versions' ``process_signal`` on the CPU
   (zcr and VAD exactly, the rest NMSE <= 1e-9), VAD equal to the engine
   oracle, the kernel equal to its plain version on every block the run
   gave it, and the frames its feature kernel computed equal to the
   audio's own (no padding; printed as audio-seconds); a third, 30 s run
   with ``TPU_ENGINE_PITCH=1`` must give a median voiced F0 within 5 Hz of
   130 Hz; ``save_data`` must write the 8-key npz schema; then
   ``engine_trace``: eight dispatches of 2,048 and of 32 frames in each
   mode under ``torch.profiler`` (kernels per dispatch, device busy time
   and idle share);
7. runs ``BatchPipeline.process_long`` and ``process_long_pitch`` on the
   same hour at 320/160 on a one-card mesh and on a mesh naming the card
   four times (four shards in turn): the shard route must launch K1 and K2
   once per shard, give features, VAD, F0 and confidence bit-identical to
   ``process_signal_device`` and ``pitch_track_signal`` on the card, and
   each shard's kernel must equal its plain version on its input;
   then, at 322/161 (hop % 4 != 0: one-float loads), holds K1 and K2
   against their plain versions on random rows and runs
   ``process_signal_pitch_auto`` on the clip: K1 for the features and K2 for
   the pitch, each kernel input held to the plain version and the outputs
   to the same call on the CPU; and at 320/160 with ``n_fft`` 640 (even, no
   power of two: a view geometry K1's FFT does not serve) the same call
   takes K3's dense route for the features and K2 for the pitch;
   then ``dense_runs``: K3's dense route on the hour at Whisper's framing
   (400/160, ``n_fft`` 400, Hann, 80 mel bands), at 320/160 with ``n_fft``
   640 and at 400/160 with the 512-point bases sent without their
   ``n_fft`` (the dense route where the FFT route would serve), each held
   to its plain version on the hour's frames and timed (CUDA events,
   median of 20) beside the plain version, one fp32 cuBLAS product of the
   frames with ``[wc | ws]`` (the spectrum stage alone, never called by the
   port) and, with ``--parent DIR`` (an earlier checkout), the SIMT kernel
   it replaced, built from DIR in the same run, with
   ``roofline.kernel_bound``'s two bounds; then Whisper's framing as a
   path: features+VAD on the hour (one dense K3 launch and one K4 launch
   with the counts reset before it; its time) and
   ``process_signal_pitch_auto`` on the clip against the same call on the
   CPU (ZCR and VAD equal, the rest NMSE <= 1e-9);
8. runs the corpus CLI's ``process_corpus`` (batch 8) over 44 WAV files of
   1.5 s to 600 s cut from the same audio (every length bucket) and one
   2,100 s file (the oversized branch), once without and once with pitch,
   and ``python -m sspv_tpu_torch.batch --pitch`` on a few of them: one K3
   launch per batch, only each file's own frames through the feature
   kernels (the card's frames equal to the files' own, 7,858 audio-seconds;
   a batch pads only to its longest file), every file equal to
   ``process_signal_auto`` on the card
   (zcr and VAD exactly, the rest NMSE <= 1e-9), F0 equal to
   ``process_signal_pitch_auto`` on >= 99.9 % of frames, the npz schema and
   dtypes, every kernel equal to its plain version on every input the runs
   gave it; it prints the corpus audio-s/s (host clock) split into decode,
   device and write time;
9. drives the L1 ops, the ``SignalProcessing`` facade, the ``models``
   transforms and the resampler on the card, with BOTH process-wide TF32
   switches turned on around them (they scope float32 themselves): the
   facade (device left at its default) on 600 s at 400/160 against the same
   calls with ``SignalProcessing.device = "cpu"`` (ZCR equal, the rest
   NMSE <= 1e-9) and against the oracle (NMSE <= 1e-5);
   ``SpeechFrontend(400, 160).from_signal`` on the hour against K3's output
   on the frames both have (NMSE <= 1e-9; ZCR within one ulp, equal as
   counts); ``pitch_from_frames`` with ``acf_impl="direct"`` and ``"dft"``
   and ``pitch_from_frames_amdf`` on the hour's raw 320/160 frames (median
   F0 of the voiced stretches within 5 Hz of 130 for all three, direct and
   dft picks equal on >= 99.9 % of them); ``resample_to_rate_device`` on
   600 s made at 48 kHz and at 44.1 kHz against the host SciPy path
   (>= 99.9 % of samples equal, none further than one LSB), the 48 kHz file
   again through ``FileAudioSource`` with ``Config.TPU_DEVICE_RESAMPLE``
   set (the device resampler must have run: ``ops.resample.CALLS``);
   ``python -m sspv_tpu_torch.test_system`` and ``python -m
   sspv_tpu_torch.demo`` as subprocesses (exit code 0); then the times of
   each (CUDA events, medians of 10), the resampler's beside the same sum
   as one ``F.conv1d`` (``resample_by_conv1d``, used nowhere in the port);
10. times each kernel against its plain version at its main path's shape,
   and the end-to-end calls, with CUDA events (median of 10 calls each;
   beside K1, K3 and K2 the FFT stage alone through ``torch.fft``, a
   yardstick the port never calls), K1 and K2 also at 322/161:
   the view and frames paths, ``process_long(_pitch)`` per mesh, and
   ``process_batch_masked(_pitch)`` and the corpus's ``_exact_batch`` on
   one batch of eight 2,048 s rows with its K3 launch and its one VAD call
   (K4 and its plain version, on the rows' lengths) apart;
   K4 and its plain version on the hour's full-length VAD call, with
   ``torch.cummax`` of the same seeds beside them (a yardstick the port
   never calls); and the engine's
   audio-seconds per second on the host clock;
11. serves HTTP (``serve_runs``): ``serve.make_server`` over
    ``FeatureService(device)`` on a thread, warmed up; ``/healthz`` must
    answer 200 with backend ``cuda``; ``/v1/features``, ``/v1/vad`` and
    ``/v1/pitch`` on eight 60 s WAVs cut from the hour, ``/v1/features``
    on 600 s sent as a 44.1 kHz stereo WAV (downmix and resample, with
    ``TPU_DEVICE_RESAMPLE`` off and on) and on 2,048 s (the cap) as npz,
    2,049 s (must give 413), ``/v1/stream?pitch=1&mfcc=1`` over 600 s sent
    in 100 ms chunks, and 1, 4 and 8 concurrent clients of four 60 s
    requests each, features and pitch mixed. Every 200 response must equal
    the same samples through the pipeline called directly bit for bit
    (``process_signal_auto``, ``process_signal_pitch_auto``,
    ``stream_pitch`` over the chunks the server dispatches), with the same
    launches (K1 for features and VAD, K1 and K2 for pitch, K3 per stream
    dispatch, nothing else); the concurrent responses must equal the
    serial ones byte for byte and their launches add up; each kernel is
    held to its plain version on the first 60 s request's inputs; the
    frames the feature kernels computed for the requests and for the
    stream must equal the audio's own (printed as audio-seconds). It
    prints the warm-up seconds, p50/p95 latency per endpoint and size, and
    audio-s/s at 1, 4 and 8 clients and of the stream (host clock);
12. runs ``sspv_tpu_torch.main.main(["--device", "cuda"])`` in this process
    (``main_runs``) on a 600 s WAV of the engine phase's audio, headless,
    the snapshot in a temporary directory: the run must end at the end of
    the file with one K1 launch per engine dispatch, the frames of the
    engine phase's samples-mode run, and a ``save_data`` file that
    ``utils.npz_io.validate_session`` accepts;
13. drives the port's example harnesses and tools (``examples_runs``), each
    through its module's own function with the launch counts reset before
    it: ``python -m sspv_tpu_torch.examples.soak`` for 90 s in its own
    process, beside ``vad_eval`` (2 proxies x 7 conditions x 60 s and the
    two variant pipelines: decisions equal to ``EngineVadOracle`` on every
    frame, the F1 table printed), ``process_files`` over the corpus (each
    npz equal to ``process_signal_auto``/``pitch_signal_auto`` of its file),
    ``generate_samples`` (held to the five TPU-made samples committed in
    ``examples/sample_outputs``: keys, frame counts and VAD equal, the
    float fields within NMSE 1e-5), ``deep_fuzz`` (60 VAD configurations,
    20 geometries over both K3 routes, no mismatch) and
    ``sharded_throughput``; then ``soak_report`` on the soak's log (PASS,
    host RSS and the card's allocator per call); ``length_probe`` at 3,600
    and 14,400 s (57,600 s only where ``synth_signal`` makes 14,400 s in
    10 s) and ``pitch_probe`` at 3,600 s, one launch per call;
    ``latency_bench`` in both modes (every frame published, one K1 launch
    per dispatch and per warmed bucket); ``multistream_bench`` flood (8
    streams x 120 s) and paced (4 x 20 s) over one shared pipeline, each
    stream's frames equal to the CPU ``process_signal`` of its own signal;
    ``serve_bench`` against ``python -m sspv_tpu_torch.serve`` in its own
    process at 1, 4 and 8 clients with 60 s requests in JSON and npz, and
    once in this process, with no error;
14. drives the port's measuring tools (``tools_runs``), each with the
    launch counts reset before it: ``time_blocked_vad`` on the hour (both
    trailing-sum forms: one K1 launch per call, at most 3 decisions apart,
    each equal to the engine oracle on the first 600 s);
    ``vad_microbench`` at the 32,768-frame block and the hour's 360,192
    padded frames (the float64 blocked and matmul sums within 1e-12 of the
    direct sum; the ``F.conv1d`` yardstick printed only);
    ``resample_probe`` at 60 and 600 s on four rate pairs (one LSB at
    most, through the device resampler); ``ablate_bench`` on the hour
    (every ``full_*`` variant within NMSE 1e-5 of the oracle, K1 launched
    by ``features_no_vad``); ``roofline`` on the hour and on the probes'
    14,400 s signal (one K1 launch per ``feat_only`` call, one K2 launch
    per ``pitch_kernel_only`` call, their analytic bounds those of step
    15), then ``python -m sspv_tpu_torch.tools.roofline --trace`` in its
    own process on the hour: a ``torch.profiler`` trace of the features,
    the VAD and the pitch call (device idle share, launches per call, top
    kernels, longest gaps); it prints each tool's seconds;
15. bounds each kernel by the least work of its function: the operations
    of the features or ACF computed with real FFTs and a sparse mel
    filterbank, or the bytes it must move, whichever takes longer; it also
    prints the bound of the kernels' own design: the same FFT operations
    and bytes or the shared-memory traffic of their stages and tails,
    whichever is larger (``sspv_tpu_torch.tools.roofline.kernel_bound``,
    from the configuration and the frame count). The mesh wrappers'
    bounds are K1's and K2's at the same shape.

16. runs K5, the rows resampler of the batch programs (``k5_runs``), on
    the hour recorded at 48 kHz as Whisper's 120 windows of 30 s (the
    benchmark's speech, the last window 17 s and zero-padded): one launch,
    equal to its plain version on the card (float64 both) on at least
    1 - 1e-6 of the outputs and by one LSB where not, zero past each row's
    own length; timed (CUDA events, median of 10) beside the plain version,
    one float64 ``F.conv1d`` of the same sum (a yardstick the port never
    calls) and its bound (``portbench/readers/resample_roofline.work``);
    then ``process_batch_masked(..., source_rate=48000)`` on the hour: one
    launch each of K5, K3 and K4 and none else (every count, reset before
    the call; the ``kernels`` line's K5 ``launches``), bit for bit the same
    call on K5's 16 kHz rows, and its time
    beside that call's; then the control: ``csrc/resample.cu`` built alone
    with float32 sums (``-DSSPV_K5_ACC=float``) on one batch of 64 windows,
    its outputs that differ from K5's counted, and ``process_batch_masked``
    of its rows must fail the benchmark's comparison
    (``portbench/reference``: ``features_nmse`` <= 1e-9, ``vad_mismatch``
    0) where K5's rows pass it.

Any failed check raises. The last lines are the card, one JSON object with
every kernel's launches, error, times and bound, and the
``{"ok": true, "device": ...}`` summary.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SR = 16000
MAIN_SECONDS = 3600
CHECK_SECONDS = 600
CLIP_SECONDS = 37
KERNEL_SIZES = (1, 17, 1023, 1025, 100_000)
FRAME_KERNEL_SIZES = (1, 7, 8, 255, 257, 100_000)
# K3 cases: (frame_size, window, entropy_n_fft, n_fft, the route it takes,
# mel bands): its dense route at an odd n_fft, a non-power-of-two one,
# Whisper's framing, a frame longer than n_fft (one-float loads) and one
# staged in chunks (1600 samples)
FRAME_KERNEL_CASES = ((320, "hamming", 512, 512, "fft", 26),
                      (400, "hamming", 512, 512, "fft", 26),
                      (400, "hanning", 512, 512, "fft", 26),
                      (400, "hamming", 1024, 512, "fft", 26),
                      (400, "hamming", 511, 511, "dense", 26),
                      (400, "hamming", 480, 480, "dense", 26),
                      (400, "hanning", 400, 400, "dense", 80),
                      (1030, "hamming", 512, 512, "dense", 26),
                      (1600, "hamming", 512, 512, "dense", 26))
ASR_FRAME, HOP = 400, 160  # the offline frames path's 25 ms / 10 ms framing
GAP_FRAME, GAP_HOP = 322, 161  # a view geometry with one-float loads (hop % 4)
GAP_N_FFT = 640  # a view geometry K1 does not take: even, no power of two
# K3's dense route on the hour: (label, FeatureConfig keywords, whether the
# pipeline's own bases are sent without their n_fft, which forces the dense
# route where the FFT route would serve them). The first is the route's
# path: Whisper's and torchaudio MelSpectrogram's framing.
WHISPER = dict(frame_size=400, hop_size=160, n_fft=400, entropy_n_fft=400,
               window_type="hanning", num_filters=80)
DENSE_GEOMETRIES = (
    ("400/160 n_fft=400 hann 80 mel", WHISPER, False),
    (f"320/160 n_fft={GAP_N_FFT}", dict(n_fft=GAP_N_FFT,
                                        entropy_n_fft=GAP_N_FFT), False),
    ("400/160 n_fft=512 bases unvouched", dict(frame_size=400, hop_size=160),
     True),
)
DENSE_REPS = 10  # CUDA-event samples per turn, two turns a run
# synth_signal's voiced half-seconds are pure tones with no noise under
# them; a Hann window leaves the high mel bands of such frames below fp32
# rounding of the DFT, where any two fp32 implementations disagree (cuBLAS
# and the CPU alike). The Hann geometry is held to the gates on the same
# audio with a noise floor kept under the tones (FLOOR_RMS, synth_signal's
# own level) and, on the pure tones, against a float64 plain version beside
# fp32's.
FLOOR_RMS = 40.0
ENGINE_SECONDS = 600
PITCH_ENGINE_SECONDS = 30
LONG_SHARDS = (1, 4)  # process_long's meshes: one card, the card four times
# The corpus: file lengths in seconds, eight per length bucket of
# FeaturePipeline.SIGNAL_BUCKET_SECONDS (2, 8, 32, 128, 512 s) and four in
# the 2048 s bucket, plus one file past the largest bucket.
CORPUS_SECONDS = (1.5, 1.55, 1.6, 1.7, 1.8, 1.9, 1.95, 2.0,
                  3, 3.5, 4, 5, 6, 7, 7.5, 8,
                  10, 13, 16, 19, 22, 25, 28, 31,
                  40, 52, 64, 76, 88, 100, 112, 124,
                  150, 200, 250, 300, 350, 400, 450, 500,
                  530, 560, 590, 600)
OVERSIZED_SECONDS = 2100
CORPUS_BATCH = 8
CLI_FILES = 5
# K4 (the VAD) on random rows: (rows, frames) of one row up to 400,000
# frames (about 66 minutes of audio per call) and eight rows at 4,096 frames
# and at 2,048 s, the batch programs' largest bucket
VAD_KERNEL_SIZES = ((1, 1), (1, 255), (1, 256), (1, 257), (1, 4096),
                    (1, 65_536), (1, 400_000), (1, 400_128), (8, 4096),
                    (8, 204_800))
# K4's lengths path: (rows, frames), none a multiple of 256; the hour's
# 359,999 frames in one row, and eight rows at the corpus's largest bucket
VAD_LENGTH_SIZES = ((1, 255), (3, 1000), (8, 4097), (8, 204_799),
                    (1, 359_999))
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


def pitch_kernel_kwargs(pipe) -> dict:
    """K2's arguments for the default 50-400 Hz band of ``pipe``."""
    from sspv_tpu_torch.ops.pitch import _lag_band

    lag_min, lag_max = _lag_band(SR, 50.0, 400.0, pipe.cfg.frame_size)
    merged, nyq_b, inv_live, inv_nyq = pipe._acf_bases(lag_max)
    return dict(merged=merged, nyq_b=nyq_b, inv_live=inv_live,
                inv_nyq=inv_nyq, lag_min=lag_min, lag_max=lag_max,
                sample_rate=SR)


def feature_parity(name: str, x, consts: dict, err: dict,
                   key: str | None = None) -> tuple:
    """One features kernel (``view_features`` on rows, ``frame_features``
    on frames) against its plain version on the same input on the card:
    ``(zcr equal, NMSE of the rest)``. ``err[key]`` (default: the kernel's
    name) keeps the largest absolute difference."""
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
    key = key or name
    for k in got:
        err[key] = max(
            err[key],
            float(np.max(np.abs(host(got[k]) - host(want[k])), initial=0)),
        )
    return zcr_equal, e


def compare_kernels(pipe, rows_list, err: dict) -> None:
    """Each view kernel against its plain version on the same rows (tensors
    on the card)."""
    feat = pipe._view_consts
    pkw = pitch_kernel_kwargs(pipe)
    for rows_t in rows_list:
        n = rows_t.shape[0] - 1
        zcr_equal, e = feature_parity("view_features", rows_t, feat, err)
        match, conf_e = pitch_parity(rows_t, pkw, err)
        print(f"kernel-vs-plain n={n}: zcr_equal={zcr_equal} nmse="
              + json.dumps(e) + f" f0_match={match} conf_nmse={conf_e}")
        require(zcr_equal, f"K1 zcr equal at n={n}")
        require(max(e.values()) <= NMSE_KERNEL, f"K1 nmse {e} at n={n}")
        require(match >= F0_MATCH, f"K2 f0 match {match} at n={n}")
        require(conf_e <= NMSE_KERNEL, f"K2 conf nmse {conf_e} at n={n}")


def random_rows(device, sizes, seed: int = 0, hop: int = 160) -> list:
    import torch

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 1000, (n + 1, hop))
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


def vad_kernel_runs(device, err: dict) -> None:
    """K4 against its plain version on the card (``vad_kernel_runs``):
    random rows of 1 to 400,000 frames (each with a random state, no mask,
    a prefix mask and a mask with holes), eight rows with random
    ``n_valid``, the float32 threshold ties, each with the direct and the
    blocked sums, and every one again on the states it left (two calls
    that carry the state). Decisions, adaptive decisions and every field
    of the new state must be equal."""
    import torch

    from sspv_tpu_torch.ops import vad as vad_ops

    sys.path.insert(0, str(ROOT / "tests"))
    import vad_inputs

    cases = 0
    for b, f in VAD_KERNEL_SIZES:
        rows = vad_inputs.vad_rows(b, f, seed=b + f, device=device)
        for impl in ("conv", "blocked"):
            kw = dict(vad_inputs.GATES, trailing_impl=impl)
            for mask in ("none", "prefix", "holes"):
                e, z, h, state = rows
                valid = vad_inputs.row_mask(mask, b, f, seed=f, device=device)
                for call in range(2):
                    require(not vad_parity((e, z, h, state), dict(
                        kw, valid=valid), err),
                        f"K4 equals plain: {b} x {f}, {impl}, mask {mask}, "
                        f"call {call + 1}")
                    state = vad_ops.streaming_vad(e, z, h, state, valid=valid,
                                                  **kw)[2]
                    e = e.flip(-1)
                cases += 2
    for tie, make in sorted(vad_inputs.TIES.items()):
        e, z, h = (torch.from_numpy(x).to(device) for x in make())
        for impl in ("conv", "blocked"):
            kw = dict(vad_inputs.GATES, trailing_impl=impl)
            state = vad_ops.initial_vad_state(device=device)
            require(not vad_parity((e, z, h, state), kw, err),
                    f"K4 equals plain on {tie}, {impl}")
            first = vad_ops.streaming_vad(e[:4], z[:4], h[:4], state, **kw)[2]
            require(not vad_parity((e[:4], z[:4], h[:4], state), kw, err)
                    and not vad_parity((e[4:], z[4:], h[4:], first), kw, err),
                    f"K4 equals plain on {tie} split in two, {impl}")
            cases += 3
    cases += vad_lengths_runs(device, err, vad_inputs)
    sync(device)
    print(f"vad_kernel_runs: K4 equal to its plain version on {cases} calls "
          f"(rows x frames {list(VAD_KERNEL_SIZES)}, both sums, three masks, "
          f"two calls each; the ties; the lengths path at "
          f"{list(VAD_LENGTH_SIZES)}); max abs difference {err['vad']}")


def vad_lengths_runs(device, err: dict, vad_inputs) -> int:
    """K4's lengths path against its plain version: rows of ragged
    lengths, one length for every row or an int32 per row on the card,
    the blocked order asked for at a frame count that is no multiple of
    the history (the order of the padded call an exact-length call
    replaces) and the direct order, two calls each on the state the first
    left. Returns the calls made."""
    import torch

    from sspv_tpu_torch.ops import ROUTES
    from sspv_tpu_torch.ops.vad_kernels import plain_streaming_vad

    h = 256
    cases = 0
    for b, f in VAD_LENGTH_SIZES:
        e0, z, hh, state0 = vad_inputs.vad_rows(b, f, seed=3 * b + f,
                                                device=device)
        rng = np.random.default_rng(f)
        per_row = ([0, f, f // 2] + list(rng.integers(1, f, b)))[:b]
        for kind in ("int", "rows"):
            lengths = f - 3 if kind == "int" else torch.tensor(
                per_row, dtype=torch.int32, device=device)
            for route in ("blocked", "direct"):
                rf = -(-f // h) * h + (0 if route == "blocked" else 1)
                kw = dict(vad_inputs.GATES, trailing_impl="blocked",
                          lengths=lengths, route_frames=rf)
                e, state = e0, state0
                for call in range(2):
                    before = ROUTES["vad_" + route]
                    require(not vad_parity((e, z, hh, state), kw, err),
                            f"K4 equals plain: lengths {kind}, {b} x {f}, "
                            f"{route}, call {call + 1}")
                    require(ROUTES["vad_" + route] == before + 1,
                            f"K4 took its {route} route")
                    state = plain_streaming_vad(e, z, hh, state, **kw)[2]
                    e = e.flip(-1)
                cases += 2
    return cases


def frame_pipes(device) -> dict:
    """One pipeline per K3 case, keyed by the case."""
    from sspv_tpu_torch import FeatureConfig, FeaturePipeline

    return {
        case: FeaturePipeline(FeatureConfig(
            frame_size=case[0], hop_size=HOP, window_type=case[1],
            entropy_n_fft=case[2], n_fft=case[3], num_filters=case[5]),
            device=device)
        for case in FRAME_KERNEL_CASES
    }


def compare_frame_kernel(consts: dict, frames_list, err: dict,
                         label: str, route: str = "fft") -> None:
    """K3 against its plain version on the same frames (tensors on the
    card), through the route the geometry must take (``err`` keeps each
    route's largest difference apart)."""
    from sspv_tpu_torch.ops import ROUTES

    key = "frame_features_dense" if route == "dense" else "frame_features"
    for frames in frames_list:
        before = dict(ROUTES)
        zcr_equal, e = feature_parity("frame_features", frames, consts, err,
                                      key)
        require(ROUTES["frame_features_" + route] == before[
            "frame_features_" + route] + 1, f"K3 took its {route} route "
            f"({label})")
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


def capturing() -> bool:
    """Whether this thread's current CUDA stream is capturing a graph (an
    engine's first block of a size): a wrapper called then launches
    nothing, and each replay of the graph runs the captured launch."""
    import torch

    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def reset_launches() -> None:
    from sspv_tpu_torch.ops import LAUNCHES, ROUTES

    for counts in (LAUNCHES, ROUTES):
        for k in counts:
            counts[k] = 0


def require_fft_route(label: str) -> None:
    """Every K3 launch since the counts were reset took the FFT route."""
    from sspv_tpu_torch.ops import LAUNCHES, ROUTES

    print(f"{label} K3 routes: " + json.dumps(ROUTES))
    require(ROUTES["frame_features_fft"] == LAUNCHES["frame_features"] > 0
            and ROUTES["frame_features_dense"] == 0,
            f"{label}: K3 ran its FFT route")


def frames_path(pipe, device, sig: np.ndarray, check_seconds: int,
                err: dict) -> dict:
    """The offline frames path through ``process_signal_device`` at the
    pipeline's (400/160) framing, checked against the oracle; K4 against
    its plain version on the VAD's input."""
    import torch

    import oracle
    from sspv_tpu_torch.ops import LAUNCHES

    c = pipe.cfg
    sig_t = torch.from_numpy(sig).to(device)
    sync(device)
    with recording_vad() as vad_calls:
        reset_launches()
        block, _ = pipe.process_signal_device(sig_t)
        sync(device)
        launches = dict(LAUNCHES)
    print("frames-path launches: " + json.dumps(launches))
    require(launches["frame_features"] > 0, "K3 launched on the frames path")
    require(launches["vad"] == 1, "K4 launched once on the frames path")
    vad_calls_parity(vad_calls, err, "frames path", expected=1)
    require_fft_route("frames path")
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
    return {"launches": launches, "signal": sig_t, "oracle": want,
            "frames": pipe._device_stream_frames(sig_t)}


# The pipeline's name of each features kernel's wrapper.
PIPELINE_WRAPPERS = {"view_features": "fused_view_features",
                     "frame_features": "fused_features"}


@contextlib.contextmanager
def recording(targets):
    """Record a copy of the input and the constants of every call to a
    kernel's wrapper: ``targets`` lists the ``(module, name)`` under which
    callers reach it. Yields the list of calls."""
    calls, saved = [], []
    for module, name in targets:
        wrapper = getattr(module, name)

        def rec(x, __wrapper=wrapper, **consts):
            if not capturing():
                calls.append((x.clone(), consts))
            return __wrapper(x, **consts)

        saved.append((module, name, wrapper))
        setattr(module, name, rec)
    try:
        yield calls
    finally:
        for module, name, wrapper in saved:
            setattr(module, name, wrapper)


def pitch_parity(x, kw: dict, err: dict, key: str = "view_pitch") -> tuple:
    """K2 against its plain version on the same rows: ``(F0 match share,
    confidence NMSE)``; ``err[key]`` keeps the largest confidence
    difference."""
    from sspv_tpu_torch.ops import view_kernels as vk

    f0_k, conf_k = vk.fused_view_pitch(x, **kw)
    f0_p, conf_p = vk.view_pitch_plain(x, **kw)
    err[key] = max(err[key], float(np.max(
        np.abs(host(conf_k) - host(conf_p)), initial=0)))
    match = float(np.mean(host(f0_k) == host(f0_p))) if f0_k.numel() else 1.0
    return match, nmse(host(conf_k), host(conf_p))


def calls_parity(kernel: str, calls: list, err: dict, label: str,
                 key: str | None = None) -> None:
    """A kernel against its plain version on every recorded input."""
    key = key or kernel
    require(len(calls) > 0, f"{label} called the {kernel} wrapper")
    shapes = sorted({tuple(x.shape) for x, _ in calls})
    if kernel == "view_pitch":
        worst_match, worst = 1.0, 0.0
        for x, kw in calls:
            match, e = pitch_parity(x, kw, err, key)
            worst_match, worst = min(worst_match, match), max(worst, e)
        print(f"{label} K2 vs plain on {len(calls)} inputs (shapes {shapes}):"
              f" min f0 match={worst_match} max conf nmse={worst}")
        require(worst_match >= F0_MATCH, f"{label} K2 f0 match {worst_match}")
        require(worst <= NMSE_KERNEL, f"{label} K2 conf nmse {worst}")
        return
    worst, zcr_equal = 0.0, True
    for x, consts in calls:
        eq, e = feature_parity(kernel, x, consts, err, key)
        zcr_equal &= eq
        worst = max(worst, *e.values())
    print(f"{label} {kernel} vs plain on {len(calls)} inputs (shapes "
          f"{shapes}): zcr_equal={zcr_equal} max nmse={worst}")
    require(zcr_equal, f"{label} {kernel} zcr equals its plain version")
    require(worst <= NMSE_KERNEL, f"{label} {kernel} nmse {worst}")


@contextlib.contextmanager
def recording_vad():
    """Record a copy of the inputs and the keywords of every call the
    pipeline makes to K4's wrapper (``fused_streaming_vad``). Yields the
    list of calls."""
    from sspv_tpu_torch.ops import pipeline as pipeline_mod

    calls = []
    wrapper = pipeline_mod.fused_streaming_vad

    def rec(energy, zcr, entropy, state, **kw):
        if not capturing():
            calls.append(((energy.clone(), zcr.clone(), entropy.clone(),
                           type(state)(*(t.clone() for t in state))), kw))
        return wrapper(energy, zcr, entropy, state, **kw)

    pipeline_mod.fused_streaming_vad = rec
    try:
        yield calls
    finally:
        pipeline_mod.fused_streaming_vad = wrapper


@contextlib.contextmanager
def frames_on_card():
    """Count the frames the pipeline's feature kernels compute (K1: the
    rows view's rows less one, K3: its frames), from any thread. Yields a
    dict whose ``"frames"`` holds the count."""
    import threading

    from sspv_tpu_torch.ops import pipeline as pipeline_mod

    seen, lock = {"frames": 0}, threading.Lock()
    k1, k3 = pipeline_mod.fused_view_features, pipeline_mod.fused_features

    def add(n: int) -> None:
        if capturing():
            return
        with lock:
            seen["frames"] += n

    def count_k1(rows, **kw):
        add(rows.shape[0] - 1)
        return k1(rows, **kw)

    def count_k3(frames, **kw):
        add(frames.shape[0])
        return k3(frames, **kw)

    pipeline_mod.fused_view_features = count_k1
    pipeline_mod.fused_features = count_k3
    try:
        yield seen
    finally:
        pipeline_mod.fused_view_features = k1
        pipeline_mod.fused_features = k3


def audio_on_card(label: str, card_frames: int, audio_frames: int,
                  audio_s: float | None = None) -> None:
    """Print the audio-seconds the card's feature kernels processed beside
    the audio's own (frames times the hop), and require them equal."""
    own = f"{audio_s:.2f} s of audio, " if audio_s is not None else ""
    print(f"{label}: {own}{audio_frames} frames ({audio_frames * 160 / SR:.2f}"
          f" audio-s at the hop); the card processed {card_frames} frames "
          f"({card_frames * 160 / SR:.2f} audio-s)")
    require(card_frames == audio_frames,
            f"{label}: the card processed the audio's own frames")


def vad_parity(args: tuple, kw: dict, err: dict) -> list:
    """K4 against the plain version on the same inputs on the card: the
    outputs that differ (decisions, adaptive decisions, the state's
    fields; none expected); ``err["vad"]`` keeps the largest absolute
    difference."""
    import torch

    from sspv_tpu_torch.ops import vad as vad_ops
    from sspv_tpu_torch.ops.vad_kernels import (fused_streaming_vad,
                                                plain_streaming_vad)

    got = fused_streaming_vad(*args, **kw)
    want = plain_streaming_vad(*args, **kw)
    names = ("vad", "vad_adaptive") + vad_ops.VadState._fields
    bad = []
    for name, g, w in zip(names, (*got[:2], *got[2]), (*want[:2], *want[2])):
        if g.numel():
            err["vad"] = max(err["vad"], float(
                (g.double() - w.double()).abs().max()))
        if g.dtype != w.dtype or not torch.equal(g, w):
            bad.append(name)
    return bad


def vad_calls_parity(calls: list, err: dict, label: str,
                     expected: int | None = None) -> None:
    """K4 against its plain version on every recorded VAD call, each of
    which must give K4 its rows' lengths (or nothing) and no mask: no pad,
    mask or mask sum runs around the kernel."""
    require(len(calls) > 0 and (expected is None or len(calls) == expected),
            f"{label} called the VAD wrapper {len(calls)} times")
    shapes = sorted({tuple(args[0].shape) for args, _ in calls})
    masks = sum(kw.get("valid") is not None for _, kw in calls)
    bad = [vad_parity(args, kw, err) for args, kw in calls]
    print(f"{label} K4 vs plain on {len(calls)} inputs (shapes {shapes}, "
          f"{masks} with a mask): outputs apart {[b for b in bad if b][:3]}")
    require(not any(bad), f"{label} K4 equals its plain version: {bad}")
    require(masks == 0, f"{label}: K4 takes lengths, no mask")


def memory_source(data: np.ndarray):
    """An ``AudioSource`` over in-memory int16 samples, read as fast as
    the engine asks."""
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

    return MemorySource(data)


# dispatches of the engine traced under torch.profiler, per dispatch size:
# the top bucket (an engine that runs behind) and the smallest (the live
# cadence)
ENGINE_TRACE_DISPATCHES = 8
ENGINE_TRACE_FRAMES = (2048, 32)


def engine_trace(device, sig16: np.ndarray, samples_dispatch: int,
                 frames_per_dispatch: int, card: str) -> dict:
    """``ENGINE_TRACE_DISPATCHES`` engine dispatches of
    ``frames_per_dispatch`` frames each, one in flight as the engine's loop
    keeps them (``_dispatch`` then ``_materialize`` of the one before),
    under ``torch.profiler`` after a warm one: kernels per dispatch, the
    device's busy time and idle share over the window
    (``tools.roofline.read_trace``), recorded again up to 3 times while the
    profiler keeps fewer kernels than the host launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from sspv_tpu_torch import AudioRuntime, Config
    from sspv_tpu_torch.tools.roofline import read_trace

    saved = Config.TPU_STREAM_SAMPLES_DISPATCH, Config.TPU_ENGINE_PITCH
    Config.TPU_STREAM_SAMPLES_DISPATCH = samples_dispatch
    Config.TPU_ENGINE_PITCH = False
    try:
        rt = AudioRuntime(audio_source=memory_source(sig16), device=device)
    finally:
        Config.TPU_STREAM_SAMPLES_DISPATCH, Config.TPU_ENGINE_PITCH = saved
    hop, frame = 160, 320
    blocks = []
    for k in range(ENGINE_TRACE_DISPATCHES + 1):
        lo = k * frames_per_dispatch
        block = sig16[lo * hop : (lo + frames_per_dispatch - 1) * hop + frame]
        blocks.append(block if samples_dispatch else
                      rt.pipeline.stream_frames(block))

    def run(part):
        inflight = None
        for block in part:
            nxt = rt._dispatch(block, frames_per_dispatch)
            if inflight is not None:
                rt._materialize(inflight)
            inflight = nxt
        rt._materialize(inflight)

    mode = "samples" if samples_dispatch else "frames"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "engine_trace.json")
        for attempt in range(1, 4):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1),
                         on_trace_ready=lambda p: p.export_chrome_trace(path)
                         ) as prof:
                run(blocks[:1])
                sync(device)
                prof.step()
                t0 = time.perf_counter()
                run(blocks[1:])
                sync(device)
                wall = time.perf_counter() - t0
                prof.step()
            with open(path) as f:
                got = read_trace(json.load(f)["traceEvents"],
                                 ENGINE_TRACE_DISPATCHES)
            if got["window_ms"] is not None:
                break
    out = {"mode": mode, "frames_per_dispatch": frames_per_dispatch,
           "dispatches": ENGINE_TRACE_DISPATCHES, "attempts": attempt,
           "host_ms_per_dispatch": 1e3 * wall / ENGINE_TRACE_DISPATCHES,
           **{k: got[k] for k in ("kernel_launches_per_call", "window_ms",
                                  "device_busy_ms", "idle_share",
                                  "kernels_recorded", "kernels_launched",
                                  "top_device_ops_ms")}}
    out["device_trace"] = ("measured" if got["window_ms"] is not None else
                           "not measured: the profiler kept "
                           f"{got['kernels_recorded']} of "
                           f"{got['kernels_launched']} kernels")
    print(f"engine trace ({mode} dispatch, {frames_per_dispatch} frames a "
          f"dispatch, torch.profiler) on {card}: " + json.dumps(out))
    return out


def replayed_frames(rt) -> dict:
    """Count the frames of the blocks ``rt`` runs as graph replays (the
    wrappers see none of them). Returns a dict whose ``"frames"`` holds
    the count."""
    seen = {"frames": 0}
    replay = rt._replay

    def counted(n, slot):
        seen["frames"] += n
        return replay(n, slot)

    rt._replay = counted
    return seen


def run_engine(device, sig16: np.ndarray, samples_dispatch: int,
               pitch: bool = False, record: str | None = None) -> dict:
    """One ``AudioRuntime`` run over an in-memory int16 source, read as fast
    as it goes, to its end. Returns the engine, its launches and seconds,
    and with ``record`` the name of a features kernel, a copy of the input
    and the constants of each call the run made to its wrapper."""
    from sspv_tpu_torch import AudioRuntime, Config
    from sspv_tpu_torch.ops import LAUNCHES
    from sspv_tpu_torch.ops import pipeline as pipeline_mod

    n = 1 + (len(sig16) - 320) // 160
    Config.PROCESSED_DATA_BUFFER_SIZE = n
    Config.TPU_STREAM_SAMPLES_DISPATCH = samples_dispatch
    Config.TPU_ENGINE_PITCH = pitch
    rt = AudioRuntime(audio_source=memory_source(sig16), device=device)
    require(rt._samples_dispatch == bool(samples_dispatch), "dispatch mode")
    replayed = replayed_frames(rt)
    targets = [] if record is None else [
        (pipeline_mod, PIPELINE_WRAPPERS[record])]
    with recording(targets) as calls, recording_vad() as vad_calls, \
            frames_on_card() as on_card:
        sync(rt.pipeline.device)
        reset_launches()
        t0 = time.perf_counter()
        rt.auto_stop_on_eof = True
        rt.start()
        while rt.is_running and time.perf_counter() - t0 < 600:
            time.sleep(0.005)
        rt.stop()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    mode = "samples" if samples_dispatch else "frames"
    print(f"engine ({mode} dispatch{', pitch' if pitch else ''}): "
          f"{rt.frames_processed} frames in {rt.dispatch_count} dispatches "
          f"({rt.graph_replays} graph replays), {seconds:.3f} s, launches "
          + json.dumps(launches))
    require(rt.last_error is None, f"engine error: {rt.last_error!r}")
    require(not rt.is_running, "engine reached the end of its source")
    require(rt.frames_processed == n, f"engine frames {rt.frames_processed}")
    require(launches["vad"] == rt.dispatch_count
            == len(vad_calls) + rt.graph_replays,
            f"engine ({mode}): K4 once per dispatch")
    audio_on_card(f"engine ({mode} dispatch{', pitch' if pitch else ''})",
                  on_card["frames"] + replayed["frames"], rt.frames_processed,
                  len(sig16) / SR)
    return {"rt": rt, "launches": launches, "seconds": seconds,
            "calls": calls, "vad_calls": vad_calls}


def engine_runs(device, sig: np.ndarray, err: dict, card: str) -> dict:
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
        if kernel == "frame_features":
            require_fft_route("engine frames dispatch")
        calls_parity(kernel, run.pop("calls"), err, "engine")
        vad_calls_parity(run.pop("vad_calls"), err, f"engine {kernel}")
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
    run.pop("vad_calls")
    f0, _ = run["rt"].get_recent_pitch(max_display=10**7)
    voiced = f0[f0 > 0]
    median_f0 = float(np.median(voiced)) if voiced.size else 0.0
    print(f"engine pitch: voiced frames {voiced.size} of {f0.size}, median "
          f"f0 {median_f0:.3f} Hz")
    require(f0.size == run["rt"].frames_processed, "one f0 per frame")
    require(abs(median_f0 - 130.0) < 5.0, "engine median voiced f0 near 130 Hz")
    out["traces"] = [engine_trace(device, sig16, mode, frames, card)
                     for mode in (1, 0) for frames in ENGINE_TRACE_FRAMES]
    return out


NPZ_DTYPES = {"energies": "float64", "zcrs": "float64", "vads": "int32",
              "spec_entropy": "float32", "vads_adaptive": "float32",
              "sample_rate": "int32", "frame_size": "int32",
              "hop_size": "int32"}


def main_path(pipe, device, seconds: int, check_seconds: int,
              clip_seconds: int, err: dict) -> dict:
    """Features + VAD + pitch through the public entry points, checked; K4
    against its plain version on every VAD input the path gave it."""
    import torch

    from sspv_tpu_torch.ops import LAUNCHES, pitch_track_signal
    from sspv_tpu_torch.utils.synth import oracle_features, synth_signal

    sys.path.insert(0, str(ROOT / "tests"))
    import oracle

    sig = synth_signal(seconds, SR)
    rows = torch.from_numpy(pipe.host_rows_view(sig)).to(device)
    clip = sig[: clip_seconds * SR]
    if device.type == "cuda":
        torch.cuda.synchronize()
    with recording_vad() as vad_calls:
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
    require(launches["vad"] == 2, "K4 once per features+VAD call (the hour, "
            "the clip)")
    vad_calls_parity(vad_calls, err, "view path", expected=2)

    n = rows.shape[0] - 1
    require(block.energy.shape == (n,) and block.mfcc.shape == (n, 13)
            and f0.shape == (n,), "output shapes")
    for k in ("energy", "zcr", "entropy", "mfcc"):
        require(bool(torch.isfinite(getattr(block, k)).all()), f"{k} finite")
    vf = 1 + (check_seconds * SR - 320) // 160
    want = oracle_features(sig[: check_seconds * SR])
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


def long_runs(pipe, device, rows, err: dict) -> dict:
    """``BatchPipeline.process_long`` and ``process_long_pitch`` on the
    main path's hour, on a mesh of one card and on the card named
    ``LONG_SHARDS[-1]`` times: launches per shard, bit-identity with the
    single-device calls, and each shard's kernel against its plain
    version."""
    import torch

    from sspv_tpu_torch.ops import LAUNCHES, pitch_track_signal
    from sspv_tpu_torch.ops import pipeline as pipeline_mod
    from sspv_tpu_torch.parallel import BatchPipeline, Mesh
    from sspv_tpu_torch.parallel import mesh as mesh_mod

    sig = rows.reshape(-1)  # (n+1)*hop samples on the card: n frames
    n = rows.shape[0] - 1
    ref, ref_state = pipe.process_signal_device(rows)
    ref_f0, ref_conf = pitch_track_signal(rows, ref.vad, min_confidence=0.3)
    sync(device)
    # the mesh wrappers' launches: the K1 and K2 launches of this phase
    out = {"launches": {"long_kernel_feats": 0, "long_kernel_pitch": 0},
           "pipes": {}}
    for d in LONG_SHARDS:
        bp = BatchPipeline(Mesh([device] * d))
        require(bp._long_kernel, "the shard route takes 320/160")
        out["pipes"][d] = bp
        with recording([(pipeline_mod, "fused_view_features")]) as feat_calls, \
                recording([(mesh_mod, "fused_view_pitch")]) as pitch_calls:
            reset_launches()
            block, state = bp.process_long(sig)
            sync(device)
            feats = dict(LAUNCHES)
            reset_launches()
            pblock, pstate, f0, conf = bp.process_long_pitch(sig)
            sync(device)
            pitch = dict(LAUNCHES)
        print(f"process_long d={d} launches " + json.dumps(feats)
              + "; process_long_pitch launches " + json.dumps(pitch))
        require(feats["view_features"] == d and feats["view_pitch"] == 0
                and feats["frame_features"] == 0,
                f"process_long launches K1 once per shard (d={d})")
        require(feats["vad"] == 1 == pitch["vad"],
                f"process_long(_pitch): K4 once after the gather (d={d})")
        require(pitch["view_features"] == d == pitch["view_pitch"]
                and pitch["frame_features"] == 0,
                f"process_long_pitch launches K1 and K2 once per shard (d={d})")
        out["launches"]["long_kernel_feats"] += (feats["view_features"]
                                                 + pitch["view_features"])
        out["launches"]["long_kernel_pitch"] += pitch["view_pitch"]
        same = {
            "block": all(torch.equal(a, b) for a, b in zip(block, ref)),
            "pitch_block": all(torch.equal(a, b) for a, b in zip(pblock, ref)),
            "state": all(torch.equal(a, b) for a, b in
                         zip(state[2:] + pstate[2:], ref_state[2:] * 2)),
            "f0": torch.equal(f0, ref_f0), "conf": torch.equal(conf, ref_conf),
        }
        print(f"process_long(_pitch) d={d}, {n} frames, bit-identical to "
              "process_signal_device / pitch_track_signal: " + json.dumps(same))
        require(all(same.values()), f"shard route bit-identical (d={d})")
        calls_parity("view_features", feat_calls, err, f"long d={d}",
                     "long_kernel_feats")
        calls_parity("view_pitch", pitch_calls, err, f"long d={d}",
                     "long_kernel_pitch")
    return out


def clip_against_cpu(pipe, cfg, clip: np.ndarray, label: str,
                     records: list) -> dict:
    """``process_signal_pitch_auto`` on the clip on the card, its launches,
    and its outputs against the same call on the CPU (the plain versions).
    ``records`` lists ``recording`` targets, one list per kernel; the
    recorded calls come back under ``"calls"``, in that order."""
    from sspv_tpu_torch import FeaturePipeline
    from sspv_tpu_torch.ops import LAUNCHES, ROUTES

    with contextlib.ExitStack() as stack:
        calls = [stack.enter_context(recording(t)) for t in records]
        sync(pipe.device)
        reset_launches()
        block, _, f0, conf = pipe.process_signal_pitch_auto(clip)
        sync(pipe.device)
        launches, routes = dict(LAUNCHES), dict(ROUTES)
    print(f"{label} process_signal_pitch_auto launches "
          + json.dumps(launches) + " K3 routes " + json.dumps(routes))
    cblock, _, cf0, cconf = FeaturePipeline(
        cfg, device="cpu").process_signal_pitch_auto(clip)
    zcr_vad = all(np.array_equal(host(getattr(block, k)), host(getattr(cblock, k)))
                  for k in ("zcr", "vad", "vad_adaptive"))
    e = {k: nmse(host(getattr(block, k)), host(getattr(cblock, k)))
         for k in ("energy", "entropy", "mfcc")}
    match = float(np.mean(f0 == cf0)) if f0.size else 1.0
    voiced = f0[f0 > 0]
    median_f0 = float(np.median(voiced)) if voiced.size else 0.0
    print(f"{label} clip vs CPU: zcr and vad equal {zcr_vad}, "
          f"nmse " + json.dumps(e) + f", f0 match {match}, conf nmse "
          f"{nmse(conf, cconf)}, median voiced f0 {median_f0:.3f} Hz")
    require(zcr_vad, f"{label} zcr and VAD equal the CPU run")
    require(max(e.values()) <= NMSE_KERNEL, f"{label} nmse {e}")
    require(match >= F0_MATCH and nmse(conf, cconf) <= NMSE_KERNEL,
            f"{label} f0 match {match}")
    require(abs(median_f0 - 130.0) < 5.0, f"{label} median voiced f0 near 130")
    return {"launches": launches, "routes": routes, "calls": calls}


def gap_runs(device, sig: np.ndarray, err: dict, card: str) -> dict:
    """View geometries off the default one. At 322/161 (hop % 4 != 0) K1 and
    K2 read one float a lane: each against its plain version on random rows
    and on every input ``process_signal_pitch_auto`` gave it on a clip, the
    clip's outputs against the same call on the CPU (the plain versions),
    and both kernels' times at one hour's rows. At 320/160 with ``n_fft``
    ``GAP_N_FFT``, which K1's FFT does not serve, the view routes run K3
    (its dense route) on the frames formed on the card, and K2 takes the
    pitch."""
    import torch

    from sspv_tpu_torch import FeatureConfig, FeaturePipeline
    from sspv_tpu_torch.ops import pipeline as pipeline_mod
    from sspv_tpu_torch.ops import pitch as pitch_mod
    from sspv_tpu_torch.ops import view_kernels as vk

    label = f"{GAP_FRAME}/{GAP_HOP}"
    cfg = FeatureConfig(frame_size=GAP_FRAME, hop_size=GAP_HOP)
    pipe = FeaturePipeline(cfg, device=device)
    pkw = pitch_kernel_kwargs(pipe)
    feat = pipe._view_consts
    for rows in random_rows(device, KERNEL_SIZES, seed=5, hop=GAP_HOP):
        zcr_equal, fe = feature_parity("view_features", rows, feat, err)
        match, e = pitch_parity(rows, pkw, err)
        n = rows.shape[0] - 1
        print(f"K1 and K2 vs plain at {label} n={n}: zcr_equal={zcr_equal} "
              f"nmse=" + json.dumps(fe) + f" f0_match={match} conf_nmse={e}")
        require(zcr_equal, f"K1 zcr equal at hop {GAP_HOP}, n={n}")
        require(max(fe.values()) <= NMSE_KERNEL,
                f"K1 nmse {fe} at hop {GAP_HOP}, n={n}")
        require(match >= F0_MATCH, f"K2 f0 match {match} at hop {GAP_HOP}")
        require(e <= NMSE_KERNEL, f"K2 conf nmse {e} at hop {GAP_HOP}")
    clip = sig[: CLIP_SECONDS * SR]
    run = clip_against_cpu(
        pipe, cfg, clip, label,
        [[(pipeline_mod, "fused_view_features")],
         [(pitch_mod, "fused_view_pitch")]])
    launches = run["launches"]
    require(launches["view_features"] == 1 and launches["view_pitch"] == 1
            and launches["frame_features"] == 0 and launches["vad"] == 1,
            f"{label}: K1 for the features, K2 for the pitch, K4 the VAD")
    calls_parity("view_features", run["calls"][0], err, label)
    calls_parity("view_pitch", run["calls"][1], err, label)

    cfg640 = FeatureConfig(n_fft=GAP_N_FFT, entropy_n_fft=GAP_N_FFT)
    label640 = f"320/160 n_fft={GAP_N_FFT}"
    run640 = clip_against_cpu(
        FeaturePipeline(cfg640, device=device), cfg640, clip, label640,
        [[(pipeline_mod, "fused_features")]])
    require(run640["launches"] == {"view_features": 0, "view_pitch": 1,
                                   "frame_features": 1, "vad": 1,
                                   "resample": 0}
            and run640["routes"]["frame_features_dense"] == 1,
            f"{label640}: K3 (dense route) for the features, K2 for the pitch")
    calls_parity("frame_features", run640["calls"][0], err, label640,
                 "frame_features_dense")

    rows = torch.from_numpy(pipe.host_rows_view(sig)).to(device)
    runs = {"view_features": lambda: vk.fused_view_features(rows, **feat),
            "view_features_plain": lambda: vk.view_features_plain(rows, **feat),
            "view_pitch": lambda: vk.fused_view_pitch(rows, **pkw),
            "view_pitch_plain": lambda: vk.view_pitch_plain(rows, **pkw)}
    samples = {k: [] for k in runs}
    for kernel in ("view_features", "view_pitch"):
        for name in (kernel + "_plain", kernel, kernel, kernel + "_plain"):
            samples[name] += time_ms(runs[name])
    ms = {k: float(np.median(v)) for k, v in samples.items()}
    print(f"K1 and K2 at {label}, {rows.shape[0] - 1} frames: median "
          f"device ms of 10 calls on {card}: " + json.dumps(ms))
    return {"launches": launches, "ms": ms}


def floored(sig: np.ndarray, seed: int = 1) -> np.ndarray:
    """``sig`` with a noise floor of ``FLOOR_RMS`` under every sample."""
    rng = np.random.default_rng(seed)
    return (sig + rng.normal(0, FLOOR_RMS, sig.size)).astype(np.float32)


def float64_accuracy(frames, consts: dict, got: dict, label: str) -> dict:
    """The kernel's outputs ``got`` and the fp32 plain version's against
    the plain version in float64 on the same frames: ``{field: [kernel
    NMSE, fp32 plain NMSE]}``."""
    import torch

    from sspv_tpu_torch.ops import frame_kernels as fk

    f64 = {k: (v.double() if isinstance(v, torch.Tensor) else v)
           for k, v in consts.items() if k != "dense_bases"}
    exact = fk.frame_features_plain(frames.double(), **f64)
    fp32 = fk.frame_features_plain(frames, **consts)
    out = {k: [nmse(host(got[k]), host(exact[k])),
               nmse(host(fp32[k]), host(exact[k]))]
           for k in ("energy", "entropy", "mfcc")}
    print(f"{label}: NMSE against float64 (3xTF32 kernel, fp32 plain): "
          + json.dumps(out))
    # 3xTF32 carries each product to within 3 * 2^-22 of it (the roundings
    # of a's and b's lo parts and the dropped a_lo b_lo) where fp32 rounds
    # the running sum to 2^-24: at most 12 times the error, 144 times the
    # squared error
    require(all(k <= 144 * p for k, p in out.values()),
            f"{label}: the kernel within 144x the fp32 NMSE against float64")
    return out


def parent_library(parent: Path):
    """The kernel library of an earlier checkout at ``parent``, built from
    its sources with this checkout's nvcc flags into its
    ``build/parent_kernels``: K1's, K2's and K3's FFT route's entry points
    declared as this checkout's, and ``sspv_frame_features``, the SIMT
    DFT-pair kernel that K3's tensor-core dense kernel replaced."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from sspv_tpu_torch.ops import _build

    csrc = parent / "sspv_tpu_torch" / "csrc"
    out = parent / "build" / "parent_kernels"
    out.mkdir(parents=True, exist_ok=True)
    units = sorted(csrc.glob("*.cu"))
    nvcc = _build._nvcc()

    def run(cmd):
        res = subprocess.run(cmd, capture_output=True, text=True)
        require(res.returncode == 0, f"parent build: {res.stderr[-2000:]}")

    objects = [str(out / (u.stem + ".o")) for u in units]
    with ThreadPoolExecutor(len(units)) as pool:
        list(pool.map(lambda uo: run([nvcc, *_build.NVCC_FLAGS, "-c",
                                      str(uo[0]), "-o", uo[1]]),
                      zip(units, objects)))
    so = out / "libparent_kernels.so"
    run([nvcc, "-shared", "-o", str(so), *objects])
    lib = ctypes.CDLL(str(so))
    here = _build.library()
    for name in ("sspv_view_features", "sspv_view_pitch",
                 "sspv_frame_features_fft", "sspv_error_string"):
        getattr(lib, name).argtypes = getattr(here, name).argtypes
        getattr(lib, name).restype = getattr(here, name).restype
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sspv_frame_features.argtypes = [p, i, i, p, p, p, i, p, i, p, p, i,
                                        f, i, p, p, p, p, p]
    lib.sspv_frame_features.restype = i
    return lib


@contextlib.contextmanager
def parent_kernels(lib):
    """The port's wrappers launch ``lib``'s kernels inside the block."""
    from sspv_tpu_torch.ops import _build

    here = _build.library()
    _build._lib = lib
    try:
        yield
    finally:
        _build._lib = here


def parent_ab(lib, pipe, rows, pipe400, frames, card: str) -> dict:
    """K1, K2 and K3's FFT route of this checkout against an earlier one's
    (``parent_library``) on the main paths' inputs: outputs bit for bit
    equal, and medians of 20 timed calls each in turns (parent, change,
    change, parent)."""
    import torch

    from sspv_tpu_torch.ops import frame_kernels as fk
    from sspv_tpu_torch.ops import view_kernels as vk

    pk = pitch_kernel_kwargs(pipe)
    runs = {"view_features": lambda: vk.fused_view_features(
                rows, **pipe._view_consts),
            "view_pitch": lambda: vk.fused_view_pitch(rows, **pk),
            "frame_features": lambda: fk.fused_features(
                frames, **pipe400._frame_consts)}
    out = {}
    for name, fn in runs.items():
        got = fn()
        with parent_kernels(lib):
            want = fn()
        got = got.values() if isinstance(got, dict) else got
        want = want.values() if isinstance(want, dict) else want
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        samples = {"parent": [], "change": []}
        for who in ("parent", "change", "change", "parent"):
            with (parent_kernels(lib) if who == "parent"
                  else contextlib.nullcontext()):
                samples[who] += time_ms(fn, DENSE_REPS)
        out[name] = {"bit_identical": same,
                     **{k: float(np.median(v)) for k, v in samples.items()}}
        require(same, f"{name}: outputs bit-identical to the parent's")
    print(f"K1, K2, K3 FFT route against the parent's on {card}: "
          + json.dumps(out))
    return out


def dense_runs(device, sig: np.ndarray, err: dict, card: str,
               parent_lib=None) -> dict:
    """K3's dense route (the DFT pair on the tensor cores in 3xTF32) on the
    hour at ``DENSE_GEOMETRIES``: held to its plain version on the hour's
    frames, then timed (CUDA events, median of 20) beside the plain
    version, one fp32 cuBLAS product of the frames with ``[wc | ws]`` (the
    spectrum stage alone, which the port never calls; TF32 off) and, with
    ``parent_lib`` (``parent_library``), the SIMT kernel it replaced, built
    from an earlier checkout in this run (turns: parent, kernel, kernel,
    parent), with both bounds of
    ``roofline.kernel_bound``. The Hann geometry runs on ``floored`` audio,
    and on the pure tones its kernel and fp32 plain outputs are set beside
    a float64 plain version's (``float64_accuracy``). Then its path,
    Whisper's framing: the frames path's features+VAD on the hour (counts
    reset before it: one dense K3 launch, one K4 launch) and
    ``process_signal_pitch_auto`` on the clip against the same call on the
    CPU (ZCR and VAD equal, the rest NMSE <= ``NMSE_KERNEL``)."""
    import torch

    from sspv_tpu_torch import FeatureConfig, FeaturePipeline
    from sspv_tpu_torch.ops import LAUNCHES, ROUTES
    from sspv_tpu_torch.ops import frame_kernels as fk
    from sspv_tpu_torch.ops import pipeline as pipeline_mod
    from sspv_tpu_torch.tools.roofline import TF32_OPS_PER_S, kernel_bound

    old = parent_lib.sspv_frame_features if parent_lib is not None else None
    sig_t = torch.from_numpy(sig).to(device)
    floor_t = torch.from_numpy(floored(sig)).to(device)
    geometries = {}
    for label, geometry, unvouched in DENSE_GEOMETRIES:
        cfg = FeatureConfig(**geometry)
        pipe = FeaturePipeline(cfg, device=device)
        hann = cfg.window_type == "hanning"
        frames = pipe._device_stream_frames(floor_t if hann else sig_t)
        consts = dict(pipe._frame_consts)
        if unvouched:
            consts.update(n_fft=None, dense_bases=fk.pack_dense_bases(
                consts["wc"], consts["ws"]))
        n, frame = frames.shape
        n_bins = consts["fb_t"].shape[0]
        require(fk.kernel_route(frame, n_bins, consts["n_fft"]) == "dense",
                f"{label} takes K3's dense route")
        before = ROUTES["frame_features_dense"]
        zcr_equal, e = feature_parity("frame_features", frames, consts, err,
                                      "frame_features_dense")
        print(f"K3 dense vs plain {label} F={n}: zcr_equal={zcr_equal} "
              f"nmse=" + json.dumps(e))
        require(ROUTES["frame_features_dense"] == before + 1,
                f"{label}: one dense launch")
        require(zcr_equal and max(e.values()) <= NMSE_KERNEL,
                f"K3 dense {label}: zcr {zcr_equal}, nmse {e}")
        accuracy = None
        if hann:
            pure = pipe._device_stream_frames(sig_t)
            accuracy = float64_accuracy(
                pure, consts, fk.fused_features(pure, **consts),
                f"K3 dense {label} on the pure tones")
            del pure

        pair = torch.cat([consts["wc"], consts["ws"]], dim=1)
        runs = {"kernel": lambda: fk.fused_features(frames, **consts),
                "plain": lambda: fk.frame_features_plain(frames, **consts),
                "library": lambda: frames @ pair}
        if old is not None:
            out = [torch.empty(n, device=device) for _ in range(3)]
            mfcc = torch.empty((n, consts["dct"].shape[1]), device=device)

            def parent_call():
                c = consts
                code = old(frames.data_ptr(), n, frame,
                           c["window"].data_ptr(), c["wc"].data_ptr(),
                           c["ws"].data_ptr(), n_bins, c["fb_t"].data_ptr(),
                           c["fb_t"].shape[1], c["dct"].data_ptr(),
                           c["lifter"].data_ptr(), c["dct"].shape[1],
                           float(np.float32(np.log(n_bins))), 1,
                           *(t.data_ptr() for t in out), mfcc.data_ptr(),
                           torch.cuda.current_stream(device).cuda_stream)
                require(code == 0, f"parent kernel launch: CUDA error {code}")

            runs["parent"] = parent_call
            parent_call()
            want = fk.frame_features_plain(frames, **consts)
            parent_nmse = nmse(host(mfcc), host(want["mfcc"]))
            print(f"parent SIMT kernel {label}: mfcc nmse vs plain "
                  f"{parent_nmse}")
            require(parent_nmse <= NMSE_KERNEL, f"parent kernel {label}")
            del want
        allow = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        samples = {k: [] for k in runs}
        for a, b in ((("parent" if old is not None else "plain"), "kernel"),
                     ("plain", "library")):
            for name in (a, b, b, a):
                samples[name] += time_ms(runs[name], DENSE_REPS)
        torch.backends.cuda.matmul.allow_tf32 = allow
        ms = {k: float(np.median(v)) for k, v in samples.items()}
        b = kernel_bound("frame_features", cfg, n, route="dense")
        geometries[label] = {
            "frames": n, "launches": 1, "ms": ms["kernel"],
            "parent_ms": ms.get("parent"), "plain_ms": ms["plain"],
            "library_ms": ms["library"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "design_bound_ms": b["design_bound_ms"],
            "design_bound_by": b["design_bound_by"],
            "tf32_bound_ms": 1e3 * b["design_ops"] / TF32_OPS_PER_S,
            "plan": list(fk.dense_plan(frame, n_bins, n)),
            "pure_tone_nmse_vs_float64": accuracy,
            "spread_ms": [float(min(samples["kernel"])),
                          float(max(samples["kernel"]))]}
        print(f"K3 dense {label}, {n} frames, on {card}: "
              + json.dumps(geometries[label]))
        del frames, runs, pair

    # the route's path: Whisper's framing
    label = DENSE_GEOMETRIES[0][0]
    cfg = FeatureConfig(**WHISPER)
    pipe = FeaturePipeline(cfg, device=device)
    with recording_vad() as vad_calls:
        sync(device)
        reset_launches()
        block, _ = pipe.process_signal_device(floor_t)
        sync(device)
        launches, routes = dict(LAUNCHES), dict(ROUTES)
    print(f"{label} frames path on the hour: launches " + json.dumps(launches)
          + " K3 routes " + json.dumps(routes))
    require(launches == {"view_features": 0, "view_pitch": 0,
                         "frame_features": 1, "vad": 1, "resample": 0}
            and routes["frame_features_dense"] == 1,
            f"{label}: one dense K3 launch and one K4 launch")
    vad_calls_parity(vad_calls, err, label, expected=1)
    n = 1 + (len(sig) - cfg.frame_size) // cfg.hop_size
    require(block.energy.shape == (n,) and block.mfcc.shape == (n, 13),
            f"{label} shapes")
    for k in ("energy", "zcr", "entropy", "mfcc"):
        require(bool(torch.isfinite(getattr(block, k)).all()),
                f"{label} {k} finite")
    path_ms = float(np.median(time_ms(
        lambda: pipe.process_signal_device(floor_t), DENSE_REPS)))
    audio_s = len(sig) / SR
    print(f"{label} frames-path features+VAD on the hour: {path_ms:.3f} ms "
          f"({audio_s / path_ms * 1e3:.1f} audio-s/s) on {card}")
    clip = host(floor_t[: CLIP_SECONDS * SR])
    run = clip_against_cpu(pipe, cfg, clip, label,
                           [[(pipeline_mod, "fused_features")]])
    require(run["launches"]["frame_features"] > 0
            and run["routes"]["frame_features_dense"]
            == run["launches"]["frame_features"]
            and run["launches"]["view_features"] == 0,
            f"{label}: the clip's features through K3's dense route")
    calls_parity("frame_features", run["calls"][0], err, label,
                 "frame_features_dense")
    return {"launches": launches, "geometries": geometries,
            "path_ms": path_ms}


def wav_bytes(pcm: np.ndarray, rate: int = SR, channels: int = 1) -> bytes:
    """A 16-bit PCM WAV file of ``pcm`` (``(n, channels)`` when stereo)."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.astype("<i2").tobytes())
    return buf.getvalue()


def write_wav(path: Path, pcm: np.ndarray, rate: int = SR) -> str:
    Path(path).write_bytes(wav_bytes(pcm, rate))
    return str(path)


def corpus_files(sig: np.ndarray, folder: Path) -> list[str]:
    """The corpus's WAV files, cut from ``sig`` at spread offsets."""
    pcm = np.clip(sig, -32768, 32767).astype(np.int16)
    files = []
    for k, seconds in enumerate(CORPUS_SECONDS + (OVERSIZED_SECONDS,)):
        n = int(seconds * SR)
        off = (k * 97 * SR) % (len(pcm) - n + 1)
        files.append(write_wav(folder / f"f{k:02d}_{seconds}s.wav",
                               pcm[off : off + n]))
    return files


def corpus_batches(files_seconds) -> int:
    """Batches ``process_corpus`` forms at ``CORPUS_BATCH`` files each."""
    from sspv_tpu_torch import FeaturePipeline

    per_bucket: dict = {}
    for s in files_seconds:
        b = next((x for x in FeaturePipeline.SIGNAL_BUCKET_SECONDS
                  if int(s * SR) <= x * SR), None)
        if b is not None:
            per_bucket[b] = per_bucket.get(b, 0) + 1
    return sum(-(-k // CORPUS_BATCH) for k in per_bucket.values())


def corpus_runs(device, sig: np.ndarray, err: dict, card: str) -> dict:
    """``process_corpus`` without and with pitch, and the batch CLI, on the
    corpus, checked against the single-file entry points on the card."""
    from sspv_tpu_torch import FeatureConfig, FeaturePipeline
    from sspv_tpu_torch.batch import _decode, process_corpus
    from sspv_tpu_torch.config import Config
    from sspv_tpu_torch.ops import LAUNCHES
    from sspv_tpu_torch.ops import pipeline as pipeline_mod
    from sspv_tpu_torch.ops import pitch as pitch_mod
    from sspv_tpu_torch.parallel import mesh as mesh_mod

    n_batches = corpus_batches(CORPUS_SECONDS + (OVERSIZED_SECONDS,))
    audio_s = float(sum(CORPUS_SECONDS) + OVERSIZED_SECONDS)
    out = {"launches": {}}
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        files = corpus_files(sig, folder)
        pipe = FeaturePipeline(FeatureConfig.from_config(Config), device=device)
        for want_pitch in (False, True):
            out_dir = folder / f"npz_{int(want_pitch)}"
            seconds: dict = {}
            with recording([(pipeline_mod, "fused_features")]) as k3_calls, \
                    recording([(pipeline_mod, "fused_view_features")]) as k1_calls, \
                    recording([(mesh_mod, "fused_view_pitch"),
                               (pitch_mod, "fused_view_pitch")]) as k2_calls, \
                    recording_vad() as vad_calls, \
                    frames_on_card() as on_card:
                sync(device)
                reset_launches()
                t0 = time.perf_counter()
                summaries = process_corpus(
                    files, out_dir=str(out_dir), batch_size=CORPUS_BATCH,
                    want_pitch=want_pitch, device=device, seconds=seconds,
                )
                sync(device)
                wall = time.perf_counter() - t0
                launches = dict(LAUNCHES)
            label = "corpus" + (" pitch" if want_pitch else "")
            out["launches"][label] = launches
            print(f"{label}: {len(files)} files, {n_batches} batches, "
                  f"launches " + json.dumps(launches))
            print(f"{label}: {audio_s / wall:.1f} audio-s/s over {audio_s:.0f}"
                  f" s of audio in {wall:.3f} s (host clock; decode "
                  f"{seconds['decode']:.3f} s, device {seconds['device']:.3f}"
                  f" s, write {seconds['write']:.3f} s) on {card}")
            require(all("error" not in s for s in summaries), "corpus errors")
            audio_on_card(label, on_card["frames"],
                          sum(s["frames"] for s in summaries), audio_s)
            k2_frames = sum(x.shape[0] - 1 for x, _ in k2_calls)
            if want_pitch:  # K2 runs each file's frames, plus one frame that
                # straddles two files at each file's end in a batch
                print(f"{label}: K2 computed {k2_frames} frames")
            require(launches["frame_features"] == n_batches,
                    f"{label}: one K3 launch per batch")
            require(launches["vad"] == n_batches + 1,
                    f"{label}: one K4 launch per batch (all its rows) and "
                    "one for the oversized file")
            require_fft_route(label)
            require(launches["view_features"] == 1,
                    f"{label}: the oversized file took the view path")
            if want_pitch:
                require(launches["view_pitch"] == n_batches + 1,
                        f"{label}: one K2 launch per batch and file")
            calls_parity("frame_features", k3_calls, err, label)
            calls_parity("view_features", k1_calls, err, label)
            vad_calls_parity(vad_calls, err, label, expected=n_batches + 1)
            if want_pitch:
                calls_parity("view_pitch", k2_calls, err, label)
            check_corpus(pipe, files, summaries, want_pitch, _decode)
            out[label] = {"wall": wall, "seconds": seconds,
                          "summaries": summaries}
        cli = files[:CLI_FILES]
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "sspv_tpu_torch.batch", *cli, "--pitch",
             "--out-dir", str(folder / "cli"), "--jsonl",
             str(folder / "cli.jsonl")],
            capture_output=True, text=True, timeout=300, cwd=ROOT, env=env,
        )
        print(f"python -m sspv_tpu_torch.batch --pitch on {len(cli)} files: "
              f"rc {res.returncode} in {time.perf_counter() - t0:.1f} s; "
              + (res.stderr.strip().splitlines() or [""])[-1])
        require(res.returncode == 0, "batch CLI: " + res.stderr[-2000:])
        lines = [json.loads(x) for x in res.stdout.splitlines() if x.strip()]
        want = out["corpus pitch"]["summaries"][:CLI_FILES]
        strip = lambda d: {k: v for k, v in d.items() if k != "npz"}
        require([strip(x) for x in lines] == [strip(x) for x in want],
                "batch CLI summaries equal process_corpus's")
    return out


def check_corpus(pipe, files, summaries, want_pitch: bool, decode) -> None:
    """Every file of a corpus run against the single-file entry points on
    the card, and its npz schema."""
    worst = {"energy": 0.0, "entropy": 0.0, "mfcc": 0.0}
    zcr_vad_equal, f0_match, frames = True, [], 0
    want_dtypes = dict(NPZ_DTYPES, mfcc="float32")
    if want_pitch:
        want_dtypes.update(f0="float32", pitch_confidence="float32")
    for path, summary in zip(files, summaries):
        pcm = decode(path)
        if want_pitch:
            block, _, f0, _ = pipe.process_signal_pitch_auto(pcm)
        else:
            block, _ = pipe.process_signal_auto(pcm)
        with np.load(summary["npz"]) as z:
            dtypes = {k: str(z[k].dtype) for k in z.files}
            require(dtypes == want_dtypes, f"npz schema {dtypes}")
            got = {"energy": z["energies"], "zcr": z["zcrs"],
                   "entropy": z["spec_entropy"], "mfcc": z["mfcc"],
                   "vad": z["vads"], "vad_adaptive": z["vads_adaptive"]}
            if want_pitch:
                f0_match.append(np.sum(z["f0"] == f0))
        n = block.vad.shape[0]
        frames += n
        require(summary["frames"] == n == got["vad"].shape[0],
                f"frames of {path}")
        zcr_vad_equal &= all(
            np.array_equal(got[k].astype(np.float32), host(getattr(block, k))
                           .astype(np.float32))
            for k in ("zcr", "vad", "vad_adaptive"))
        for k in worst:
            worst[k] = max(worst[k], nmse(got[k], host(getattr(block, k))))
    match = float(sum(f0_match) / frames) if want_pitch else 1.0
    print(f"corpus vs single-file on the card ({len(files)} files, {frames} "
          f"frames): zcr and vad equal {zcr_vad_equal}, max nmse "
          + json.dumps(worst) + (f", f0 match {match}" if want_pitch else ""))
    require(zcr_vad_equal, "corpus zcr and VAD equal the single-file path")
    require(max(worst.values()) <= NMSE_KERNEL, f"corpus nmse {worst}")
    require(match >= F0_MATCH, f"corpus f0 match {match}")


def long_timings(long_run, rows, card: str) -> dict:
    """Median device ms of process_long(_pitch) and of the two mesh
    wrappers (and their plain versions over the same shards) per mesh."""
    from sspv_tpu_torch.ops import view_kernels as vk

    sig, n = rows.reshape(-1), rows.shape[0] - 1
    out = {}
    for d, bp in long_run["pipes"].items():
        lag_min, lag_max = 40, 319
        pk = dict(zip(("merged", "nyq_b", "inv_live", "inv_nyq"),
                      bp.pipe._acf_bases(lag_max)),
                  lag_min=lag_min, lag_max=lag_max, sample_rate=SR)

        def plain_feats():
            return [vk.view_features_plain(t, **bp.pipe._view_consts)
                    for _, t in bp._shards(rows, n)]

        def plain_pitch():
            return [vk.view_pitch_plain(t, **pk) for _, t in bp._shards(rows, n)]

        runs = {
            "long_kernel_feats": lambda: bp._long_kernel_feats(rows, n),
            "long_kernel_feats_plain": plain_feats,
            "long_kernel_pitch": lambda: bp._long_kernel_pitch(rows, n, 50.0,
                                                               400.0),
            "long_kernel_pitch_plain": plain_pitch,
            "process_long": lambda: bp.process_long(sig),
            "process_long_pitch": lambda: bp.process_long_pitch(sig),
        }
        samples = {k: [] for k in runs}
        for a, b in (("long_kernel_feats_plain", "long_kernel_feats"),
                     ("long_kernel_pitch_plain", "long_kernel_pitch"),
                     ("process_long", "process_long_pitch")):
            for name in (a, b, b, a):
                samples[name] += time_ms(runs[name])
        out[d] = {k: float(np.median(v)) for k, v in samples.items()}
        audio_s = n * 160 / SR
        print(f"mesh of {d} shard(s), {n} frames: median device ms of 10 "
              f"calls on {card}: " + json.dumps(out[d]))
        print(f"process_long d={d}: "
              f"{audio_s / out[d]['process_long'] * 1e3:.1f} audio-s/s, "
              f"process_long_pitch "
              f"{audio_s / out[d]['process_long_pitch'] * 1e3:.1f} audio-s/s"
              f" on {card}")
    return out


def batch_timings(device, sig: np.ndarray, card: str) -> dict:
    """Median device ms of ``process_batch_masked`` on one batch of the
    largest bucket (``CORPUS_BATCH`` rows of 2,048 s cut from ``sig``,
    int16 on the card), and of its parts: the one K3 launch on the batch's
    frames and the one VAD call over the batch's rows (K4, and its plain
    version beside it)."""
    import torch

    from sspv_tpu_torch import FeaturePipeline
    from sspv_tpu_torch.parallel import BatchPipeline, Mesh

    bp = BatchPipeline(Mesh([device]))
    pipe = bp.pipe
    length = FeaturePipeline.SIGNAL_BUCKET_SECONDS[-1] * SR
    pcm = np.clip(sig, -32768, 32767).astype(np.int16)
    reps = -(-length // len(pcm))
    rows = np.stack([np.roll(np.tile(pcm, reps)[:length], 7919 * r)
                     for r in range(CORPUS_BATCH)])
    batch = torch.from_numpy(rows).to(device)
    lengths = [length - 1000 * r for r in range(CORPUS_BATCH)]
    c = pipe.cfg
    x = batch.to(torch.float32)
    frames = x.unfold(1, c.frame_size, c.hop_size).reshape(-1, c.frame_size)
    f = frames.shape[0] // CORPUS_BATCH
    feats = {k: v.reshape((CORPUS_BATCH, f) + v.shape[1:])
             for k, v in pipe._features(frames).items()}
    from sspv_tpu_torch.ops import LAUNCHES
    from sspv_tpu_torch.ops.vad_kernels import plain_streaming_vad

    sync(device)
    reset_launches()
    bp.process_batch_masked(batch, lengths)
    sync(device)
    require(LAUNCHES["vad"] == 1 and LAUNCHES["frame_features"] == 1,
            f"a batch of {CORPUS_BATCH} rows: one K3 and one K4 launch "
            f"({dict(LAUNCHES)})")
    true_n = torch.from_numpy(bp._true_n(lengths).astype(np.int32)).to(device)
    args = (feats["energy"], feats["zcr"], feats["entropy"],
            bp.initial_states(CORPUS_BATCH))
    # the corpus's program on the same batch: only each row's own frames
    route = 1 + (length - c.frame_size) // c.hop_size

    runs = {"process_batch_masked": lambda: bp.process_batch_masked(batch,
                                                                    lengths),
            "process_batch_masked_pitch":
                lambda: bp.process_batch_masked_pitch(batch, lengths),
            "exact_batch": lambda: bp._exact_batch(batch, lengths, route),
            "exact_batch_pitch": lambda: bp._exact_batch(
                batch, lengths, route, (50.0, 400.0)),
            "k3_on_batch_frames": lambda: pipe._features(frames),
            "vad_batched": lambda: pipe._vad_core(*args, None,
                                                  lengths=true_n),
            "vad_batched_plain": lambda: plain_streaming_vad(
                *args, lengths=true_n, **pipe._vad_kwargs())}
    samples = {k: [] for k in runs}
    for a, b in (("process_batch_masked", "process_batch_masked_pitch"),
                 ("exact_batch", "exact_batch_pitch"),
                 ("k3_on_batch_frames", "vad_batched"),
                 ("vad_batched_plain", "vad_batched")):
        for name in (a, b, b, a):
            samples[name] += time_ms(runs[name])
    out = {k: float(np.median(v)) for k, v in samples.items()}
    audio_s = CORPUS_BATCH * length / SR
    print(f"batch of {CORPUS_BATCH} x {length // SR} s ({f} frames each, "
          f"int16 on the card): median device ms of 10 calls on {card}: "
          + json.dumps(out))
    print(f"process_batch_masked "
          f"{audio_s / out['process_batch_masked'] * 1e3:.1f} audio-s/s of "
          f"padded batch on {card}")
    return out


L1_SECONDS = 600  # the facade's and the resampler's share of the signal
L1_RATES = (48000, 44100)  # file rates resampled to 16 kHz
L1_REPS = 10
INT16_EQUAL = 0.999  # share of resampled samples equal to the host path's


@contextlib.contextmanager
def tf32_switched_on():
    """Both process-wide TF32 switches on, as a caller's
    ``torch.set_float32_matmul_precision("high")`` would leave them: the L1
    ops, the frontend modules and the resampler must scope float32
    themselves."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def resample_by_conv1d(x, up: int, down: int):
    """The resampler's strided correlation spelt as one ``F.conv1d``
    (``stride=down``, ``up`` output channels, the ``(up, 1, W)`` weights) in
    full float32: a yardstick for ``ops.resample._correlate``, which the
    port never calls. ``x`` is a float32 (or float64) ``(B, L)`` batch on
    the card; the weights take its dtype."""
    import torch

    from sspv_tpu_torch.ops import resample
    from sspv_tpu_torch.ops.fp32 import full_fp32

    weights, s_lo, n_pre_remove = resample._polyphase_kernel(up, down)
    w = torch.from_numpy(weights.T.copy()).to(x.device, x.dtype)[:, None, :]
    n_out = resample.resample_output_len(x.shape[1], up, down)
    groups = -(-(n_pre_remove + n_out) // up)
    total = (groups - 1) * down + w.shape[2]
    p = torch.nn.functional.pad(x, (-s_lo, max(0, total + s_lo - x.shape[1])))
    # cuDNN's switch for its own kernels, the matmul setting for the
    # im2col + GEMM path that PyTorch takes for some shapes
    with full_fp32(x), torch.backends.cudnn.flags(allow_tf32=False):
        out = torch.nn.functional.conv1d(p[:, None, :total], w, stride=down)
    flat = out.transpose(1, 2).reshape(x.shape[0], groups * up)
    return flat[:, n_pre_remove : n_pre_remove + n_out]


def int16_parity(label: str, got: np.ndarray, want: np.ndarray) -> None:
    require(got.dtype == np.int16 and got.shape == want.shape,
            f"{label}: int16 of the host path's length")
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    equal = float((diff == 0).mean())
    print(f"{label}: {got.shape[0]} samples, {equal:.6f} equal to the host "
          f"SciPy path, max |diff| {int(diff.max())} LSB")
    require(equal >= INT16_EQUAL and diff.max() <= 1,
            f"{label}: >= 99.9 % equal, none further than one LSB")


def median_ms(fn, reps: int = L1_REPS) -> float:
    return float(np.median(time_ms(fn, reps)))


def l1_runs(device, sig: np.ndarray, pipe400, frames_run, card: str) -> dict:
    """The L1 ops, the facade, the frontend modules and the resampler on
    the card (module docstring, step 9). Returns the times in ms."""
    import torch

    from sspv_tpu_torch import Config, SignalProcessing, models, ops
    from sspv_tpu_torch.ops import LAUNCHES, resample
    from sspv_tpu_torch.ops import frame_kernels as fk
    from sspv_tpu_torch.runtime.audio_source import (FileAudioSource,
                                                     _resample_to)
    from sspv_tpu_torch.signal_processing import on_device
    from sspv_tpu_torch.utils.synth import synth_signal

    reset_launches()
    resample.CALLS["resample"] = 0
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    children = {
        name: subprocess.Popen(
            [sys.executable, "-m", "sspv_tpu_torch." + name], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for name in ("test_system", "demo")
    }
    ms: dict = {}
    with contextlib.ExitStack() as stack:
        for child in children.values():  # no child outlives a failed check
            stack.callback(child.kill)
        stack.enter_context(tf32_switched_on())

        # -- the facade, its device left at the default ----------------------
        require(SignalProcessing.device == "cuda", "the facade's default device")
        head = sig[: L1_SECONDS * SR]

        def facade(frames=None) -> dict:
            if frames is None:
                frames = SignalProcessing.framing(head, ASR_FRAME, HOP)
            return {
                "frames": frames,
                "energy": SignalProcessing.calculate_short_time_energy(frames),
                "zcr": SignalProcessing.calculate_zero_crossing_rate(frames),
                "mfcc": SignalProcessing.compute_mfcc(frames, SR, lifter=22),
                "entropy": SignalProcessing.calculate_spectral_entropy(frames),
            }

        got = facade()
        with on_device("cpu"):
            cpu = facade()
        want = frames_run["oracle"]
        vf = want["energy"].shape[0]
        require(got["frames"].shape == (vf + 1, ASR_FRAME)
                and all(isinstance(v, np.ndarray) for v in got.values()),
                "facade: NumPy out, the padded frame count")
        require(np.array_equal(got["frames"], cpu["frames"])
                and np.array_equal(got["zcr"], cpu["zcr"]),
                "facade: framing and ZCR on the card equal the CPU's")
        vs_cpu = {k: nmse(got[k], cpu[k]) for k in ("energy", "mfcc", "entropy")}
        vs_oracle = {k: nmse(got[k][:vf], want[k])
                     for k in ("energy", "zcr", "mfcc", "entropy")}
        print(f"facade on the card, {vf + 1} frames of {ASR_FRAME}/{HOP}: nmse "
              f"vs the facade on the CPU {json.dumps(vs_cpu)}, vs the oracle "
              f"{json.dumps(vs_oracle)}")
        require(max(vs_cpu.values()) <= NMSE_KERNEL, "facade: card vs CPU")
        require(max(vs_oracle.values()) <= NMSE_ORACLE, "facade: vs the oracle")

        # -- the frontend modules beside K3 ----------------------------------
        sig_t = frames_run["signal"]
        frontend = models.SpeechFrontend(frame_size=ASR_FRAME, hop_size=HOP,
                                         device=device)
        out = frontend.from_signal(sig_t)
        k3 = fk.fused_features(frames_run["frames"], **pipe400._frame_consts)
        n = k3["energy"].shape[0]
        require(out["energy"].shape[0] - n in (0, 1) and out["mfcc"].shape[1] == 13
                and out["mfcc"].device.type == "cuda", "frontend: shapes, on the card")
        vs_k3 = {k: nmse(host(out[k][:n]), host(k3[k]))
                 for k in ("energy", "entropy", "mfcc")}
        a, b = host(out["zcr"][:n]), host(k3["zcr"])
        ulp = bool(np.all(np.abs(a - b) <= np.spacing(np.maximum(a, b))))
        counts = bool(np.array_equal(np.rint(a * ASR_FRAME), np.rint(b * ASR_FRAME)))
        print(f"SpeechFrontend on {n} frames vs K3: nmse {json.dumps(vs_k3)}, "
              f"zcr within one ulp {ulp} (differing on {int((a != b).sum())} "
              f"frames), equal as counts {counts}")
        require(max(vs_k3.values()) <= NMSE_KERNEL, "frontend vs K3")
        require(ulp and counts, "frontend ZCR: one ulp from K3's, equal as counts")
        del out, k3

        # -- three pitch estimators on the hour's raw frames ------------------
        raw = ops.frame_signal(sig_t, 320, 160)
        t_mid = (torch.arange(raw.shape[0], device=device) * 160 + 160) / SR
        seg = (t_mid * 2).long() % 4
        # frames wholly inside a voiced half second
        voiced = (seg == 1) & (((t_mid - 0.01) * 2).long() % 4 == 1) \
            & (((t_mid + 0.01) * 2).long() % 4 == 1)
        estimators = {
            "pitch_direct": lambda: ops.pitch_from_frames(raw, SR, acf_impl="direct"),
            "pitch_dft": lambda: ops.pitch_from_frames(raw, SR, acf_impl="dft"),
            "pitch_amdf": lambda: ops.pitch_from_frames_amdf(raw, SR),
        }
        f0s, peak = {}, {}
        for name, fn in estimators.items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            f0s[name], _ = fn()
            torch.cuda.synchronize()
            peak[name] = (torch.cuda.max_memory_allocated() - base) / 2**20
            median = float(f0s[name][voiced].median())
            print(f"{name}: {raw.shape[0]} frames, {int(voiced.sum())} voiced, "
                  f"median voiced f0 {median:.3f} Hz, peak memory above the "
                  f"frames {peak[name]:.0f} MiB")
            require(abs(median - 130.0) < 5.0, f"{name}: median f0 near 130 Hz")
        same = f0s["pitch_direct"] == f0s["pitch_dft"]
        share = float(same[voiced].float().mean())
        print(f"direct vs dft picks equal on {share:.6f} of the voiced frames, "
              f"{float(same.float().mean()):.6f} of all")
        require(share >= F0_MATCH, "direct and dft ACF pick the same lags")
        del f0s

        # -- the resampler ----------------------------------------------------
        pcm, dev_out = {}, {}
        for rate in L1_RATES:
            pcm[rate] = synth_signal(L1_SECONDS, rate).astype(np.int16)
            t0 = time.perf_counter()
            want16 = _resample_to(pcm[rate], rate, SR)
            ms[f"resample_{rate}_host_scipy"] = (time.perf_counter() - t0) * 1e3
            calls = resample.CALLS["resample"]
            dev_out[rate] = resample.resample_to_rate_device(pcm[rate], rate, SR)
            require(resample.CALLS["resample"] == calls + 1,
                    "the device resampler ran")
            int16_parity(f"resample {rate} -> {SR} on the card", dev_out[rate],
                         want16)
            up, down = SR // math.gcd(SR, rate), rate // math.gcd(SR, rate)
            x = torch.from_numpy(pcm[rate]).to(device).to(torch.float32)[None, :]
            require(nmse(host(resample_by_conv1d(x, up, down)),
                         host(resample._correlate(x, up, down))) <= 1e-12,
                    "the resampler agrees with the conv1d form of its sum")
            del x
        rate = L1_RATES[0]
        with tempfile.TemporaryDirectory() as tmp:
            path = write_wav(Path(tmp) / "l1.wav", pcm[rate], rate)
            before = Config.TPU_DEVICE_RESAMPLE
            Config.TPU_DEVICE_RESAMPLE = True
            try:
                calls = resample.CALLS["resample"]
                src = FileAudioSource(path, sample_rate=SR)
                src.open()
                from_file = src.read(1 << 62)
                src.close()
            finally:
                Config.TPU_DEVICE_RESAMPLE = before
        require(resample.CALLS["resample"] == calls + 1,
                "FileAudioSource resampled on the card")
        require(np.array_equal(from_file, dev_out[rate]),
                "FileAudioSource gives the device resampler's samples")
        print(f"FileAudioSource({rate} Hz file, sample_rate={SR}) with "
              f"TPU_DEVICE_RESAMPLE: device resampler calls "
              f"{resample.CALLS['resample']}, launches {json.dumps(dict(LAUNCHES))}")

        # -- the entry points, each in a process of its own -------------------
        for name, child in children.items():
            text, _ = child.communicate(timeout=300)
            tail = " | ".join(text.strip().splitlines()[-2:])
            print(f"python -m sspv_tpu_torch.{name}: exit {child.returncode}: {tail}")
            require(child.returncode == 0, f"{name} exits 0 on the card")

        # -- times: CUDA events, medians of L1_REPS, nothing else on the card --
        frames400 = got["frames"]
        ms.update({
            "facade_framing": median_ms(
                lambda: SignalProcessing.framing(head, ASR_FRAME, HOP)),
            "facade_energy": median_ms(
                lambda: SignalProcessing.calculate_short_time_energy(frames400)),
            "facade_zcr": median_ms(
                lambda: SignalProcessing.calculate_zero_crossing_rate(frames400)),
            "facade_mfcc": median_ms(
                lambda: SignalProcessing.compute_mfcc(frames400, SR, lifter=22)),
            "facade_entropy": median_ms(
                lambda: SignalProcessing.calculate_spectral_entropy(frames400)),
            "frontend_from_signal": median_ms(lambda: frontend.from_signal(sig_t)),
        })
        for name, fn in estimators.items():
            ms[name] = median_ms(fn)
            ms[name + "_peak_mib"] = peak[name]
        for rate in L1_RATES:
            up, down = SR // math.gcd(SR, rate), rate // math.gcd(SR, rate)
            x = torch.from_numpy(pcm[rate]).to(device).to(torch.float32)[None, :]
            ms[f"resample_{rate}_matmul"] = median_ms(
                lambda: resample._correlate(x, up, down))
            ms[f"resample_{rate}_conv"] = median_ms(
                lambda: resample_by_conv1d(x, up, down))
            ms[f"resample_{rate}_to_rate_device"] = median_ms(
                lambda: resample.resample_to_rate_device(pcm[rate], rate, SR))
            del x
    print(f"L1 ms on {card} (medians of {L1_REPS}, CUDA events; facade and "
          f"resample_*_to_rate_device from host arrays, transfers included; "
          f"frontend and pitch on the hour, device-resident; resample_*_matmul "
          f"is the port's correlation, resample_*_conv the conv1d yardstick "
          f"the port never calls; *_host_scipy one call on the host clock): "
          + json.dumps(ms))
    return ms


SERVE_SECONDS = 60  # the size of a request users send
SERVE_LONG_SECONDS = 600  # the 44.1 kHz stereo file, the stream and main
SERVE_LONG_RATE = 44100
SERVE_CLIENTS = (1, 4, 8)
SERVE_REQUESTS = 4  # per client in each concurrency run
SERVE_REPS = 3  # of each long request, for its latency
STREAM_PIECE_SECONDS = 0.1  # the stream's client chunks


def http_request(port: int, method: str, path: str, body: bytes = b"",
                 headers: dict | None = None) -> tuple:
    """One request to the local server: ``(status, content type, body,
    host seconds)``."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        return (resp.status, resp.getheader("Content-Type"), data,
                time.perf_counter() - t0)
    finally:
        conn.close()


def stream_request(port: int, path: str, pcm: np.ndarray, piece: int) -> tuple:
    """``pcm`` sent chunked in ``piece``-sample chunks while the NDJSON rows
    are read back: ``(status, rows, host seconds)``. The request goes out
    on a socket of its own: ``http.client.HTTPConnection`` drops its socket
    as soon as a ``Connection: close`` response begins, and would send the
    rest of the audio on a new connection."""
    import http.client
    import socket
    import threading

    data = pcm.astype("<i2").tobytes()
    failed = []
    sock = socket.create_connection(("127.0.0.1", port), timeout=600)

    def send_all():
        try:
            for lo in range(0, len(data), 2 * piece):
                part = data[lo : lo + 2 * piece]
                sock.sendall(b"%x\r\n" % len(part) + part + b"\r\n")
            sock.sendall(b"0\r\n\r\n")
        except OSError as e:
            failed.append(e)

    sender = threading.Thread(target=send_all, daemon=True)
    try:
        t0 = time.perf_counter()
        sock.sendall(f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                     "Content-Type: application/octet-stream\r\n"
                     "Transfer-Encoding: chunked\r\n\r\n".encode())
        sender.start()
        resp = http.client.HTTPResponse(sock, method="POST")
        resp.begin()  # rows come back while audio is still being sent
        rows = [json.loads(x) for x in resp.read().splitlines() if x.strip()]
        seconds = time.perf_counter() - t0
        sender.join(timeout=600)
        resp.close()
    finally:
        sock.close()
    require(not sender.is_alive() and not failed, f"stream upload: {failed}")
    return resp.status, rows, seconds


def coalesced(pcm: np.ndarray, piece: int, min_bytes: int) -> list:
    """The chunks the server dispatches for ``pcm`` sent in ``piece``-sample
    chunks: ``_Handler._do_stream`` joins them until ``min_bytes``."""
    out, buf = [], bytearray()
    for lo in range(0, len(pcm), piece):
        buf += pcm[lo : lo + piece].astype("<i2").tobytes()
        if len(buf) >= min_bytes:
            out.append(np.frombuffer(bytes(buf), "<i2"))
            buf.clear()
    if buf:
        out.append(np.frombuffer(bytes(buf), "<i2"))
    return out


BLOCK_FIELDS = ("energy", "zcr", "entropy", "mfcc", "vad", "vad_adaptive")


def block_fields(block) -> dict:
    return {k: host(getattr(block, k)) for k in BLOCK_FIELDS}


def equal_fields(got: dict, want: dict) -> list:
    """Keys of ``want`` whose value ``got`` does not hold bit for bit (JSON
    floats carry float32 values exactly)."""
    return [k for k, v in want.items()
            if not np.array_equal(np.asarray(got[k]), np.asarray(v))]


def serve_runs(device, sig: np.ndarray, err: dict, card: str) -> dict:
    """``serve.make_server`` over ``FeatureService(device)`` on a thread,
    warmed up, driven through HTTP at the sizes users send; every 200
    response held bit for bit to the pipeline called directly on the same
    samples, and each request's launches to the direct call's."""
    import threading

    import torch

    from sspv_tpu_torch.config import Config, parse_buckets
    from sspv_tpu_torch.ops import LAUNCHES, resample
    from sspv_tpu_torch.ops import pipeline as pipeline_mod
    from sspv_tpu_torch.ops import pitch as pitch_mod
    from sspv_tpu_torch.runtime.audio_source import _resample_to
    from sspv_tpu_torch.serve import FeatureService, decode_audio, make_server
    from sspv_tpu_torch.utils.synth import synth_signal

    out = {"latency": {}}
    pcm = np.clip(sig, -32768, 32767).astype(np.int16)
    svc = FeatureService(device=device)
    pipe = svc.pipe
    server = make_server("127.0.0.1", 0, svc)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    saved_resample = Config.TPU_DEVICE_RESAMPLE
    try:
        t0 = time.perf_counter()
        svc.warmup()
        out["warmup_s"] = time.perf_counter() - t0

        status, ctype, body, _ = http_request(port, "GET", "/healthz")
        health = json.loads(body)
        print(f"serve /healthz: {status} {json.dumps(health)}")
        require(status == 200 and health == {
            "status": "ok", "backend": "cuda",
            "device_count": torch.cuda.device_count()}, "/healthz on the card")

        served = {"card": 0, "audio": 0, "audio_s": 0.0}

        def post(path, body, headers=None):
            sync(device)
            reset_launches()
            with frames_on_card() as on_card:
                status, rtype, data, seconds = http_request(
                    port, "POST", path, body,
                    headers or {"Content-Type": "audio/wav"})
            served["card"] += on_card["frames"]
            return status, rtype, data, seconds, dict(LAUNCHES)

        def direct(samples, pitch):
            sync(device)
            reset_launches()
            if pitch:
                block, _, f0, conf = pipe.process_signal_pitch_auto(samples)
                want = dict(block_fields(block), f0=f0, pitch_confidence=conf)
            else:
                want = block_fields(pipe.process_signal_auto(samples)[0])
            sync(device)
            return want, dict(LAUNCHES)

        def check(label, path, status, rtype, data, launches, samples,
                  pitch, want_launches):
            require(status == 200, f"{label}: status {status}")
            res = (json.loads(data) if rtype == "application/json"
                   else dict(np.load(io.BytesIO(data))))
            want, direct_launches = direct(samples, pitch)
            vad = ("vad", "vad_adaptive")
            keys = {"/v1/vad": vad, "/v1/pitch": vad + (
                "f0", "pitch_confidence")}.get(path, BLOCK_FIELDS)
            bad = equal_fields(res, {k: want[k] for k in keys})
            require(int(res["num_frames"]) == len(want["vad"]) and not bad,
                    f"{label}: response equals the direct call (not {bad})")
            served["audio"] += int(res["num_frames"])
            served["audio_s"] += len(samples) / SR
            require(launches == direct_launches == want_launches,
                    f"{label}: launches {launches}, direct {direct_launches}")

        # -- 60 s requests, one slice of the hour per client ----------------
        n60 = SERVE_SECONDS * SR
        slices = [pcm[i * n60 : (i + 1) * n60] for i in range(max(SERVE_CLIENTS))]
        wavs = [wav_bytes(s) for s in slices]
        k1 = {"view_features": 1, "view_pitch": 0, "frame_features": 0,
              "vad": 1, "resample": 0}
        k12 = dict(k1, view_pitch=1)
        routes = {"/v1/features": (False, k1), "/v1/vad": (False, k1),
                  "/v1/pitch": (True, k12)}
        serial = {}
        for path, (pitch, want_launches) in routes.items():
            label = f"{path} {SERVE_SECONDS} s"
            out["latency"][label] = []
            for i, (samples, wav) in enumerate(zip(slices, wavs)):
                with recording([(pipeline_mod, "fused_view_features")]) \
                        as feat_calls, recording(
                            [(pitch_mod, "fused_view_pitch")]) as pitch_calls:
                    status, rtype, data, seconds, launches = post(path, wav)
                out["latency"][label].append(seconds)
                check(label, path, status, rtype, data, launches, samples,
                      pitch, want_launches)
                serial[path, i] = data
                if i == 0 and path != "/v1/vad":  # the kernels on its inputs
                    calls_parity("view_features", feat_calls, err,
                                 f"serve {label}")
                    if pitch:
                        calls_parity("view_pitch", pitch_calls, err,
                                     f"serve {label}")
        print(f"serve {SERVE_SECONDS} s: {len(slices)} requests per route, "
              "each equal to the direct call bit for bit, with its launches")
        out["breakdown"] = request_breakdown(svc, slices[0], wavs[0], card)

        # -- 600 s at 44.1 kHz stereo: decode, downmix, resample ------------
        mono = synth_signal(SERVE_LONG_SECONDS, SERVE_LONG_RATE).astype(np.int16)
        stereo = np.stack([mono, np.roll(mono, SERVE_LONG_RATE // 10)], axis=1)
        body = wav_bytes(stereo, SERVE_LONG_RATE, channels=2)
        samples, rate = decode_audio(body, "audio/wav")
        for on in (False, True):
            Config.TPU_DEVICE_RESAMPLE = on
            sig16 = _resample_to(samples, rate, SR, device=device)
            label = (f"/v1/features?fmt=npz {SERVE_LONG_SECONDS} s 44.1 kHz "
                     f"stereo, resample on the {'card' if on else 'host'}")
            out["latency"][label] = []
            for _ in range(SERVE_REPS):
                calls = resample.CALLS["resample"]
                status, rtype, data, seconds, launches = post(
                    "/v1/features?fmt=npz", body)
                require(resample.CALLS["resample"] == calls + int(on),
                        f"{label}: the resampler ran where asked")
                out["latency"][label].append(seconds)
                check(label, "/v1/features", status, rtype, data, launches,
                      sig16, False, k1)
        Config.TPU_DEVICE_RESAMPLE = saved_resample
        print(f"serve {SERVE_LONG_SECONDS} s 44.1 kHz stereo: equal to the "
              "direct call with the host and with the device resampler")

        # -- the duration cap: 2,048 s as npz, one second more is 413 -------
        cap = pipe.SIGNAL_BUCKET_SECONDS[-1]
        at_cap = pcm[: cap * SR]
        require(len(at_cap) == cap * SR, "the signal covers the cap")
        body = wav_bytes(at_cap)
        label = f"/v1/features?fmt=npz {cap} s"
        out["latency"][label] = []
        for _ in range(SERVE_REPS):
            status, rtype, data, seconds, launches = post(
                "/v1/features?fmt=npz", body)
            out["latency"][label].append(seconds)
            check(label, "/v1/features", status, rtype, data, launches,
                  at_cap, False, k1)
        audio_on_card("serve requests (60 s, 600 s, the cap)",
                      served["card"], served["audio"], served["audio_s"])
        over = np.zeros(((cap + 1) * SR,), np.int16).tobytes()
        status, _, data, _, launches = post("/v1/features", over, {
            "Content-Type": "application/octet-stream", "X-Sample-Rate": str(SR)})
        print(f"serve {cap + 1} s: {status} {data.decode()[:120]}")
        require(status == 413 and b"sspv_tpu_torch.batch" in data
                and not any(launches.values()), f"{cap + 1} s gives 413")

        # -- the stream: 600 s sent in 100 ms chunks, pitch and MFCC --------
        head = pcm[: SERVE_LONG_SECONDS * SR]
        piece = int(STREAM_PIECE_SECONDS * SR)
        c = pipe.cfg
        first = parse_buckets(Config.TPU_STREAM_BUCKETS)[0]
        chunks = coalesced(head, piece, 2 * ((first - 1) * c.hop_size
                                             + c.frame_size))
        sync(device)
        reset_launches()
        with frames_on_card() as on_card:
            status, rows, stream_s = stream_request(
                port, "/v1/stream?pitch=1&mfcc=1", head, piece)
        launches = dict(LAUNCHES)
        reset_launches()
        t0 = time.perf_counter()
        want = list(pipe.stream_pitch(iter(chunks), min_confidence=0.3))
        sync(device)
        out["stream_direct_s"] = time.perf_counter() - t0
        direct_launches = dict(LAUNCHES)
        require(status == 200 and rows[-1] == {"done": True,
                                              "blocks": len(want)},
                f"stream: status {status}, last row {rows[-1]}")
        bad = [i for i, (row, (block, f0, conf)) in enumerate(zip(rows, want))
               if equal_fields(row, dict(block_fields(block), f0=f0,
                                         pitch_confidence=conf))]
        frames = sum(r["frames"] for r in rows[:-1])
        print(f"serve stream {SERVE_LONG_SECONDS} s in {len(head) // piece} "
              f"chunks of {piece}: {len(want)} blocks, {frames} frames, "
              f"launches {json.dumps(launches)} (direct "
              f"{json.dumps(direct_launches)}), rows unequal: {bad[:5]}")
        require(not bad and frames == 1 + (len(head) - c.frame_size)
                // c.hop_size, "stream rows equal stream_pitch bit for bit")
        audio_on_card("serve stream", on_card["frames"], frames,
                      len(head) / SR)
        require(launches == direct_launches and launches == {
            "view_features": 0, "view_pitch": 0,
            "frame_features": len(want), "vad": len(want), "resample": 0},
            "stream: one K3 and one K4 launch per dispatch")
        out["stream_audio_s_per_s"] = SERVE_LONG_SECONDS / stream_s

        # -- concurrent clients, /v1/features and /v1/pitch mixed -----------
        out["audio_s_per_s"] = {}
        for clients in SERVE_CLIENTS:
            got, lat = {}, []
            paths = {(i, j): "/v1/features" if (i + j) % 2 == 0 else "/v1/pitch"
                     for i in range(clients) for j in range(SERVE_REQUESTS)}

            def client(i):
                for j in range(SERVE_REQUESTS):
                    got[i, j] = http_request(port, "POST", paths[i, j], wavs[i],
                                             {"Content-Type": "audio/wav"})

            workers = [threading.Thread(target=client, args=(i,))
                       for i in range(clients)]
            sync(device)
            reset_launches()
            t0 = time.perf_counter()
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=600)
            wall = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            require(not any(w.is_alive() for w in workers) and len(got) == len(
                paths), f"{clients} clients: every request answered")
            same = all(got[key][0] == 200 and got[key][2] == serial[
                paths[key], key[0]] for key in paths)
            n_pitch = sum(p == "/v1/pitch" for p in paths.values())
            lat = [r[3] for r in got.values()]
            out["latency"][f"mixed {SERVE_SECONDS} s, {clients} clients"] = lat
            out["audio_s_per_s"][clients] = len(paths) * SERVE_SECONDS / wall
            print(f"serve {clients} client(s) x {SERVE_REQUESTS} requests of "
                  f"{SERVE_SECONDS} s: responses equal the serial ones {same},"
                  f" launches {json.dumps(launches)}")
            require(same, f"{clients} clients: responses equal the serial ones")
            require(launches == {"view_features": len(paths),
                                 "view_pitch": n_pitch, "frame_features": 0,
                                 "vad": len(paths), "resample": 0},
                    f"{clients} clients: the launch counts add up")
    finally:
        Config.TPU_DEVICE_RESAMPLE = saved_resample
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    print(f"serve warm-up (first requests; the kernels were built at the "
          f"start) {out['warmup_s']:.3f} s on {card}")
    print(f"serve latency p50 / p95 s and requests (host clock, client in "
          f"the same process) on {card}: " + json.dumps({
              k: [float(np.percentile(v, 50)), float(np.percentile(v, 95)),
                  len(v)] for k, v in out["latency"].items()}))
    print(f"serve audio-s/s by clients (host clock, {SERVE_SECONDS} s "
          f"requests, features and pitch mixed) on {card}: "
          + json.dumps(out["audio_s_per_s"]))
    print(f"serve stream {out['stream_audio_s_per_s']:.1f} audio-s/s (host "
          f"clock, {SERVE_LONG_SECONDS} s, pitch and MFCC; stream_pitch "
          f"called directly on the same chunks: {out['stream_direct_s']:.3f} s)"
          f" on {card}")
    return out


def request_breakdown(svc, samples: np.ndarray, wav: bytes, card: str) -> dict:
    """Where one ``/v1/features`` request's time goes: its host stages
    (host clock, medians of 5 warm calls) and the card's busy time inside
    ``analyze`` (``torch.profiler``, the sum of the device events)."""
    import torch

    from sspv_tpu_torch.serve import (_FEATURE_KEYS, _jsonify, _select,
                                      decode_audio)

    device, pipe = svc.pipe.device, svc.pipe

    def med(fn, reps=5):
        seconds = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            sync(device)
            seconds.append(time.perf_counter() - t0)
        return float(np.median(seconds))

    selected = _select(svc.analyze(samples, SR), _FEATURE_KEYS)
    ms = {k: 1e3 * v for k, v in {
        "decode": med(lambda: decode_audio(wav, "audio/wav")),
        "analyze": med(lambda: svc.analyze(samples, SR)),
        "analyze_exact_length": med(lambda: block_fields(
            pipe.process_signal_device(samples)[0])),
        "json": med(lambda: json.dumps(
            {k: _jsonify(v) for k, v in selected.items()})),
        "npz": med(lambda: np.savez_compressed(io.BytesIO(), **selected)),
    }.items()}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        svc.analyze(samples, SR)
        sync(device)
    busy_us = sum(getattr(e, "self_device_time_total", 0) or 0
                  for e in prof.key_averages())
    ms["analyze_device_busy"] = busy_us / 1e3 if busy_us else None
    print(f"serve {len(samples) / SR:.0f} s /v1/features, where a request's "
          f"time goes, ms (host clock, medians of 5; analyze: upload, the "
          f"device call at the signal's own length and one read-back per "
          f"field; analyze_exact_length: process_signal_device alone on the "
          f"same samples; analyze_device_busy: the card's own time in one "
          f"analyze, torch.profiler, None if it saw none) on {card}: "
          + json.dumps(ms))
    return ms


def main_runs(device, sig: np.ndarray, engine: dict, card: str) -> dict:
    """``sspv_tpu_torch.main.main`` in this process over a WAV of the
    engine phase's audio, headless, to the end of the file: one K1 launch
    per engine dispatch, the frames the engine phase's samples-mode run
    gave, and a ``save_data`` file that ``validate_session`` accepts."""
    import sspv_tpu_torch.ui as ui_pkg
    from sspv_tpu_torch import main as main_mod
    from sspv_tpu_torch.config import Config
    from sspv_tpu_torch.ops import LAUNCHES
    from sspv_tpu_torch.utils.npz_io import load_session, validate_session

    sig16 = np.clip(sig[: ENGINE_SECONDS * SR], -32768, 32767).astype(np.int16)
    n = 1 + (len(sig16) - 320) // 160
    seen = {}

    class Recorded(ui_pkg.VisualizationUI):
        def __init__(self, runtime, **kwargs):
            seen["runtime"], seen["kwargs"] = runtime, kwargs
            super().__init__(runtime, **kwargs)

    knobs = ("PROCESSED_DATA_BUFFER_SIZE", "TPU_STREAM_SAMPLES_DISPATCH",
             "TPU_ENGINE_PITCH")
    saved = {k: getattr(Config, k) for k in knobs}
    env_keys = ("RTP_INPUT_FILE", "RTP_HEADLESS", "RTP_SNAPSHOT")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ.update(RTP_INPUT_FILE=write_wav(Path(tmp) / "main.wav", sig16),
                          RTP_HEADLESS="1",
                          RTP_SNAPSHOT=str(Path(tmp) / "snapshot.png"))
        Config.PROCESSED_DATA_BUFFER_SIZE = n
        Config.TPU_STREAM_SAMPLES_DISPATCH = 1
        Config.TPU_ENGINE_PITCH = False
        original, ui_pkg.VisualizationUI = ui_pkg.VisualizationUI, Recorded
        try:
            sync(device)
            reset_launches()
            t0 = time.perf_counter()
            main_mod.main(["--device", device.type])
            seconds = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            rt = seen["runtime"]
            session = load_session(rt.save_data(tmp))
        finally:
            ui_pkg.VisualizationUI = original
            for k, v in saved.items():
                setattr(Config, k, v)
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    problems = validate_session(session)
    print(f"python -m sspv_tpu_torch.main --device {device.type} (headless, "
          f"{ENGINE_SECONDS} s WAV): {rt.frames_processed} frames in "
          f"{rt.dispatch_count} dispatches, {seconds:.3f} s, launches "
          f"{json.dumps(launches)}, snapshot {seen['kwargs']}, "
          f"validate_session {problems}")
    # with no RTP_DURATION the headless loop ends only when the engine
    # stops itself at the end of its source (or fails)
    require(rt.last_error is None and not rt.is_running
            and rt.frames_processed == n,
            "main: the engine ran to the end of the file")
    require(launches["view_features"] == rt.dispatch_count > 0
            and launches["view_pitch"] == launches["frame_features"] == 0,
            "main: one K1 launch per engine dispatch")
    require(launches["vad"] == rt.dispatch_count,
            "main: one K4 launch per engine dispatch")
    require(problems == [] and session.num_frames == n, "main: save_data")
    ref = list(engine["view_features"]["rt"].processed_data)
    same = all(np.array_equal(getattr(session, k), np.array(
        [d[key] for d in ref], getattr(session, k).dtype)) for k, key in
        (("energies", "energy"), ("zcrs", "zcr"), ("vads", "vad"),
         ("spec_entropy", "spec_entropy"), ("vads_adaptive", "vad_adaptive")))
    print(f"main: frames equal the engine phase's samples-mode run {same}; "
          f"{ENGINE_SECONDS / seconds:.1f} audio-s/s (host clock, UI poll "
          f"loop included) on {card}")
    require(same, "main: frames equal the engine phase's")
    return {"seconds": seconds, "launches": launches}


# examples_runs: the port's example harnesses and tools, each through its
# module's own function, at the default FeatureConfig (320/160, a 512-point
# FFT, 26 mel filters, 13 cepstra).
LATENCY_SECONDS, LATENCY_WARMUP, LATENCY_CHUNK = 20, 5, 1024
FLOOD_STREAMS, FLOOD_SECONDS = 8, 120
PACED_STREAMS, PACED_SECONDS = 4, 20
BENCH_CLIENTS = (1, 4, 8)
BENCH_SECONDS = 60  # audio per request
BENCH_REQUESTS = 4  # per client at each level
VAD_EVAL_SECONDS = 60  # per condition, the harness's full protocol
SOAK_SECONDS = 90  # logged every 5 s
PROBE_LONG_SECONDS = 14_400
PROBE_LONGEST_SECONDS = 57_600  # only where the host synthesizes fast
PROBE_SYNTH_LIMIT_S = 10.0  # ... i.e. 14,400 s in at most this
FUZZ_VAD, FUZZ_GEOMETRIES = 60, 20
SAMPLE_DIR = ROOT / "examples" / "sample_outputs"  # TPU-made, committed
NMSE_SAMPLES = 1e-5


def captured(fn, *args, echo: bool = True):
    """``fn(*args)`` with its standard output caught (and printed unless
    ``echo`` is false): ``(return value, output)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args)
    if echo:
        print(buf.getvalue(), end="")
    return ret, buf.getvalue()


def launches_now() -> dict:
    from sspv_tpu_torch.ops import LAUNCHES, ROUTES

    return dict(LAUNCHES, **ROUTES)


def engine_frames(rt) -> dict:
    """The frames an engine published, as arrays."""
    rows = list(rt.processed_data)
    out = {k: np.array([d[k] for d in rows], np.float32)
           for k in ("energy", "zcr", "mfcc")}
    out["entropy"] = np.array([d["spec_entropy"] for d in rows], np.float32)
    out.update((k, np.array([d[k] for d in rows], np.int32))
               for k in ("vad", "vad_adaptive"))
    return out


def frames_against_cpu(label: str, got: dict, sig16: np.ndarray,
                       cpu_pipe) -> None:
    """Frames against ``process_signal`` of the same samples on the CPU
    (the plain versions): zcr and VAD equal, the rest NMSE <= 1e-9."""
    want, _ = cpu_pipe.process_signal(sig16)
    equal = all(np.array_equal(got[k], host(getattr(want, k)))
                for k in ("zcr", "vad", "vad_adaptive"))
    e = {k: nmse(got[k], host(getattr(want, k)))
         for k in ("energy", "entropy", "mfcc")}
    require(got["vad"].shape[0] == want.vad.shape[0],
            f"{label}: {got['vad'].shape[0]} frames of {want.vad.shape[0]}")
    require(equal, f"{label}: zcr and VAD equal the CPU process_signal")
    require(max(e.values()) <= NMSE_KERNEL, f"{label}: nmse {e}")


def latency_runs(device, card: str) -> dict:
    """``latency_bench.run_once`` in both modes: every frame published, one
    K1 launch per dispatch and per bucket it warms."""
    from sspv_tpu_torch.examples import latency_bench

    out = {}
    for mode in ("default", "ll"):
        sync(device)
        reset_launches()
        r = latency_bench.run_once(mode, LATENCY_CHUNK, LATENCY_SECONDS,
                                   LATENCY_WARMUP, device)
        launches = launches_now()
        print(json.dumps(r))
        print(f"latency_bench --mode {mode}: median {r['median_ms']} ms, p90 "
              f"{r['p90_ms']} ms, max {r['max_ms']} ms over {r['frames']} "
              f"frames ({LATENCY_SECONDS} s paced in {LATENCY_CHUNK}-sample "
              f"chunks, first {LATENCY_WARMUP} s dropped; host clock) on "
              f"{card}; launches {json.dumps(launches)}")
        require(r["frames_published"] == r["frames_expected"],
                f"latency {mode}: every frame published")
        require(r["samples_dispatch"] and launches["view_features"]
                == r["dispatches"] + len(r["buckets"]),
                f"latency {mode}: one K1 launch per dispatch and warmed bucket")
        out[mode] = r
    return out


def multistream_runs(device, card: str) -> dict:
    """Flood and paced ``multistream_bench`` runs over ONE shared pipeline;
    every stream's frames held to the CPU ``process_signal`` of its own
    signal."""
    from sspv_tpu_torch import FeaturePipeline
    from sspv_tpu_torch.config import Config
    from sspv_tpu_torch.examples import multistream_bench
    from sspv_tpu_torch.examples._sources import speech_signal

    cpu_pipe = FeaturePipeline(device="cpu")
    saved = Config.PROCESSED_DATA_BUFFER_SIZE
    Config.PROCESSED_DATA_BUFFER_SIZE = 1 + (FLOOD_SECONDS * SR - 320) // 160
    out = {}
    try:
        for name, run, n, seconds in (
                ("flood", multistream_bench.run_flood, FLOOD_STREAMS,
                 FLOOD_SECONDS),
                ("paced", multistream_bench.run_paced, PACED_STREAMS,
                 PACED_SECONDS)):
            sync(device)
            reset_launches()
            r, engines = run(n, seconds, device)
            print(json.dumps(r))
            require(r["k1_launches"] == r["total_dispatches"] > 0,
                    f"multistream {name}: one K1 launch per dispatch")
            if name == "paced":
                require(r["all_frames_after_drain"],
                        "multistream paced: all frames after the drain")
            for i, rt in enumerate(engines):
                sig16 = speech_signal(seconds, SR, seed=i, tone_hz=120 + 40 * i)
                frames_against_cpu(f"multistream {name} stream {i}",
                                   engine_frames(rt), sig16, cpu_pipe)
            print(f"multistream {name}: {n} streams x {seconds} s, each "
                  "stream's frames equal the CPU process_signal of its own "
                  "signal (zcr and VAD exactly, the rest NMSE <= 1e-9) on "
                  f"{card}")
            out[name] = r
    finally:
        Config.PROCESSED_DATA_BUFFER_SIZE = saved
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_bench_runs(device, tmp: Path, card: str) -> dict:
    """``serve_bench`` against ``python -m sspv_tpu_torch.serve`` in its own
    process (``--url``) in JSON and npz, then once in this process."""
    import signal
    import urllib.request

    from sspv_tpu_torch.examples import serve_bench

    port = free_port()
    url = f"http://127.0.0.1:{port}"
    env = dict(os.environ, PYTHONPATH=str(ROOT), RTP_SERVE_PORT=str(port))
    results = {}
    with open(tmp / "serve.log", "w") as log:
        server = subprocess.Popen(
            [sys.executable, "-m", "sspv_tpu_torch.serve", "--device",
             device.type],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            t0 = time.perf_counter()
            while True:
                require(server.poll() is None, "the serve process is up")
                try:
                    with urllib.request.urlopen(url + "/healthz", timeout=5):
                        break
                except OSError:
                    require(time.perf_counter() - t0 < 180,
                            "the serve process answers /healthz")
                    time.sleep(0.2)
            print(f"python -m sspv_tpu_torch.serve --device {device.type}: "
                  "answering "
                  f"in {time.perf_counter() - t0:.1f} s (start, kernel load, "
                  "warm-up)")
            for fmt in ("json", "npz"):
                results["external", fmt] = serve_bench.run(
                    BENCH_CLIENTS, BENCH_SECONDS, BENCH_REQUESTS,
                    fmt=fmt, url=url)
        finally:
            server.send_signal(signal.SIGTERM)
            try:
                rc = server.wait(timeout=60)
            except subprocess.TimeoutExpired:
                server.kill()
                rc = server.wait()
    require(rc == 0, f"the serve process drained and exited 0 (rc {rc}): "
            + (tmp / "serve.log").read_text()[-2000:])
    sync(device)
    reset_launches()
    access_log = logging.getLogger("sspv_tpu_torch.serve")
    level = access_log.level
    access_log.setLevel(logging.WARNING)  # one line per request otherwise
    try:
        for fmt in ("json", "npz"):
            results["in-process", fmt] = serve_bench.run(
                BENCH_CLIENTS, BENCH_SECONDS, BENCH_REQUESTS, fmt=fmt,
                device=device)
    finally:
        access_log.setLevel(level)
    launches = launches_now()
    requests = 1 + sum(BENCH_CLIENTS) * BENCH_REQUESTS  # the warm-up too
    print(f"serve_bench in-process launches: {json.dumps(launches)}")
    require(launches["view_features"] == 2 * requests
            and launches["view_pitch"] == launches["frame_features"] == 0,
            "serve_bench in-process: one K1 launch per request")
    for (where, fmt), lines in results.items():
        for r in lines:
            print(json.dumps(dict(r, server=where)))
            require(r["errors"] == [] and r["backend"] == device.type
                    and r["requests"] == r["clients"] * BENCH_REQUESTS,
                    f"serve_bench {where} {fmt} at {r['clients']} clients")
    print(f"serve_bench, {BENCH_SECONDS} s per /v1/features request "
          f"(server / fmt / clients: p50 ms, p90 ms, audio-s/s; host clock) "
          f"on {card}: " + json.dumps({
              f"{where} {fmt} {r['clients']}": [r["p50_ms"], r["p90_ms"],
                                                r["audio_s_per_s"]]
              for (where, fmt), lines in results.items() for r in lines}))
    return results


def vad_eval_runs(device, card: str) -> list:
    """``vad_eval.evaluate``: 2 proxies x 7 conditions, each with the two
    variant pipelines; the reference mode equal to ``EngineVadOracle`` on
    every frame, in the composite and in the adaptive gate alone."""
    from sspv_tpu_torch.examples import vad_eval

    sync(device)
    reset_launches()
    lines = list(vad_eval.evaluate(VAD_EVAL_SECONDS, device))
    launches = launches_now()
    for r in lines:
        print(json.dumps(r))
    ref = [r for r in lines if r["mode"] == "reference"]
    runs = len(vad_eval.PROXIES) * len(vad_eval.CONDITIONS)
    print(f"vad_eval ({VAD_EVAL_SECONDS} s per condition; accuracy / recall "
          f"/ precision / F1 of the reference mode, F1 of each variant) on "
          f"{card}:")
    for r in ref:
        alt = {x["mode"]: x["f1"] for x in lines if x["mode"] != "reference"
               and (x["proxy"], x["condition"]) == (r["proxy"], r["condition"])}
        print(f"  {r['proxy']:8s} {r['condition']:12s} {r['accuracy']:5.1f} "
              f"{r['recall']:5.1f} {r['precision']:5.1f} {r['f1']:5.1f}  "
              f"oracle {r['oracle_match_pct']} / "
              f"{r['oracle_adaptive_match_pct']}  " + json.dumps(alt))
    print("vad_eval launches: " + json.dumps(launches))
    require(len(ref) == runs and len(lines) == 3 * runs,
            "vad_eval: every proxy, condition and variant")
    require(all(r["oracle_match_pct"] == 100.0
                and r["oracle_adaptive_match_pct"] == 100.0 for r in ref),
            "vad_eval: decisions and adaptive decisions equal "
            "EngineVadOracle's in every condition")
    require(launches["view_features"] == 3 * runs,
            "vad_eval: one K1 launch per pipeline call")
    return lines


def process_files_runs(device, sig: np.ndarray, tmp: Path, card: str) -> None:
    """``process_files.main`` over the corpus of ``corpus_runs``: each npz
    equal to ``process_signal_auto`` and ``pitch_signal_auto`` of its file."""
    from sspv_tpu_torch import FeatureConfig, FeaturePipeline
    from sspv_tpu_torch.config import Config
    from sspv_tpu_torch.examples import process_files

    folder, out_dir = tmp / "corpus", tmp / "features"
    folder.mkdir()
    files = corpus_files(sig, folder)
    sync(device)
    reset_launches()
    rc, text = captured(process_files.main, [str(folder), str(out_dir),
                                             "--device", device.type],
                        echo=False)
    launches = launches_now()
    print(text.splitlines()[-1] + f"; launches {json.dumps(launches)}")
    require(rc == 0 and text.count(".features.npz") == len(files),
            "process_files: one npz per file")
    require(launches["view_pitch"] == len(files),
            "process_files: one K2 launch per file")
    pipe = FeaturePipeline(FeatureConfig.from_config(Config), device=device)
    worst, equal, bits, f0_same, frames = 0.0, True, True, 0, 0
    for path in files:
        pcm = process_files._decode(path, SR)
        block, _ = pipe.process_signal_auto(pcm)
        block = type(block)(*(host(x) for x in block))
        f0, _ = pipe.pitch_signal_auto(pcm, block.vad)
        name = Path(path).stem
        with np.load(out_dir / f"{name}.features.npz") as z:
            got = {"energy": z["energies"], "zcr": z["zcrs"], "vad": z["vads"],
                   "entropy": z["spec_entropy"], "mfcc": z["mfcc"],
                   "vad_adaptive": z["vads_adaptive"], "f0": z["f0"]}
        want = dict(block._asdict(), f0=f0)
        require(got["vad"].shape == want["vad"].shape, f"frames of {name}")
        equal &= all(np.array_equal(got[k], want[k].astype(got[k].dtype))
                     for k in ("zcr", "vad", "vad_adaptive"))
        bits &= all(np.array_equal(got[k], want[k].astype(got[k].dtype))
                    for k in got)
        worst = max(worst, *(nmse(got[k], want[k])
                             for k in ("energy", "entropy", "mfcc")))
        f0_same += int(np.sum(got["f0"] == want["f0"]))
        frames += want["vad"].shape[0]
    print(f"process_files vs process_signal_auto / pitch_signal_auto on the "
          f"card ({len(files)} files, {frames} frames): zcr and VAD equal "
          f"{equal}, max nmse {worst}, f0 match {f0_same / frames}, every "
          f"field bit-equal {bits}")
    require(equal and worst <= NMSE_KERNEL and f0_same / frames >= F0_MATCH,
            "process_files: every npz equals the single-file entry points")


def generate_samples_runs(device, tmp: Path, card: str) -> None:
    """``generate_samples.generate`` into a temporary folder, held to the
    five committed TPU-made samples: the same keys and frame counts, the
    VAD fields equal, the float fields within NMSE 1e-5."""
    from sspv_tpu_torch.examples import generate_samples

    sync(device)
    reset_launches()
    generate_samples.generate(str(tmp / "samples"), device)
    launches = launches_now()
    print("generate_samples launches: " + json.dumps(launches))
    require(launches["view_features"] > 0, "generate_samples launched K1")
    for name, n in generate_samples.SAMPLES.items():
        fname = f"voice_processing_data_{name}.npz"
        with np.load(SAMPLE_DIR / fname) as a, np.load(tmp / "samples" / fname) as b:
            require(sorted(a.files) == sorted(b.files), f"{name}: keys")
            require(a["vads"].shape[0] == b["vads"].shape[0] == n,
                    f"{name}: {n} frames")
            report = {}
            for k in a.files:
                if a[k].ndim == 0:
                    require(a[k] == b[k], f"{name}: {k}")
                    continue
                differ = np.nonzero(a[k] != b[k])[0]
                report[k] = {"nmse": nmse(b[k], a[k]),
                             "frames_differing": differ.tolist()}
            print(f"generate_samples {name} vs the committed TPU-made file: "
                  + json.dumps(report))
            for k in ("vads", "vads_adaptive"):
                require(not report[k]["frames_differing"],
                        f"{name}: {k} equal the committed file's")
            for k in ("energies", "zcrs", "spec_entropy"):
                require(report[k]["nmse"] <= NMSE_SAMPLES,
                        f"{name}: {k} within NMSE {NMSE_SAMPLES}")


def deep_fuzz_runs(device) -> None:
    from sspv_tpu_torch.tools import deep_fuzz

    sync(device)
    reset_launches()
    rc = deep_fuzz.main([str(FUZZ_VAD), str(FUZZ_GEOMETRIES), "--device",
                         device.type])
    launches = launches_now()
    print("deep_fuzz launches: " + json.dumps(launches))
    require(rc == 0, "deep_fuzz: no mismatch")
    require(launches["frame_features_fft"] > 0
            and launches["frame_features_dense"] > 0,
            "deep_fuzz: both K3 routes ran")


def sharded_runs(device) -> None:
    from sspv_tpu_torch.examples import sharded_throughput

    sync(device)
    reset_launches()
    r = sharded_throughput.run(60.0, device)
    print("sharded_throughput: " + json.dumps(r) + " launches "
          + json.dumps(launches_now()))
    require(r["k3_launches"] > 0, "sharded_throughput launched K3")


def probe_runs(device, sig: np.ndarray, long_sig: np.ndarray, synth_s: float,
               card: str) -> None:
    """``length_probe`` at the hour and at 14,400 s (57,600 s where the
    host makes it in seconds), ``pitch_probe`` at the hour."""
    from sspv_tpu_torch.tools import length_probe, pitch_probe
    from sspv_tpu_torch.utils.synth import synth_signal

    reps = length_probe.REPS
    runs = [(MAIN_SECONDS, sig, None), (PROBE_LONG_SECONDS, long_sig, synth_s)]
    if synth_s <= PROBE_SYNTH_LIMIT_S:
        t0 = time.perf_counter()
        longest = synth_signal(PROBE_LONGEST_SECONDS, SR)
        runs.append((PROBE_LONGEST_SECONDS, longest,
                     time.perf_counter() - t0))
    else:
        print(f"length_probe {PROBE_LONGEST_SECONDS} s: not run, "
              f"synth_signal({PROBE_LONG_SECONDS}) took {synth_s:.1f} s on "
              f"the host (more than {PROBE_SYNTH_LIMIT_S} s)")
    for seconds, s, made_in in runs:
        sync(device)
        reset_launches()
        r = dict(length_probe.probe(seconds, device, signal=s), synth_s=made_in)
        launches = launches_now()
        print(json.dumps(r) + " launches " + json.dumps(launches))
        require(launches["view_features"] == 1 + reps
                and r["frames"] == 1 + (int(seconds * SR) - 320) // 160,
                f"length_probe {seconds} s: one K1 launch per call")
    sync(device)
    reset_launches()
    r = pitch_probe.probe(MAIN_SECONDS, device, signal=sig)
    launches = launches_now()
    print(json.dumps(r) + " launches " + json.dumps(launches))
    require(launches["view_pitch"] == 1 + reps + 3,
            "pitch_probe: one K2 launch per call")


def soak_report_runs(soak, log: Path, soak_device: str, card: str) -> dict:
    """Waits for the soak process, then ``soak_report`` on its log."""
    from sspv_tpu_torch.tools import soak_report

    try:
        rc = soak.wait(timeout=SOAK_SECONDS + 180)
    except subprocess.TimeoutExpired:
        soak.kill()
        soak.wait()
        rc = None
    text = log.read_text()
    print(text, end="")
    _, out = captured(soak_report.main, [str(log), "--settle", "10"])
    rep = json.loads(out)
    require(rc == 0 and rep.get("verdict") == "PASS" and rep["errors"] == 0,
            f"soak: PASS (rc {rc})")
    print(f"soak {SOAK_SECONDS} s on {card}: host RSS "
          f"{rep.get('rss_mb_per_call')} MB per call, card "
          f"{rep.get('cuda_mb_per_call')} MB per call over "
          f"{rep.get('device_calls')} calls ({rep['rss_slope_mb_per_s']} / "
          f"{rep.get('cuda_slope_mb_per_s')} MB/s)")
    require("cuda_mb_per_call" in rep or soak_device != "cuda",
            "soak: the card's allocator logged")
    return rep


def examples_runs(device, sig: np.ndarray, card: str) -> np.ndarray:
    """The example harnesses and the tools of the port on the card. The
    soak runs in its own process beside the harnesses that print no time;
    the timed ones run after it. Returns the 14,400 s signal the probes
    ran on, for ``tools_runs``."""
    from sspv_tpu_torch.utils.synth import synth_signal

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        log = tmp / "soak.log"
        with open(log, "w") as out:
            soak = subprocess.Popen(
                [sys.executable, "-m", "sspv_tpu_torch.examples.soak",
                 str(SOAK_SECONDS), "--device", device.type],
                cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                stdout=out, stderr=subprocess.STDOUT)
        try:
            t0 = time.perf_counter()
            long_sig = synth_signal(PROBE_LONG_SECONDS, SR)
            synth_s = time.perf_counter() - t0
            print(f"synth_signal({PROBE_LONG_SECONDS}): {synth_s:.2f} s on "
                  "the host")
            vad_eval_runs(device, card)
            process_files_runs(device, sig, tmp, card)
            generate_samples_runs(device, tmp, card)
            deep_fuzz_runs(device)
            sharded_runs(device)
            soak_report_runs(soak, log, device.type, card)
        finally:
            if soak.poll() is None:
                soak.kill()
                soak.wait()
        probe_runs(device, sig, long_sig, synth_s, card)
        latency_runs(device, card)
        multistream_runs(device, card)
        serve_bench_runs(device, tmp, card)
    print(f"examples_runs: {time.perf_counter() - t_phase:.1f} s")
    return long_sig


RESAMPLE_PROBE_SECONDS = (60, 600)
ROOFLINE_TRACES = ("pitch", "feat", "vad")
MAX_REL_SUMS = 1e-12  # float64 window sums against the direct sum


def tool_seconds(name: str, t0: float) -> None:
    print(f"tools_runs {name}: {time.perf_counter() - t0:.1f} s")


def time_blocked_vad_runs(device, pipe, main: dict) -> None:
    """Both trailing-sum forms on the hour, each through K4's flag for it:
    one K1 and one K4 launch per call, at most 3 decisions apart (expected
    0), each equal to the engine oracle on the first 600 s."""
    from sspv_tpu_torch.tools import time_blocked_vad as tbv

    sys.path.insert(0, str(ROOT / "tests"))
    import oracle

    vf = 1 + (CHECK_SECONDS * SR - 320) // 160
    block, _ = pipe.process_signal_device(main["rows"][: vf + 1])
    want = oracle.EngineVadOracle().run_all(
        host(block.energy), host(block.zcr), host(block.entropy))[0]
    sync(device)
    reset_launches()
    lines, vads = tbv.run(MAIN_SECONDS, device, signal=main["signal"])
    launches = launches_now()
    for line in lines:
        print(json.dumps(line))
    mismatches = lines[-1]["decision_mismatches"]
    print(f"time_blocked_vad: {mismatches} decision mismatches, launches "
          + json.dumps(launches))
    require(launches["view_features"] == len(tbv.IMPLS) * (1 + tbv.REPS)
            == launches["vad"], "time_blocked_vad: one K1 and one K4 launch "
            "per call")
    require([x["vad_routes"] for x in lines[:-1]]
            == [{"vad_direct": 1}, {"vad_blocked": 1}],
            "time_blocked_vad: each form through its K4 flag")
    require(mismatches <= tbv.MAX_MISMATCHES,
            f"time_blocked_vad: {mismatches} decision mismatches")
    for impl, vad in vads.items():
        require(np.array_equal(vad[:vf], want),
                f"time_blocked_vad {impl}: VAD equal to the engine oracle")


def vad_microbench_runs(device) -> None:
    """The VAD's pieces and K4 at the block and the hour's full-length
    shape: the float64 sums within 1e-12 of the direct sum, K4 equal to
    the plain version."""
    from sspv_tpu_torch.tools import vad_microbench as vmb

    for frames in (vmb.BLOCK_FRAMES, vmb.HOUR_FRAMES):
        sync(device)
        for line in vmb.bench(vmb.padded(frames), device, valid_frames=frames):
            print(json.dumps(line))
            if line["variant"] in ("blocked", "matmul"):
                require(line["max_rel_vs_direct"] <= MAX_REL_SUMS,
                        f"vad_microbench {line['variant']} at {frames} "
                        f"frames: {line['max_rel_vs_direct']}")
            if line["variant"].startswith("kernel"):
                require(line["equal_to_plain"]
                        and line["launches"] == {"vad": vmb.REPS},
                        f"vad_microbench {line['variant']} at {frames} "
                        f"frames: K4 equal to plain, one launch per call "
                        f"({line['launches']})")


def resample_probe_runs(device) -> None:
    """Eight lines (four rate pairs at 60 and 600 s): one LSB at most,
    each through the device resampler."""
    from sspv_tpu_torch.tools import resample_probe

    for seconds in RESAMPLE_PROBE_SECONDS:
        for src, dst in resample_probe.RATE_PAIRS:
            sync(device)
            r = resample_probe.probe(seconds, src, dst, device)
            print(json.dumps(r))
            require(r["max_int16_lsb_diff"] <= 1 and r["resample_calls"] > 0,
                    f"resample_probe {seconds} s {src} -> {dst}: "
                    f"{r['max_int16_lsb_diff']} LSB, "
                    f"{r['resample_calls']} device calls")


def ablate_runs(device, main: dict) -> None:
    """The stage ablation on the hour: every full_* line within the
    oracle gate, K1 launched by features_no_vad."""
    from sspv_tpu_torch.tools import ablate_bench

    sync(device)
    reset_launches()
    for line in ablate_bench.run(MAIN_SECONDS, device, signal=main["signal"]):
        print(json.dumps(line))
        name = line.get("variant", "")
        if name.startswith("full_"):
            require(line["nmse_max"] <= NMSE_ORACLE,
                    f"ablate_bench {name}: nmse {line['nmse_max']}")
        if name == "features_no_vad":
            require(line["launches"].get("view_features", 0)
                    == 1 + ablate_bench.REPS,
                    "ablate_bench features_no_vad: one K1 launch per call")


def roofline_runs(device, seconds: int, sig: np.ndarray,
                  bounds: dict | None) -> None:
    """The decomposition at ``seconds`` on ``sig``: K1 on feat_only, K2 on
    pitch_kernel_only, K4 on vad_only, their analytic bounds at the frame
    count of their call (those of ``kernel_bounds``, ``bounds``, where
    given)."""
    from sspv_tpu_torch.tools import roofline

    sync(device)
    reset_launches()
    n = 1 + (seconds * SR - 320) // 160
    for line in roofline.run(seconds, device, signal=sig):
        print(json.dumps(line))
        kernel = roofline.ANALYTIC.get(line["program"])
        if kernel:
            require(line["launches"] == {kernel: line["calls"]},
                    f"roofline {line['program']} at {seconds} s: one "
                    f"{kernel} launch per call, nothing else "
                    f"({line['launches']})")
            a = line["analytic"]
            require(a["frames"] == n and (
                bounds is None or ((a["bound_ms"], a["bound_by"]),
                                   a["design_bound_ms"]) == bounds[kernel]),
                    f"roofline {line['program']}: the bounds of "
                    "kernel_bounds")


def roofline_trace_runs(device, seconds: int, traces) -> dict:
    """``python -m sspv_tpu_torch.tools.roofline --trace`` over ``traces``
    in a process of its own (a profiler that traced before in a process
    may drop kernels): one trace line per target, returned by target."""
    out = subprocess.run(
        [sys.executable, "-m", "sspv_tpu_torch.tools.roofline", "--seconds",
         str(seconds), "--only", "rows_only", "--rounds", "1", "--trace",
         "--trace-target", ",".join(traces), "--device", device.type],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=600)
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    print(out.stdout, end="")
    require(out.returncode == 0, f"roofline --trace: rc {out.returncode}, "
            + out.stderr[-2000:])
    got = [x for x in lines if "trace_target" in x]
    require([x["trace_target"] for x in got] == list(traces),
            "roofline --trace: one line per target")
    for x in got:
        print(f"roofline trace {x['trace_target']} at {seconds} s: "
              f"{x['device_trace']}, idle share {x['idle_share']} profiled, "
              f"{x['idle_share_unprofiled']} unprofiled, "
              f"{x['kernel_launches_per_call']} kernels per call, "
              f"{x['attempts']} attempt(s)")
    return {x["trace_target"]: x for x in got}


def k4_device_ms(trace: dict | None) -> float | None:
    """K4's device time per call (its three kernels) in the ``roofline``
    trace of the hour's VAD call, or None where it was not measured."""
    if not trace or trace["device_trace"] != "measured":
        return None
    parts = {name.split("::")[-1].split("(")[0]: ms / trace["calls"]
             for name, ms, _ in trace["top_device_ops_ms"] if "::vad_" in name}
    print("K4 device ms per call at the hour (torch.profiler, roofline "
          "vad_only trace): " + json.dumps(parts))
    return sum(parts.values()) if len(parts) == 3 else None


def tools_runs(device, pipe, main: dict, pipe400, frames_run,
               long_sig: np.ndarray, card: str) -> dict:
    """The port's last five tools on the card, each through its module's
    functions with the launch counts reset before it: ``time_blocked_vad``
    and ``ablate_bench`` on the hour, ``vad_microbench`` at the block and
    the hour's shape, ``resample_probe`` at 60 and 600 s, ``roofline`` at
    the hour and at 14,400 s, then its trace of the features, the VAD and
    the pitch call at the hour in a process of its own (returned by
    target)."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    time_blocked_vad_runs(device, pipe, main)
    tool_seconds("time_blocked_vad", t0)
    t0 = time.perf_counter()
    vad_microbench_runs(device)
    tool_seconds("vad_microbench", t0)
    t0 = time.perf_counter()
    resample_probe_runs(device)
    tool_seconds("resample_probe", t0)
    t0 = time.perf_counter()
    ablate_runs(device, main)
    tool_seconds("ablate_bench", t0)
    t0 = time.perf_counter()
    bounds = kernel_bounds(pipe, main["rows"], pipe400, frames_run["frames"])
    roofline_runs(device, MAIN_SECONDS, main["signal"], bounds)
    roofline_runs(device, PROBE_LONG_SECONDS, long_sig, None)
    traces = roofline_trace_runs(device, MAIN_SECONDS, ROOFLINE_TRACES)
    tool_seconds("roofline", t0)
    print(f"tools_runs: {time.perf_counter() - t_phase:.1f} s on {card}")
    return traces


K5_SECONDS = 3600  # the hour at 48 kHz, as 30 s windows
K5_RATE = 48000
K5_WINDOW_S = 30
K5_CONTROL_ROWS = 64  # one batch of the benchmark's 48 kHz cell
K5_EQUAL = 1 - 1e-6  # share of outputs equal to the plain version's
K5_REPS = 10


def k5_control_library():
    """``csrc/resample.cu`` alone, with float32 sums, built into
    ``build/k5_control/`` and loaded: the control's kernel."""
    import ctypes

    from sspv_tpu_torch.ops import _build

    out = ROOT / "build" / "k5_control" / "libk5_float.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DSSPV_K5_ACC=float", "-shared",
         "-o", str(out), str(ROOT / "sspv_tpu_torch" / "csrc" / "resample.cu")],
        capture_output=True, text=True)
    require(res.returncode == 0, f"the float32 control builds: {res.stderr}")
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sspv_resample_rows.argtypes = [p, p, i, i, i, p, i, i, i, i, i, p, p]
    lib.sspv_resample_rows.restype = i
    return lib


def k5_runs(device, card: str) -> dict:
    """K5 on the hour at 48 kHz, the batch program over it, and the
    float32-sum control (item 16 of the module's docstring)."""
    import torch

    from portbench.harness.audio import speech
    from portbench.readers.resample_roofline import work
    from portbench.reference import resample as ref_resample
    from portbench.reference.compare import Comparison
    from portbench.yardstick.work import bound_s
    from sspv_tpu_torch.ops import LAUNCHES, resample
    from sspv_tpu_torch.ops.pipeline import FeatureConfig
    from sspv_tpu_torch.parallel import BatchPipeline, make_mesh

    up, down = resample._reduce_ratio(SR, K5_RATE)
    seg = K5_WINDOW_S * K5_RATE
    rows = K5_SECONDS // K5_WINDOW_S
    gen = torch.Generator(device=device)
    gen.manual_seed(20)
    lengths = np.full(rows, seg, np.int64)
    lengths[-1] = 17 * K5_RATE + 1
    x = speech(rows * seg, K5_RATE, gen, FLOOR_RMS).reshape(rows, seg)
    x[torch.arange(seg, device=device)[None, :]
      >= torch.from_numpy(lengths).to(device)[:, None]] = 0
    lens = torch.from_numpy(lengths.astype(np.int32)).to(device)
    own = -(-lengths * up // down)

    before = LAUNCHES["resample"]
    y = resample.resample_rows_int16(x, lens, up, down)
    sync(device)
    require(LAUNCHES["resample"] == before + 1, "K5: one launch a call")
    want = resample.plain_resample_rows_int16(x, lens, up, down)
    diff = (y.to(torch.int32) - want.to(torch.int32)).abs()
    equal = 1.0 - float((diff > 0).sum()) / diff.numel()
    max_diff = int(diff.max())
    past = (torch.arange(y.shape[1], device=device)[None, :]
            >= torch.from_numpy(own).to(device)[:, None])
    print(f"K5 on the hour at {K5_RATE} Hz ({rows} x {K5_WINDOW_S} s): "
          f"{equal:.9f} of {diff.numel()} outputs equal to the plain "
          f"version, max |diff| {max_diff} LSB")
    require(equal >= K5_EQUAL and max_diff <= 1
            and not bool(y[past].any()),
            "K5 equals its plain version (1 - 1e-6, one LSB), 0 past each row")
    del want, diff

    ms = median_ms(lambda: resample.resample_rows_int16(x, lens, up, down),
                   K5_REPS)
    plain_ms = median_ms(
        lambda: resample.plain_resample_rows_int16(x, lens, up, down), 3)
    conv_ms = median_ms(lambda: resample_by_conv1d(
        x.to(torch.float64), up, down), 3)
    ops, nbytes = work({"source_samples": int(lengths.sum()),
                        "outputs": int(own.sum()), "up": up, "down": down})
    bound, by = bound_s(ops, nbytes)
    print(f"K5 {ms:.3f} ms, plain version {plain_ms:.3f} ms, float64 "
          f"F.conv1d of the same sum {conv_ms:.3f} ms, bound "
          f"{bound * 1e3:.4f} ms ({by}): {100 * bound * 1e3 / ms:.1f} % of its "
          f"roofline on {card}")

    with open(ROOT / "portbench" / "configs" / "whisper-frontend-48k.json") as f:
        fc = json.load(f)["feature_config"]  # the benchmark's 48 kHz cell's
    cfg = FeatureConfig(**fc)
    bp = BatchPipeline(make_mesh(1, device=str(device)), cfg)
    reset_launches()
    got = bp.process_batch_masked(x, lengths, source_rate=K5_RATE)
    sync(device)
    launches = dict(LAUNCHES)
    print("process_batch_masked at 48 kHz launches: " + json.dumps(launches))
    require(launches == {"view_features": 0, "view_pitch": 0,
                         "frame_features": 1, "vad": 1, "resample": 1},
            "process_batch_masked at 48 kHz: one launch each of K5, K3 and K4")
    at16 = bp.process_batch_masked(y, own)
    for a, b in zip((*got[0], *got[1]), (*at16[0], *at16[1])):
        require(torch.equal(a, b), "the batch program at 48 kHz is its call "
                "on K5's 16 kHz rows, bit for bit")
    path_ms = median_ms(lambda: bp.process_batch_masked(
        x, lengths, source_rate=K5_RATE), 5)
    path16_ms = median_ms(lambda: bp.process_batch_masked(y, own), 5)
    print(f"process_batch_masked on the hour at {K5_RATE} Hz {path_ms:.3f} ms "
          f"(at 16 kHz, K5's rows: {path16_ms:.3f} ms): "
          f"{float(lengths.sum()) / K5_RATE / path_ms * 1e3:.0f} audio-s/s "
          f"on {card}")

    n = K5_CONTROL_ROWS
    lib = k5_control_library()
    taps = resample._taps_on(up, down, device)
    _, n_pre_pad, n_pre_remove = resample._filter(up, down)
    y32 = torch.empty((n, y.shape[1]), dtype=torch.int16, device=device)
    xc = x[-n:].contiguous()
    lc = lens[-n:].contiguous()
    err = lib.sspv_resample_rows(
        xc.data_ptr(), lc.data_ptr(), n, seg, y.shape[1], taps.data_ptr(),
        taps.shape[0], up, down, n_pre_pad, n_pre_remove, y32.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    sync(device)
    require(err == 0, "the float32 control launches")
    flips = float((y32 != y[-n:]).sum()) / y32.numel()
    results = {}
    for name, rows16 in (("float64 (K5)", y[-n:]), ("float32 control", y32)):
        block = bp.process_batch_masked(rows16, own[-n:])[0]
        prog = {k: getattr(block, k).cpu().numpy() for k in BLOCK_FIELDS}
        cmp = Comparison(pitch=False)
        for r in range(n):
            pcm = ref_resample.resample(xc[r, : lengths[-n + r]], K5_RATE, SR)
            frames = (0 if pcm.shape[0] < cfg.frame_size else
                      1 + (pcm.shape[0] - cfg.frame_size) // cfg.hop_size)
            cmp.add({k: v[r] for k, v in prog.items()}, pcm,
                    fc, None, frames)
        results[name] = cmp.values()
        print(f"{name} sums on {n} windows: {json.dumps(results[name])}")
    print(f"float32 control: {flips:.3e} of its outputs differ from K5's")
    ok64 = results["float64 (K5)"]
    bad = results["float32 control"]
    require(ok64["features_nmse"] <= 1e-9 and ok64["vad_mismatch"] == 0,
            "K5's rows pass the benchmark's comparison")
    require(bad["features_nmse"] > 1e-9 or bad["vad_mismatch"] > 0,
            "the float32-sum control fails the benchmark's comparison")
    return {"launches": launches["resample"], "max_abs_err": max_diff,
            "unequal_share": 1.0 - equal, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound * 1e3, "bound_by": by,
            "library_ms": conv_ms, "path_ms": path_ms,
            "path16_ms": path16_ms, "control_flips": flips,
            "control": bad, "checked": ok64}


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
    # The FFT stage alone through torch.fft (cuFFT), which the port never
    # calls: K1's and K3's windowed 512-point power spectra, and K2's two
    # 1024-point transforms, on the frames formed beforehand.
    import torch

    window = fc["window"]
    view_frames = torch.cat([rows[:-1], rows[1:]], dim=1)

    def k1_fft_stage():
        return torch.fft.rfft(view_frames * feat["window"],
                              n=pipe.cfg.n_fft).abs() ** 2

    def k3_fft_stage():
        return torch.fft.rfft(frames * window, n=pipe400.cfg.n_fft).abs() ** 2

    def k2_fft_stage():
        return torch.fft.irfft(torch.fft.rfft(view_frames, n=1024).abs() ** 2,
                               n=1024)

    # K4 on the main path's own call: the hour's features at their own
    # length in the blocked order; torch.cummax of the hour's seeds beside
    # it, a yardstick the port never calls
    from sspv_tpu_torch.ops import vad as vad_ops
    from sspv_tpu_torch.ops.vad_kernels import (fused_streaming_vad,
                                                plain_streaming_vad)

    with recording_vad() as vad_calls:
        pipe.process_signal_device(rows)
    (vad_args, vad_kw), = vad_calls
    seeds = vad_ops._seeds(block.vad > 0)

    runs = {
        "vad": lambda: fused_streaming_vad(*vad_args, **vad_kw),
        "vad_plain": lambda: plain_streaming_vad(*vad_args, **vad_kw),
        "vad_cummax_library": lambda: torch.cummax(seeds, 0),
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
        "view_features_fft_stage_library": k1_fft_stage,
        "frame_features_fft_stage_library": k3_fft_stage,
        "view_pitch_fft_stage_library": k2_fft_stage,
        # K3 as it runs beside a separate entropy spectrum (it then skips
        # its entropy stage): the difference is that stage's cost
        "frame_features_without_entropy": lambda: fk._launch(
            frames, compute_entropy=False,
            **{k: v for k, v in fc.items() if k != "entropy_bases"}),
    }
    samples = {k: [] for k in runs}
    for a, b in (("view_features_plain", "view_features"),
                 ("view_pitch_plain", "view_pitch"),
                 ("frame_features_plain", "frame_features"),
                 ("vad_plain", "vad"), ("vad_cummax_library", "vad"),
                 ("view_features_fft_stage_library", "view_features"),
                 ("frame_features_fft_stage_library", "frame_features"),
                 ("view_pitch_fft_stage_library", "view_pitch"),
                 ("frame_features_without_entropy", "frames_features_vad"),
                 ("features_vad", "pitch")):
        for name in (a, b, b, a):
            samples[name] += time_ms(runs[name])
    out = {k: float(np.median(v)) for k, v in samples.items()}
    spread = {k: [float(min(v)), float(max(v))] for k, v in samples.items()}
    audio_s = (rows.shape[0] - 1) * 160 / SR
    print(f"median device ms of 10 calls (20 for the kernels) at "
          f"{rows.shape[0] - 1} frames of "
          f"320 and {frames.shape[0]} of {frames.shape[1]} ({audio_s:.0f} s "
          f"of audio) on {card}: " + json.dumps(out))
    print("min/max ms: " + json.dumps(spread))
    print(f"features+VAD {audio_s / out['features_vad'] * 1e3:.1f} audio-s/s, "
          f"pitch {audio_s / out['pitch'] * 1e3:.1f} audio-s/s, frames-path "
          f"features+VAD {audio_s / out['frames_features_vad'] * 1e3:.1f} "
          f"audio-s/s on {card}")
    return out


def kernel_bounds(pipe, rows, pipe400, frames) -> dict:
    """Each kernel's bounds at its main-path shape, as ``{name: ((ms, what
    bounds it), design ms)}``, from ``sspv_tpu_torch.tools.roofline``'s
    ``kernel_bound`` (shapes alone: the configuration and the frame
    count), the one copy of that arithmetic."""
    from sspv_tpu_torch.tools.roofline import kernel_bound

    out = {}
    n = rows.shape[0] - 1
    for name, cfg, n in (("view_features", pipe.cfg, n),
                         ("view_pitch", pipe.cfg, n),
                         ("frame_features", pipe400.cfg, frames.shape[0]),
                         # one call over the hour's features (blocked)
                         ("vad", pipe.cfg, n)):
        b = kernel_bound(name, cfg, n)
        out[name] = ((b["bound_ms"], b["bound_by"]), b["design_bound_ms"])
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an earlier checkout: time its dense K3 kernel "
                    "beside this one's (dense_runs)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    from sspv_tpu_torch import FeatureConfig, FeaturePipeline
    from sspv_tpu_torch.ops import _build
    from sspv_tpu_torch.utils.device import card_line

    device = torch.device("cuda", 0)
    card = card_line(device)
    print(card)
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
    err = {"view_features": 0.0, "view_pitch": 0.0, "frame_features": 0.0,
           "frame_features_dense": 0.0, "long_kernel_feats": 0.0,
           "long_kernel_pitch": 0.0, "vad": 0.0}
    compare_kernels(pipe, random_rows(device, KERNEL_SIZES), err)
    check_zero_frames(pipe, device)
    for i, (case, fpipe) in enumerate(frame_pipes(device).items()):
        compare_frame_kernel(fpipe._frame_consts,
                             random_frames(device, case[0], seed=i), err,
                             "frame=%d %s entropy_n_fft=%d n_fft=%d" % case[:4],
                             route=case[4])
    vad_kernel_runs(device, err)

    main = main_path(pipe, device, MAIN_SECONDS, CHECK_SECONDS, CLIP_SECONDS,
                     err)
    compare_kernels(pipe, [main["rows"]], err)  # at the main path's shape
    pipe400 = FeaturePipeline(FeatureConfig(frame_size=ASR_FRAME, hop_size=HOP),
                              device=device)
    frames_run = frames_path(pipe400, device, main["signal"], CHECK_SECONDS,
                             err)
    compare_frame_kernel(pipe400._frame_consts, [frames_run["frames"]], err,
                         "frames path")
    engine = engine_runs(device, main["signal"], err, card)
    long_run = long_runs(pipe, device, main["rows"], err)
    gap_runs(device, main["signal"], err, card)
    parent_lib = (parent_library(args.parent.resolve())
                  if args.parent is not None else None)
    dense = dense_runs(device, main["signal"], err, card, parent_lib)
    if parent_lib is not None:
        parent_ab(parent_lib, pipe, main["rows"], pipe400,
                  frames_run["frames"], card)
    corpus_runs(device, main["signal"], err, card)
    l1_runs(device, main["signal"], pipe400, frames_run, card)
    k5 = k5_runs(device, card)

    ms = timings(pipe, main["rows"], pipe400, frames_run, card)
    long_ms = long_timings(long_run, main["rows"], card)
    batch_timings(device, main["signal"], card)
    serve_runs(device, main["signal"], err, card)
    main_runs(device, main["signal"], engine, card)
    long_sig = examples_runs(device, main["signal"], card)
    traces = tools_runs(device, pipe, main, pipe400, frames_run, long_sig,
                        card)
    del long_sig
    for kernel in ("view_features", "frame_features"):
        run = engine[kernel]
        mode = "samples" if kernel == "view_features" else "frames"
        print(f"engine {mode} dispatch: {ENGINE_SECONDS / run['seconds']:.1f} "
              f"audio-s/s (host clock, {ENGINE_SECONDS} s of audio) on {card}")
    bounds = kernel_bounds(pipe, main["rows"], pipe400, frames_run["frames"])
    from sspv_tpu_torch.tools.roofline import SMEM_BYTES_PER_S

    print("design bound ms (FFT operations, bytes, or the design's "
          f"shared-memory traffic at {SMEM_BYTES_PER_S / 1e12:.1f} TB/s, "
          "whichever is largest): "
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
    # the mesh wrappers at the one-card mesh; their bounds and FFT-stage
    # yardsticks are K1's and K2's at the same shape (K4's entry follows)
    d1 = long_ms[LONG_SHARDS[0]]
    ms.update((k, d1[k]) for k in d1)
    for name, kernel, line in (("long_kernel_feats", "view_features", 304),
                               ("long_kernel_pitch", "view_pitch", 367)):
        sources[name] = ("sspv_tpu_torch/parallel/mesh.py",
                         f"sspv_tpu/parallel/mesh.py:{line}", long_run)
        bounds[name] = bounds[kernel]
        ms[name + "_fft_stage_library"] = ms[kernel + "_fft_stage_library"]
    # library_ms: no single PyTorch call computes any of these functions;
    # fft_stage_library_ms is the FFT stage alone through torch.fft
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": path["launches"][name], "max_abs_err": err[name],
         "ms": ms[name], "plain_ms": ms[name + "_plain"],
         "bound_ms": bounds[name][0][0], "bound_by": bounds[name][0][1],
         "library_ms": None,
         "fft_stage_library_ms": ms.get(name + "_fft_stage_library")}
        for name, (src, rep, path) in sources.items()
    ]
    # K4 takes the place of XLA's fusion of the JAX package's jitted
    # streaming_vad, which has no pallas_call; no single PyTorch call
    # computes it, and torch.cummax of the same seeds (its largest piece
    # in the plain version) stands beside it as a yardstick. Its "ms" is
    # the wrapper's call between CUDA events, which the host's work around
    # the launch sets; "device_ms" its three kernels' traced time
    kernels.append({
        "name": "vad", "route": "cuda", "source": "sspv_tpu_torch/csrc/vad.cu",
        "replaces": "sspv_tpu/ops/vad.py:401", "pallas": False,
        "launches": main["launches"]["vad"], "max_abs_err": err["vad"],
        "ms": ms["vad"], "plain_ms": ms["vad_plain"],
        "bound_ms": bounds["vad"][0][0], "bound_by": bounds["vad"][0][1],
        "library_ms": None, "cummax_library_ms": ms["vad_cummax_library"],
        "device_ms": k4_device_ms(traces.get("vad"))})
    # K3's dense route, a kernel of its own in frame_features.cu; its path
    # is Whisper's framing (dense_runs), its library call the spectrum stage
    # alone as one fp32 cuBLAS product, which the port never calls
    path = dense["geometries"][DENSE_GEOMETRIES[0][0]]
    kernels.append({
        "name": "frame_features_dense", "route": "cuda",
        "source": "sspv_tpu_torch/csrc/frame_features.cu",
        "replaces": "sspv_tpu/ops/pallas_kernels.py:43",
        "launches": dense["launches"]["frame_features"],
        "max_abs_err": err["frame_features_dense"], "ms": path["ms"],
        "plain_ms": path["plain_ms"], "bound_ms": path["bound_ms"],
        "bound_by": path["bound_by"], "library_ms": path["library_ms"],
        "parent_ms": path["parent_ms"],
        "design_bound_ms": path["design_bound_ms"],
        "geometries": dense["geometries"]})
    # K5 replaces no pallas_call (the JAX package resamples with lax.scan,
    # outside its batch programs); its library call is one float64
    # F.conv1d of the same sum, which the port never calls; max_abs_err is
    # its largest difference from the plain version in LSB, unequal_share
    # the share of outputs that differ
    kernels.append({
        "name": "resample", "route": "cuda",
        "source": "sspv_tpu_torch/csrc/resample.cu", "replaces": None,
        "pallas": False, **k5})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
