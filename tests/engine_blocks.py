"""One stream's blocks through the engine's dispatch and through a chain
of eager packed-program calls, for the tests that hold the engine's graph
route and its slots to the eager calls, on the CPU and on the card
(``test_torch_engine.py``, ``test_torch_cuda.py``). Imports no JAX.

Everything is compared as raw bits (int32 views of the float32 packed
blocks and states).
"""

import numpy as np
import torch

from sspv_tpu_torch.utils.framing import frame_i16_to_f32

FRAME, HOP, SR = 320, 160, 16000
BUCKETS = (32, 256, 2048)  # the default TPU_STREAM_BUCKETS
# Block sizes in frames: the graphed sizes 6, 7, 1 and 32 (up to the first
# bucket) repeated, and one block of 40, past it, which runs eagerly.
SIZES = (6, 7, 6, 7, 1, 32, 6, 40, 7, 1, 32, 6, 7, 7, 6)
RESET_AT = 9  # set_audio_source before this block


def signal(seed: int, sizes=SIZES) -> np.ndarray:
    """int16 samples of every block: tone bursts over a noise floor."""
    rng = np.random.default_rng(seed)
    n = (sum(sizes) - 1) * HOP + FRAME
    t = np.arange(n) / SR
    voiced = ((t * 7).astype(int) % 2) == 1
    sig = (np.where(voiced, 6000 * np.sin(2 * np.pi * (120 + 30 * seed) * t), 0)
           + rng.normal(0, 300, n))
    return np.clip(sig, -32768, 32767).astype(np.int16)


def blocks(sig: np.ndarray, sizes=SIZES):
    """The sample block of each size, consecutive frames, as the engine's
    take gives them (each block's last frame overlaps the next's first)."""
    start = 0
    for n in sizes:
        yield sig[start * HOP : (start + n - 1) * HOP + FRAME]
        start += n


def bits(t) -> np.ndarray:
    a = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return np.ascontiguousarray(a).view(np.int32).copy()


def eager_chain(pipe, sig: np.ndarray, sizes=SIZES, reset_at=RESET_AT,
                frames: bool = False, min_conf: float | None = None):
    """Each block's packed block and the final packed state (bits) of a
    chain of ``process_signal_packed`` calls (with ``frames``,
    ``process_block_packed`` on the host-framed block; with ``min_conf``,
    their pitch programs), each with its bucket's VAD order, the state
    carried, and at ``reset_at`` the reset of ``set_audio_source`` (a fresh
    state that keeps last_voiced's bits)."""
    name = "process_block_packed" if frames else "process_signal_packed"
    pitch = () if min_conf is None else (min_conf,)
    program = getattr(pipe, name + ("_pitch" if pitch else ""))
    state = torch.from_numpy(pipe.initial_packed_state()).to(pipe.device)
    outs = []
    for k, block in enumerate(blocks(sig, sizes)):
        if k == reset_at:
            fresh = pipe.initial_packed_state()
            fresh.view(np.int32)[-1] = bits(state)[-1]
            state = torch.from_numpy(fresh).to(pipe.device)
        n = 1 + (len(block) - FRAME) // HOP
        payload = frame_i16_to_f32(block, FRAME, HOP) if frames else block
        out, state = program(payload, state, len(payload), *pitch,
                             route_frames=next(b for b in BUCKETS if n <= b))
        outs.append(bits(out))
    return outs, bits(state)


def engine_run(rt, sig: np.ndarray, sizes=SIZES, reset_at=RESET_AT):
    """The same blocks through ``rt``'s dispatch (the frames dispatch takes
    them framed on the host), one block in flight as its processing loop
    keeps them, with ``set_audio_source`` at ``reset_at``: each published
    packed block and the final state (bits)."""
    published = []
    publish = rt._publish

    def spy(packed, n):
        published.append(bits(packed[:n]))
        publish(packed, n)

    rt._publish = spy
    inflight = None
    for k, block in enumerate(blocks(sig, sizes)):
        if k == reset_at:
            if inflight is not None:
                rt._materialize(inflight)
                inflight = None
            rt.set_audio_source(rt.audio_source)
        n = 1 + (len(block) - FRAME) // HOP
        nxt = rt._dispatch(block if rt._samples_dispatch
                           else frame_i16_to_f32(block, FRAME, HOP), n)
        if inflight is not None:
            rt._materialize(inflight)
        inflight = nxt
    rt._materialize(inflight)
    return published, bits(rt._vad_state_packed)


def expected_replays(sizes=SIZES, limit: int = BUCKETS[0]) -> int:
    """Blocks that replay a graph: each graphed size after its first."""
    seen = set()
    replays = 0
    for n in sizes:
        if n <= limit:
            replays += n in seen
            seen.add(n)
    return replays
