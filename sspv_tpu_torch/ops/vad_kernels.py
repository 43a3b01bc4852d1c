"""The streaming composite VAD as one hand-written kernel: the wrapper.

``fused_streaming_vad`` (K4, ``csrc/vad.cu``) computes
``vad.streaming_vad`` for ``(f,)`` or ``(B, f)`` rows, each with its own
state and its own valid frames, in three launches on the current stream
with no host round trip. The JAX package runs the same function
(``sspv_tpu/ops/vad.py:401``) inside one ``jit`` program, fused by XLA,
and ``vmap``s it over the rows of its batch programs; it has no
``pl.pallas_call`` behind it.

Beside ``vad.streaming_vad``'s arguments the wrapper takes two that the
pipeline uses in place of padding:

- ``lengths``: each row's valid frames as a number (an ``int`` for every
  row, or a ``(B,)`` int32 tensor on the inputs' device that the host
  builds once per batch); frames at or past it are what a ``valid`` mask
  marks invalid. The kernel reads the number, so no mask, pad or count is
  formed around the launch.
- ``route_frames``: the frame count that picks the window sums' order,
  blocked (``trailing_impl="blocked"`` and a multiple of ``history_len``)
  or direct; default the call's own. A caller that runs a signal at its
  exact length passes the count the padded call had, so the float64 sums,
  and so every decision and the state, stay those of the padded call.

The wrapper dispatches on the device of ``energy``: a CUDA tensor launches
K4 (or raises), a CPU tensor runs :func:`plain_streaming_vad`, which is
what the kernel is held to, decisions and state equal. There is no
fallback between the two. The public ``ops.streaming_vad`` stays the plain
function, the JAX package's public counterpart.
"""

from __future__ import annotations

import torch

from . import _build
from . import vad as vad_ops
from ..utils.profiling import span

__all__ = ["fused_streaming_vad", "plain_streaming_vad"]

# flags of the C entry point
_ADAPTIVE, _AND, _BLOCKED, _MARGIN = 1, 2, 4, 8
# frames per block of the kernel's gate and hangover launches (kTile)
_FRAMES_PER_BLOCK = 256


def _rows(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _blocked(trailing_impl: str, route_frames: int, history_len: int) -> bool:
    """Whether the window sums take the blocked order: the rule of
    ``vad._window_sums`` applied to ``route_frames``."""
    return (trailing_impl == "blocked" and route_frames > 0
            and route_frames % history_len == 0)


def plain_streaming_vad(energy, zcr, entropy, state, *, lengths=None,
                        route_frames=None, **kw):
    """The kernel's plain version: ``vad.streaming_vad`` on the inputs'
    device, with ``lengths`` turned into the ``valid`` mask it stands for
    and ``route_frames`` into the order of the sums. Where the blocked
    order is asked for at a frame count that is no multiple of
    ``history_len``, the inputs are padded to one under the mask (the
    windows of the real frames never reach the pad) and the decisions
    sliced back."""
    f = energy.shape[-1]
    h = int(kw.get("history_len", 256))
    valid = kw.pop("valid", None)
    if lengths is not None:
        if valid is not None:
            raise ValueError("pass a valid mask or lengths, not both")
        n = (lengths[..., None] if isinstance(lengths, torch.Tensor)
             else int(lengths))
        if not (isinstance(n, int) and n >= f):
            valid = (torch.arange(f, device=energy.device) < n).expand(
                energy.shape)
    blocked = _blocked(kw.pop("trailing_impl", "conv"),
                       f if route_frames is None else int(route_frames), h)
    pad = -f % h if blocked else 0
    if pad:
        energy, zcr, entropy = (torch.nn.functional.pad(x, (0, pad))
                                for x in (energy, zcr, entropy))
        valid = ((torch.arange(f + pad, device=energy.device) < f).expand(
                     energy.shape)
                 if valid is None else torch.nn.functional.pad(valid, (0, pad)))
    vad, vad_adaptive, new = vad_ops.streaming_vad(
        energy, zcr, entropy, state, valid=valid,
        trailing_impl="blocked" if blocked else "conv", **kw)
    return vad[..., :f], vad_adaptive[..., :f], new


def fused_streaming_vad(
    energy: torch.Tensor,
    zcr: torch.Tensor,
    entropy: torch.Tensor,
    state: vad_ops.VadState,
    *,
    energy_threshold: float,
    zcr_threshold: float,
    entropy_voice_max: float,
    use_adaptive: bool,
    adaptive_alpha: float,
    min_energy_threshold: float = 1e-6,
    max_zcr_threshold: float = 0.5,
    hangover_on: int = 3,
    release_off: int = 2,
    history_len: int = 256,
    valid: torch.Tensor | None = None,
    trailing_impl: str = "conv",
    adaptive_margin: float = 1.0,
    composite_mode: str = "or",
    lengths: int | torch.Tensor | None = None,
    route_frames: int | None = None,
):
    """``vad.streaming_vad`` (same signature and results, plus ``lengths``
    and ``route_frames``, see the module): K4 on a CUDA tensor, the plain
    version on a CPU one. ``energy``/``zcr``/``entropy`` are float32
    ``(f,)`` or ``(B, f)``; ``state`` has the matching leading axis;
    ``valid`` is a bool mask of their shape or None. Returns ``(vad int32,
    vad_adaptive int32, new_state)``."""
    with span("sspv.k4.vad"):
        kw = dict(energy_threshold=energy_threshold, zcr_threshold=zcr_threshold,
                  entropy_voice_max=entropy_voice_max, use_adaptive=use_adaptive,
                  adaptive_alpha=adaptive_alpha,
                  min_energy_threshold=min_energy_threshold,
                  max_zcr_threshold=max_zcr_threshold, hangover_on=hangover_on,
                  release_off=release_off, history_len=history_len, valid=valid,
                  trailing_impl=trailing_impl, adaptive_margin=adaptive_margin,
                  composite_mode=composite_mode, lengths=lengths,
                  route_frames=route_frames)
        if energy.device.type == "cpu":
            return plain_streaming_vad(energy, zcr, entropy, state, **kw)
        if energy.device.type != "cuda":
            raise ValueError(f"no vad kernel for device {energy.device}")
        dev = energy.device
        lib = _build.library()
        with torch.cuda.device(dev):
            err, route, out = launch(lib, energy, zcr, entropy, state,
                                     torch.cuda.current_stream(dev).cuda_stream,
                                     **kw)
        if route is not None:
            _build.check(err, "vad")
            _build.count("vad", route)
        return out


def launch(lib, energy, zcr, entropy, state, stream, *, energy_threshold,
           zcr_threshold, entropy_voice_max, use_adaptive, adaptive_alpha,
           min_energy_threshold=1e-6, max_zcr_threshold=0.5, hangover_on=3,
           release_off=2, history_len=256, valid=None, trailing_impl="conv",
           adaptive_margin=1.0, composite_mode="or", lengths=None,
           route_frames=None):
    """K4's launch through the C entry point of ``lib`` on ``stream``:
    checks the inputs, allocates the outputs and the new state on the
    inputs' device (one buffer for the decisions and the kernel's scratch,
    one for the state), and calls ``sspv_streaming_vad``. Returns
    ``(error, route, (vad, vad_adaptive, new_state))``; the route
    (``"vad_direct"`` or ``"vad_blocked"``, a key of ``ROUTES``) is None
    where nothing launched (no frame: the state goes on unchanged)."""
    dev = energy.device
    if energy.dim() not in (1, 2):
        raise ValueError(f"energy must be (f,) or (B, f), got "
                         f"{tuple(energy.shape)}")
    shape = tuple(energy.shape)
    b = shape[0] if len(shape) == 2 else 1
    f = shape[-1]
    h = int(history_len)
    if h < 1:
        raise ValueError(f"history_len must be >= 1, got {h}")
    lead = shape[:-1]
    e, z, ent = (_rows(x, name, shape, torch.float32, dev)
                 for x, name in ((energy, "energy"), (zcr, "zcr"),
                                 (entropy, "entropy")))
    ebuf = _rows(state.energy_buf, "energy_buf", lead + (h,), torch.float32,
                 dev)
    zbuf = _rows(state.zcr_buf, "zcr_buf", lead + (h,), torch.float32, dev)
    count = _rows(state.count, "count", lead, torch.int32, dev)
    last = _rows(state.last_voiced, "last_voiced", lead, torch.int32, dev)
    if f == 0:
        empty = torch.empty(shape, dtype=torch.int32, device=dev)
        return 0, None, (empty, empty.clone(), vad_ops.VadState(
            ebuf.clone(), zbuf.clone(), count.clone(), last.clone()))

    n_valid, n_len, mask = None, f, None
    if valid is not None:
        if lengths is not None:
            raise ValueError("pass a valid mask or lengths, not both")
        mask = _rows(valid, "valid", shape, torch.bool, dev)
        n_valid = mask.sum(dim=-1, dtype=torch.int32).reshape(b)
        mask = mask.view(torch.uint8)
    elif isinstance(lengths, torch.Tensor):
        n_valid = _rows(lengths, "lengths", (b,), torch.int32, dev)
    elif lengths is not None:
        n_len = max(0, min(int(lengths), f))
    blocked = _blocked(trailing_impl, f if route_frames is None
                       else int(route_frames), h)
    a = max(0.0, min(float(adaptive_alpha), 0.99))
    margin = float(adaptive_margin)
    flags = ((_ADAPTIVE if use_adaptive else 0)
             | (_AND if composite_mode == "and" else 0)
             | (_BLOCKED if blocked else 0)
             | (_MARGIN if margin != 1.0 else 0))
    on = max(int(hangover_on), 0)
    off = max(int(release_off), 0)
    n_blocks = -(-f // _FRAMES_PER_BLOCK)
    out = torch.empty(b * (2 * f + n_blocks), dtype=torch.int32, device=dev)
    vad = out[: b * f].view(shape)
    vad_adaptive = out[b * f : 2 * b * f].view(shape)
    st = torch.empty(b * (2 * h + 2), dtype=torch.int32, device=dev)
    new = vad_ops.VadState(
        st[: b * h].view(torch.float32).view(lead + (h,)),
        st[b * h : 2 * b * h].view(torch.float32).view(lead + (h,)),
        st[2 * b * h : 2 * b * h + b].view(lead),
        st[2 * b * h + b :].view(lead))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.sspv_streaming_vad(
        e.data_ptr(), z.data_ptr(), ent.data_ptr(), ptr(mask), ptr(n_valid),
        n_len, ebuf.data_ptr(), zbuf.data_ptr(), count.data_ptr(),
        last.data_ptr(), b, f, h, float(energy_threshold),
        float(zcr_threshold), float(entropy_voice_max), a, 1 - a,
        float(min_energy_threshold), float(max_zcr_threshold), margin, flags,
        on + max(off, 1), out[2 * b * f :].data_ptr(), vad.data_ptr(),
        vad_adaptive.data_ptr(), *(t.data_ptr() for t in new), stream,
    )
    return err, ("vad_blocked" if blocked else "vad_direct"), (
        vad, vad_adaptive, new)
