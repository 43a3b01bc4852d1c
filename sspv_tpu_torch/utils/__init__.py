"""Host-side helpers of the port (NumPy only, but for ``profiling``: the
``torch.profiler`` trace context and the program's spans)."""

from .export import export_features_npz, summarize_features
from .framing import frame_i16_to_f32
from .npz_io import SessionData, load_session, validate_session
from .profiling import RealTimeFactor, device_trace

__all__ = [
    "export_features_npz",
    "frame_i16_to_f32",
    "summarize_features",
    "SessionData",
    "load_session",
    "validate_session",
    "RealTimeFactor",
    "device_trace",
]
