"""Host-side helpers of the port (NumPy only)."""

from .export import export_features_npz, summarize_features
from .framing import frame_i16_to_f32

__all__ = ["export_features_npz", "frame_i16_to_f32", "summarize_features"]
