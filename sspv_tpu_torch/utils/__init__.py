"""Host-side helpers of the port (NumPy only)."""

from .framing import frame_i16_to_f32

__all__ = ["frame_i16_to_f32"]
