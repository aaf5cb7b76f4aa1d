"""Data generators of the port (numpy, framework-free)."""
from .pipeline import (SessionTickStream, fbm_paths, hurst_dataset,
                       session_tick_stream)

__all__ = ["SessionTickStream", "fbm_paths", "hurst_dataset",
           "session_tick_stream"]
