"""Data generators of the port (numpy draws, the reference's for a seed)."""
from .pipeline import (RaggedPathStream, SessionTickStream, fbm_paths,
                       geometric_lengths, hurst_dataset, ragged_fbm_dataset,
                       session_tick_stream)

__all__ = ["RaggedPathStream", "SessionTickStream", "fbm_paths",
           "geometric_lengths", "hurst_dataset", "ragged_fbm_dataset",
           "session_tick_stream"]
