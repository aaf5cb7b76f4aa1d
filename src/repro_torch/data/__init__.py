"""Data generators of the port (numpy draws, the reference's for a seed)."""
from .pipeline import (RaggedPathStream, SessionTickStream, ShardedLoader,
                       TokenStream,
                       fbm_paths, geometric_lengths, hurst_dataset,
                       ragged_fbm_dataset, ragged_token_batches,
                       session_tick_stream, synthetic_lm_batches)

__all__ = ["RaggedPathStream", "SessionTickStream", "ShardedLoader",
           "TokenStream",
           "fbm_paths", "geometric_lengths", "hurst_dataset",
           "ragged_fbm_dataset", "ragged_token_batches",
           "session_tick_stream", "synthetic_lm_batches"]
