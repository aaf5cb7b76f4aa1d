"""Ragged (variable-length) path batches: padding + lengths, bucketing."""
from ..core.signature import (as_lengths, length_mask, mask_increments,
                              ragged_terminal, stream_emit_mask,
                              stream_emit_slots)
from .bucketing import (assign_buckets, batch_rung, bucket_ladder,
                        bucket_paths, pad_batch)
from .paths import RaggedPaths

__all__ = [
    "RaggedPaths", "as_lengths", "length_mask", "mask_increments",
    "ragged_terminal", "stream_emit_mask", "stream_emit_slots",
    "assign_buckets", "batch_rung", "bucket_ladder", "bucket_paths",
    "pad_batch",
]
