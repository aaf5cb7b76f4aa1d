"""Ragged (variable-length) path batches: padding + lengths, bucketing."""
from .bucketing import (assign_buckets, batch_rung, bucket_ladder,
                        bucket_paths, pad_batch)
from .paths import RaggedPaths

__all__ = ["RaggedPaths", "assign_buckets", "batch_rung", "bucket_ladder",
           "bucket_paths", "pad_batch"]
