"""Optimizers and the int8 error-feedback all-reduce (port of
``repro.optim``)."""
from .compression import (compress_int8, decompress_int8,
                          int8_error_feedback_allreduce, init_error_state)
from .optimizers import (Optimizer, adafactor, adamw, clip_by_global_norm,
                         cosine_schedule, global_norm, linear_warmup_cosine,
                         sgd)

__all__ = ["Optimizer", "adamw", "adafactor", "sgd", "global_norm",
           "clip_by_global_norm", "cosine_schedule", "linear_warmup_cosine",
           "int8_error_feedback_allreduce", "compress_int8",
           "decompress_int8"]
