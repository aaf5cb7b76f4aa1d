"""Optimizers (port of ``repro.optim``; its int8 all-reduce compression
is ROADMAP.md queue 1, item 15)."""
from .optimizers import (Optimizer, adafactor, adamw, clip_by_global_norm,
                         cosine_schedule, global_norm, linear_warmup_cosine,
                         sgd)

__all__ = ["Optimizer", "adamw", "adafactor", "sgd", "global_norm",
           "clip_by_global_norm", "cosine_schedule", "linear_warmup_cosine"]
