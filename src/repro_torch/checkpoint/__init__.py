"""Checkpointing in the reference's on-disk format (port of
``repro.checkpoint``)."""
from .checkpointer import Checkpointer, latest_step

__all__ = ["Checkpointer", "latest_step"]
