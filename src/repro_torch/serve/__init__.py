"""Serving: dynamic micro-batching of ragged signature requests."""
from .batcher import DynamicBatcher

__all__ = ["DynamicBatcher"]
