"""Serving: dynamic micro-batching of ragged signature requests and
signature-kernel scoring against a cached reference set."""
from .batcher import DynamicBatcher
from .engine import SigScoreEngine

__all__ = ["DynamicBatcher", "SigScoreEngine"]
