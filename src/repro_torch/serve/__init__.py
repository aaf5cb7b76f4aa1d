"""Serving: dynamic micro-batching of ragged signature requests, the
multi-tenant session pool, and the online signature-feature and
signature-kernel scoring engines built on it."""
from .batcher import DynamicBatcher
from .engine import SigScoreEngine, SigStreamEngine
from .sessions import SessionHandle, SessionStore

__all__ = ["DynamicBatcher", "SessionHandle", "SessionStore",
           "SigScoreEngine", "SigStreamEngine"]
