"""Serving: the dense decoder's generation engine, dynamic micro-batching
of ragged signature requests, the multi-tenant session pool, and the
online signature-feature and signature-kernel scoring engines built on
it."""
from .batcher import DynamicBatcher
from .engine import (ServeEngine, SigScoreEngine, SigStreamEngine,
                     make_prefill_step, make_serve_step)
from .sessions import SessionHandle, SessionStore

__all__ = ["DynamicBatcher", "ServeEngine", "SessionHandle", "SessionStore",
           "SigScoreEngine", "SigStreamEngine", "make_prefill_step",
           "make_serve_step"]
