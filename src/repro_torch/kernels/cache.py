"""Plan caches: one shared bounded-LRU policy.

Port of the plan-cache part of ``repro.kernels.ops``.  Every host-side plan
the kernels derive from their static arguments (index tables, launch
geometry) is interned under :func:`plan_cache`, a ``functools.lru_cache``
of ``PLAN_CACHE_MAXSIZE`` entries with its hit and miss counts.  Eviction is
always safe: entries are pure functions of their keys.
"""
from __future__ import annotations

import functools

PLAN_CACHE_MAXSIZE = 256

plan_cache = functools.lru_cache(maxsize=PLAN_CACHE_MAXSIZE)
