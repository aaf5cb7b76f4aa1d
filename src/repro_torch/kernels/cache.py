"""Plan caches: one shared bounded-LRU policy.

Port of the plan-cache part of ``repro.kernels.ops``.  Every host-side plan
the kernels derive from their static arguments (index tables, launch
geometry) is interned under :func:`plan_cache`, a ``functools.lru_cache``
of ``PLAN_CACHE_MAXSIZE`` entries with its hit and miss counts.  Eviction is
always safe: entries are pure functions of their keys.
:func:`plan_cache_info` sums the counts over every cached function.
"""
from __future__ import annotations

import functools

PLAN_CACHE_MAXSIZE = 256

_CACHED: list = []      # every function interned under plan_cache


def plan_cache(fn):
    """``functools.lru_cache(maxsize=PLAN_CACHE_MAXSIZE)``, registered for
    :func:`plan_cache_info`."""
    cached = functools.lru_cache(maxsize=PLAN_CACHE_MAXSIZE)(fn)
    _CACHED.append(cached)
    return cached


def plan_cache_info() -> dict:
    """``hits``, ``misses`` and ``currsize`` summed over every plan cache,
    and ``maxsize`` a cache (the four fields of the reference's
    ``BoundedCache.info()``)."""
    infos = [f.cache_info() for f in _CACHED]
    return {"hits": sum(i.hits for i in infos),
            "misses": sum(i.misses for i in infos),
            "maxsize": PLAN_CACHE_MAXSIZE,
            "currsize": sum(i.currsize for i in infos)}
