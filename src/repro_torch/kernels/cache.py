"""Plan caches: one shared bounded-LRU policy.

Port of the plan-cache part of ``repro.kernels.ops``.  Every host-side plan
the kernels derive from their static arguments (index tables, launch
geometry) is interned under :func:`plan_cache`, an LRU of
``PLAN_CACHE_MAXSIZE`` entries that counts its hits, misses and evictions.
:class:`BoundedCache` is the same policy for a cache that lives on an
instance.  :func:`set_plan_cache_maxsize` re-bounds every cache and
:func:`clear_plan_caches` empties them: eviction is always safe, entries
are pure functions of their keys.

:func:`plan_cache_info` sums the counts over every cache (the four fields
a serving ``stats()`` reports); :func:`plan_cache_families` gives them per
cache, and :func:`plan_cache_collector` publishes those as the
``pathsig_plan_cache{cache, stat}`` gauges of :mod:`repro_torch.obs`.
"""
from __future__ import annotations

import functools
import threading
import weakref
from collections import OrderedDict, namedtuple

PLAN_CACHE_MAXSIZE: int | None = 256

CacheInfo = namedtuple("CacheInfo",
                       ("hits", "misses", "maxsize", "currsize", "evictions"))

_CACHED: dict[str, "_CountingLru"] = {}   # family -> module-level cache
# family -> WeakSet of the live BoundedCache instances reported under it
_INSTANCE_CACHES: dict[str, weakref.WeakSet] = {}


class _Lru:
    """An LRU under the shared bound, with hit, miss and eviction counts.
    The bound is read at every insert, so :func:`set_plan_cache_maxsize`
    takes effect at once."""

    def __init__(self):
        self._data: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key, make):
        """Cached value for ``key``, built by ``make()`` on a miss."""
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                return self._data[key]
            self.misses += 1
        val = make()
        with self._lock:
            self._data[key] = val
            self._trim()
        return val

    def _trim(self) -> None:
        while PLAN_CACHE_MAXSIZE is not None \
                and len(self._data) > PLAN_CACHE_MAXSIZE:
            self._data.popitem(last=False)
            self.evictions += 1

    def trim(self) -> None:
        with self._lock:
            self._trim()

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def info(self) -> CacheInfo:
        return CacheInfo(self.hits, self.misses, PLAN_CACHE_MAXSIZE,
                         len(self._data), self.evictions)


class _CountingLru(_Lru):
    """``functools.lru_cache`` semantics (positional args plus sorted
    kwargs, all hashable) under the shared bound, counting evictions."""

    def __init__(self, fn):
        super().__init__()
        self._fn = fn
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        key = (args, tuple(sorted(kwargs.items()))) if kwargs else args
        return self.get(key, lambda: self._fn(*args, **kwargs))

    def cache_info(self) -> CacheInfo:
        return self.info()

    def cache_clear(self) -> None:
        self.clear()


class BoundedCache(_Lru):
    """Per-instance LRU under the shared plan-cache policy, reported with
    every live instance of the same ``name`` summed into one family."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name
        _INSTANCE_CACHES.setdefault(name, weakref.WeakSet()).add(self)


def plan_cache(fn):
    """Intern ``fn``'s results under the shared bounded-LRU policy; the
    cache's family is ``<module>.<function>``."""
    cached = _CountingLru(fn)
    _CACHED[f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__qualname__}"] = cached
    return cached


def _every_cache():
    yield from _CACHED.values()
    for caches in _INSTANCE_CACHES.values():
        yield from list(caches)


def set_plan_cache_maxsize(maxsize: int | None) -> None:
    """Bound every plan cache and live :class:`BoundedCache` by
    ``maxsize`` entries (None: unbounded), trimming the least recently
    used entries now."""
    global PLAN_CACHE_MAXSIZE
    PLAN_CACHE_MAXSIZE = maxsize
    for c in _every_cache():
        c.trim()


def clear_plan_caches() -> None:
    """Drop every cached plan (the serving side's pressure valve; results
    are unaffected)."""
    for c in _every_cache():
        c.clear()


def plan_cache_families() -> dict[str, CacheInfo]:
    """{family: CacheInfo} for every module-level cache and each
    :class:`BoundedCache` family (counts summed over its live
    instances)."""
    out = {name: c.info() for name, c in _CACHED.items()}
    for name, caches in _INSTANCE_CACHES.items():
        infos = [c.info() for c in list(caches)]
        out[name] = CacheInfo(*(sum(i[k] for i in infos) for k in (0, 1)),
                              PLAN_CACHE_MAXSIZE,
                              *(sum(i[k] for i in infos) for k in (3, 4)))
    return out


def plan_cache_info() -> dict:
    """``hits``, ``misses`` and ``currsize`` summed over every cache, and
    ``maxsize`` a cache (the four fields of the reference's
    ``BoundedCache.info()`` that a serving ``stats()`` reports)."""
    infos = list(plan_cache_families().values())
    return {"hits": sum(i.hits for i in infos),
            "misses": sum(i.misses for i in infos),
            "maxsize": PLAN_CACHE_MAXSIZE,
            "currsize": sum(i.currsize for i in infos)}


def plan_cache_collector(reg) -> None:
    """Pull collector: publish :func:`plan_cache_families` as
    ``pathsig_plan_cache{cache=, stat=}`` gauges at snapshot time, so the
    hot path never mirrors an increment into the registry."""
    g = reg.gauge("pathsig_plan_cache",
                  "plan cache accounting (hits/misses/currsize/evictions "
                  "per cache family)", ("cache", "stat"))
    for name, ci in plan_cache_families().items():
        for stat in ("hits", "misses", "currsize", "evictions"):
            g.set(getattr(ci, stat), cache=name, stat=stat)
