"""Kernels: the hand-written Hopper kernels (``sig_trunc``, ``sig_words``,
``sig_gram`` and the §4.2 ``sig_sweep``), their plain versions and the
signature / projection / Gram dispatch.

The reference's package surface is exported here with two differences:
``sig_trunc`` and ``sig_words`` are the names of their submodules (the
kernel wrappers are ``sig_trunc.sig_trunc`` and ``sig_words.sig_words``),
and ``sig_gram_tiles`` is the Hopper Gram :func:`sig_gram.sig_gram`.
``core`` imports the plan caches from this package, so the names that
import ``core`` in turn (``ops``, ``ref``, ``sig_gram_tiles``,
``choose_split``, ``cone_rows``) load on first access.  Importing the
package defines the four kernels' operators (``pathsig::sig_trunc``,
``sig_words``, ``sig_gram``, ``sig_sweep``; :mod:`.library`), with no
kernel built.
"""
import importlib

from . import cost, library  # noqa: F401  (defines the operators)
from .cache import (BoundedCache, clear_plan_caches, plan_cache_info,
                    set_plan_cache_maxsize)

_LAZY = {"ops": ("ops", None), "ref": ("ref", None),
         "sig_gram_tiles": ("sig_gram", "sig_gram"),
         "choose_split": ("sig_trunc", "choose_split"),
         "cone_rows": ("sig_trunc", "cone_rows")}


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr = _LAZY[name]
    mod = importlib.import_module(f".{module}", __name__)
    return mod if attr is None else getattr(mod, attr)


__all__ = ["ops", "ref", "sig_gram_tiles", "choose_split", "cone_rows",
           "BoundedCache", "clear_plan_caches", "plan_cache_info",
           "set_plan_cache_maxsize"]
