"""Carry state from the JAX package into the port.

The JAX package hands over numpy arrays (``np.asarray`` of its arrays); this
module turns them into the port's tensors.  The truncated path has no
learned parameters, so the state is inputs: nested dicts, lists, tuples and
dataclasses of arrays (:func:`from_numpy`), and ragged batches
(:func:`ragged_from_numpy`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.words import TiledPlan, WordPlan
from .device import resolve_device
from .ragged import RaggedPaths


def from_numpy(tree, device=None):
    """Every numpy array (or array-like leaf with ``__array__``) in a nested
    dict / list / tuple / dataclass becomes a tensor on ``device`` (default
    CUDA); other leaves pass through unchanged."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: conv(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.init})
        if isinstance(x, np.ndarray) or hasattr(x, "__array__"):
            return torch.from_numpy(np.array(x)).to(dev)
        return x

    return conv(tree)


def ragged_from_numpy(values, lengths, device=None) -> RaggedPaths:
    """A (B, M+1, d) padded batch and its (B,) lengths -> ``RaggedPaths``."""
    return RaggedPaths.from_dense(
        torch.from_numpy(np.array(values)), np.array(lengths, np.int32),
        device=device)


_WORDPLAN_ARRAYS = {"letters": np.int32, "prefix_idx": np.int32,
                    "inv": np.float32, "emit": np.float32,
                    "lengths": np.int32, "out_rows": np.int32}


def _words(ws) -> tuple:
    return tuple(tuple(int(i) for i in w) for w in ws)


def plan_from_reference(plan) -> WordPlan | TiledPlan:
    """A word plan of the JAX package (``WordPlan`` or ``TiledPlan``), read
    by attribute as numpy arrays and word tuples, as the port's plan.  A
    ``TiledPlan`` is told apart by its ``tiles``; nothing of the JAX package
    is imported."""
    if hasattr(plan, "tiles"):
        return TiledPlan(
            d=int(plan.d),
            tiles=tuple(plan_from_reference(p) for p in plan.tiles),
            gather=tuple((int(t), int(k)) for t, k in plan.gather),
            words=_words(plan.words))
    arrays = {k: np.array(getattr(plan, k), dtype=dt)
              for k, dt in _WORDPLAN_ARRAYS.items()}
    return WordPlan(d=int(plan.d), depth=int(plan.depth),
                    words=_words(plan.words), closure=_words(plan.closure),
                    **arrays)
