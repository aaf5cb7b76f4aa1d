"""Carry state from the JAX package into the port.

The JAX package hands over numpy arrays (``np.asarray`` of its arrays); this
module turns them into the port's tensors: nested dicts, lists, tuples and
dataclasses of arrays (:func:`from_numpy`), ragged batches
(:func:`ragged_from_numpy`), word plans (:func:`plan_from_reference`),
the fitted kernel-method state (:func:`sigkernel_from_reference`) and the
§8 Hurst model's parameters (:func:`hurst_params_from_reference`).  The
JAX package's objects are read by attribute; nothing of it is imported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.words import TiledPlan, WordPlan
from .device import resolve_device
from .ragged import RaggedPaths
from .sigkernel import NystromFeatures, SigKRR, WordSubsetFeatures


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


# the reference's backend strings -> the port's: its jax engine is the torch
# engine, and its Pallas kernels are the CUDA kernels where a card is present
_BACKENDS = {"jax": "torch", "pallas": "auto", "pallas_interpret": "auto"}


def sigkernel_from_reference(obj, device=None):
    """A fitted kernel-method object of the JAX package (``SigKRR``,
    ``NystromFeatures`` or ``WordSubsetFeatures``, told apart by its
    ``alpha`` / ``landmark_sigs`` / ``scale``) as the port's, on ``device``
    (default CUDA).  Arrays go through ``np.asarray``, plans through
    :func:`plan_from_reference`; the backend strings ``"jax"`` and
    ``"pallas*"`` become ``"torch"`` and ``"auto"``."""
    dev = resolve_device(device)

    def arr(name):
        return torch.from_numpy(np.array(getattr(obj, name))).to(dev)

    def plan(p):
        return None if p is None else plan_from_reference(p)

    if not any(hasattr(obj, a) for a in ("alpha", "landmark_sigs", "scale")):
        raise TypeError(f"not a kernel-method object of the JAX package: "
                        f"{type(obj).__name__}")
    backend = _BACKENDS.get(obj.backend, obj.backend)
    if hasattr(obj, "alpha"):
        return SigKRR(ref_sigs=arr("ref_sigs"), alpha=arr("alpha"),
                      weights=arr("weights"), depth=obj.depth,
                      plan=plan(obj.plan), reg=float(obj.reg),
                      backend=backend, backward=obj.backward,
                      block_words=int(obj.block_words))
    if hasattr(obj, "landmark_sigs"):
        return NystromFeatures(landmark_sigs=arr("landmark_sigs"),
                               transform=arr("transform"),
                               weights=arr("weights"), depth=obj.depth,
                               plan=plan(obj.plan), backend=backend,
                               backward=obj.backward,
                               block_words=int(obj.block_words))
    return WordSubsetFeatures(plan=plan(obj.plan), scale=arr("scale"),
                              backend=backend, backward=obj.backward)


def hurst_params_from_reference(params, device=None) -> dict:
    """The parameter pytree of ``examples/hurst_fbm.py``'s model
    (``{"scale": (d,), "mlp": [{"w": (a, b), "b": (b,)}, ...]}``, arrays
    read through ``np.asarray``; ``fnn`` has no ``scale``) as the state dict
    of ``examples/hurst_fbm_torch.py``'s ``HurstModel``, on ``device``
    (default CUDA).  The whitening statistics are not parameters: the port
    takes its own on the same reference batch (``HurstModel.whiten``)."""
    dev = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    state = {} if "scale" not in params else {"scale": t(params["scale"])}
    for i, layer in enumerate(params["mlp"]):
        state[f"mlp.{i}.w"] = t(layer["w"])
        state[f"mlp.{i}.b"] = t(layer["b"])
    return state
