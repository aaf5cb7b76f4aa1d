"""Async, atomic checkpointing in the reference's on-disk format.

Port of ``repro.checkpoint.checkpointer``.  Layout::

    <dir>/step_<n>/
        manifest.json       step, leaf count, shapes, dtypes, ``extra``
        shard_<p>.npz       the leaves as arrays ``a0 .. a{n-1}``

The leaves of ``{"params": params, "opt_state": opt_state}`` are listed in
the order ``jax.tree_util`` flattens them in the reference: dict keys
sorted, lists and tuples in order, ``None`` an empty subtree, and a
dataclass's tensor fields in declaration order (``StreamCarry``: ``sig,
ring, length, end, valid``; ``SignatureStream``: ``sig, ring``;
``RaggedPaths``: ``values, lengths``), its other fields static.  So a
checkpoint either package writes restores in the other: a session pool
the reference saved comes back into the port.

- async save: the host copy is taken at once, the write runs on a
  background thread (one outstanding save at a time);
- atomicity: writes go to ``step_<n>.tmp``, renamed when complete, so an
  interrupted save never corrupts the newest good checkpoint;
- garbage collection: the newest ``keep`` checkpoints stay.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float,
                          bool))


def _flatten(tree) -> tuple[list, object]:
    """(leaves, rebuild): the leaves in the reference's flatten order, and
    a function from a list of new leaves to a tree of the same structure."""
    if tree is None:
        return [], lambda it: None
    if _is_leaf(tree):
        return [tree], lambda it: next(it)
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return ([x for leaves, _ in parts for x in leaves],
                lambda it: {k: rb(it) for k, (_, rb) in zip(keys, parts)})
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        kind = type(tree)
        return ([x for leaves, _ in parts for x in leaves],
                lambda it: kind(rb(it) for _, rb in parts))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)
                 if isinstance(getattr(tree, f.name),
                               (torch.Tensor, np.ndarray))]
        leaves = [getattr(tree, n) for n in names]
        return leaves, lambda it: dataclasses.replace(
            tree, **{n: next(it) for n in names})
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}: expected "
                    f"tensors, arrays, scalars, dicts, lists, tuples or "
                    f"dataclasses of tensors")


def _placements_of(tree, shardings) -> list:
    """``shardings`` read against the template ``tree``: one entry per leaf
    of :func:`_flatten`'s order.  A ``None`` or a sharding object where
    the template has a subtree applies to every leaf below it (the
    reference's ``flatten_up_to`` with prefix broadcasting)."""
    n = len(_flatten(tree)[0])
    if shardings is None or hasattr(shardings, "place"):
        return [shardings] * n
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _placements_of(tree[k], shardings.get(k))]
    if isinstance(tree, (list, tuple)):
        return [p for t, sh in zip(tree, shardings)
                for p in _placements_of(t, sh)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)
                 if isinstance(getattr(tree, f.name),
                               (torch.Tensor, np.ndarray))]
        return [getattr(shardings, k) for k in names]
    raise TypeError(f"shardings do not match the template at a "
                    f"{type(tree).__name__}")


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        h = x.detach()
        if h.dtype == torch.bfloat16:       # numpy has no bfloat16
            h = h.float()
        if h.device.type != "cpu":          # the copy off the card is new
            return h.cpu().numpy()
        return h.numpy().copy()
    return np.array(x)


def _from_host(h: np.ndarray, like):
    """The saved array in the template leaf's type, dtype and device."""
    if isinstance(like, torch.Tensor):
        # np.ascontiguousarray lifts a 0-d array to 1-d: keep its shape
        return torch.from_numpy(np.ascontiguousarray(h).reshape(h.shape)).to(
            device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return h.astype(like.dtype)
    return type(like)(h.item()) if isinstance(like, (int, float, bool)) \
        else h.astype(np.asarray(like).dtype)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


class Checkpointer:
    def __init__(self, ckpt_dir: str, *, keep: int = 3,
                 async_save: bool = True, process_index: int = 0,
                 process_count: int = 1):
        self.dir = ckpt_dir
        self.keep = keep
        self.async_save = async_save
        self.process_index = process_index
        self.process_count = process_count
        self._thread: Optional[threading.Thread] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, params, opt_state, step: int, extra: dict | None = None):
        """Snapshot to host memory now; write to disk (possibly async)."""
        self.wait()  # one outstanding async save at a time
        leaves, _ = _flatten({"params": params, "opt_state": opt_state})
        host = [_to_host(x) for x in leaves]
        manifest = {
            "step": step,
            "treedef": None,
            "n_leaves": len(host),
            "shapes": [list(x.shape) for x in host],
            "dtypes": [str(x.dtype) for x in host],
            "extra": extra or {},
            "process_count": self.process_count,
        }

        def write():
            final = os.path.join(self.dir, f"step_{step}")
            tmp = final + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, f"shard_{self.process_index}.npz"),
                     **{f"a{i}": x for i, x in enumerate(host)})
            if self.process_index == 0:
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def _step_dir(self, step: int | None) -> str:
        self.wait()
        step = step if step is not None else latest_step(self.dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        return os.path.join(self.dir, f"step_{step}")

    def peek_extra(self, step: int | None = None) -> dict:
        """The manifest's ``extra`` dict without touching the arrays: the
        host metadata a stateful subsystem (a session pool) needs to build
        the template :meth:`restore` fills."""
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f).get("extra", {})

    def restore(self, params_like, opt_state_like, step: int | None = None,
                shardings=None):
        """Restore into the structure of the templates: each leaf takes the
        template leaf's dtype and device.  Returns ``(params, opt_state,
        extra)``.

        ``shardings`` (a tree over ``{"params": ..., "opt_state": ...}``
        of :class:`repro_torch.distributed.ctx.NamedSharding` or None, a
        prefix of the templates' structure) lays the leaves out on a mesh:
        each rank reads the whole array and keeps its block as a DTensor
        (a replicated spec keeps the whole tensor), so a checkpoint written
        at one shard count restores at another."""
        path = self._step_dir(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(
                path, f"shard_{self.process_index}.npz")) as data:
            host = [data[f"a{i}"] for i in range(manifest["n_leaves"])]
        leaves, rebuild = _flatten({"params": params_like,
                                    "opt_state": opt_state_like})
        if len(leaves) != len(host):
            raise ValueError(f"checkpoint holds {len(host)} arrays but the "
                             f"template has {len(leaves)} leaves")
        for i, (got, want) in enumerate(zip(host, leaves)):
            if tuple(got.shape) != tuple(np.shape(want)):
                raise ValueError(f"leaf {i}: checkpoint shape "
                                 f"{tuple(got.shape)} != template shape "
                                 f"{tuple(np.shape(want))}")
        placed = [_from_host(h, w) for h, w in zip(host, leaves)]
        if shardings is not None:
            tree = {"params": params_like, "opt_state": opt_state_like}
            placed = [t if sh is None else sh.place(t) for t, sh in
                      zip(placed, _placements_of(tree, shardings))]
        out = rebuild(iter(placed))
        return out["params"], out["opt_state"], manifest.get("extra", {})
