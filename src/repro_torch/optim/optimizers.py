"""Self-contained optimizers: AdamW, Adafactor, SGD (port of
``repro.optim.optimizers``).

``opt.init(params) -> state`` and ``opt.update(grads, state, params) ->
state``.  ``params`` is an ``nn.Module`` (its named parameters) or a dict
of tensors; ``grads`` a dict of tensors under the same names.  The update
is written into the parameters and the state in place, the counterpart of
the reference's donated buffers; the arithmetic is the reference's own:
AdamW clips to global norm 1.0 inside ``update`` with ``1e-9`` in the
denominator, takes the learning rate at the incremented step, and adds
the weight decay to every leaf's update.

Adafactor's update clip (the RMS of the update) runs over the reference's
leaf: a parameter named ``layers.<i>.<rest>`` belongs to the stacked leaf
``layers.<rest>`` of all layers, whose RMS the reference takes, and so do
those of ``dense_layers``, ``shared_attn``, ``enc_layers`` and
``dec_layers``.  A stacked 1-D leaf (a norm) is factored by the reference
once both the layer count and its width reach ``min_dim_factored``; per
layer it never is (no config of the pool has 128 layers).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import re
from typing import Callable

import torch
from torch import nn

from ..distributed import collectives as C
from ..distributed.batch import batch_mesh
from ..distributed.ctx import axis_names
from ..distributed.model_parallel import axes_split, block_share, placements


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable     # params -> state
    update: Callable   # (grads, state, params) -> state; params in place


_NORM: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_grad_norm", default=None)


@contextlib.contextmanager
def norm_scope(fn):
    """Compute :func:`global_norm` of a ``{name: tensor}`` dict with
    ``fn`` inside the block: the norm of sharded gradients
    (:func:`repro_torch.distributed.model_parallel.sharded_norm`), which
    the AdamW clip and the trainer's ``grad_norm`` read."""
    token = _NORM.set(fn)
    try:
        yield
    finally:
        _NORM.reset(token)


def named(params) -> dict:
    """The parameters as a ``{name: tensor}`` dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    fn = _NORM.get()
    if fn is not None and isinstance(tree, dict):
        return fn(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in _leaves(tree)))


def clip_by_global_norm(tree: dict, max_norm: float):
    g = global_norm(tree)
    scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
    return {k: x * scale.to(x.dtype) for k, x in tree.items()}, g


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step)
        t = torch.clamp(step, max=total_steps) / max(1, total_steps)
        return base_lr * (min_frac + (1 - min_frac) * 0.5 *
                          (1 + torch.cos(math.pi * t)))
    return lr


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         min_frac: float = 0.05):
    cos = cosine_schedule(base_lr, max(1, total_steps - warmup), min_frac)

    def lr(step):
        step = torch.as_tensor(step)
        w = torch.clamp(step / max(1, warmup), max=1.0)
        return torch.where(step < warmup, base_lr * w, cos(step - warmup))
    return lr


def _step_counter(params: dict) -> torch.Tensor:
    dev = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          clip_norm: float | None = 1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        params = named(params)
        zeros = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
        return {"m": zeros,
                "v": {k: torch.zeros_like(z) for k, z in zeros.items()},
                "step": _step_counter(params)}

    @torch.no_grad()
    def update(grads, state, params):
        params = named(params)
        state["step"] += 1
        step = state["step"]
        scale = None
        if clip_norm is not None:
            scale = torch.clamp(clip_norm / (global_norm(grads) + 1e-9),
                                max=1.0)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        lr_t = lr_fn(step)
        for k, p in params.items():
            g = grads[k] if scale is None else grads[k] * scale.to(
                grads[k].dtype)
            g = g.float()
            m = state["m"][k].copy_(b1 * state["m"][k] + (1 - b1) * g)
            v = state["v"][k].copy_(b2 * state["v"][k] + (1 - b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            u = u + weight_decay * p.float()
            p.add_((-lr_t * u).to(p.dtype))
        return state

    return Optimizer(init, update)


_STACKED = re.compile(
    r"^(layers|dense_layers|shared_attn|enc_layers|dec_layers)\.\d+\.")


def _stack_key(name: str) -> str:
    """``<entry>.<i>.<rest>`` -> ``<entry>.<rest>`` for each layer-stacked
    entry (``layers``, ``dense_layers``, ``shared_attn``, ``enc_layers``,
    ``dec_layers``): the reference's stacked leaf a per-layer parameter
    belongs to."""
    return _STACKED.sub(r"\1.", name)


def _layout(params) -> dict:
    """``{name: Placement}`` of a model's sharded parameters (empty for a
    dict of tensors or an unsharded model)."""
    return placements(params) if isinstance(params, nn.Module) else {}


def adafactor(lr=1e-2, decay=0.8, eps=1e-30, clip_threshold=1.0,
              min_dim_factored=128) -> Optimizer:
    """Memory-factored second-moment optimizer.

    On a sharded model (:func:`repro_torch.distributed.model_parallel.
    shard_model`) every slot is whole and replicated, as the reference's
    ``opt_state_specs`` lays Adafactor's slots out, and the statistics are
    the global leaf's: a factored leaf's row and column means sum this
    rank's block and all-reduce over the ranks that shard the averaged
    dimension, and each new slot is gathered whole from the ranks' blocks;
    the update clip's RMS adds every rank's sum of squares over the mesh
    (one all-reduce for every sharded leaf)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def factored(shape):
        return len(shape) >= 2 and shape[-1] >= min_dim_factored and \
            shape[-2] >= min_dim_factored

    def init(params):
        layout = _layout(params)
        params = named(params)

        def one(k, p):
            shape = tuple(layout[k].shape) if k in layout else tuple(p.shape)
            if factored(shape):
                return {"vr": p.new_zeros(shape[:-1], dtype=torch.float32),
                        "vc": p.new_zeros(shape[:-2] + shape[-1:],
                                          dtype=torch.float32)}
            return {"v": p.new_zeros(shape, dtype=torch.float32)}
        return {"slots": {k: one(k, p) for k, p in params.items()},
                "step": _step_counter(params)}

    @torch.no_grad()
    def update(grads, state, params):
        layout = _layout(params)
        params = named(params)
        state["step"] += 1
        step = state["step"]
        beta = 1.0 - step.float() ** (-decay)
        lr_t = lr_fn(step)
        us = {}
        for k, p in params.items():
            g = grads[k].float()
            g2 = g * g + eps
            slot = state["slots"][k]
            pl = layout.get(k)
            sh = _Sharded(pl) if pl is not None else None
            if "vr" in slot:
                if sh is None:
                    vr = slot["vr"].copy_(beta * slot["vr"] + (1 - beta)
                                          * torch.mean(g2, dim=-1))
                    vc = slot["vc"].copy_(beta * slot["vc"] + (1 - beta)
                                          * torch.mean(g2, dim=-2))
                    mean_vr = torch.mean(vr, dim=-1, keepdim=True)
                else:
                    n = sh.nd
                    vr = sh.update(slot["vr"], beta, g2, n - 1)
                    vc = sh.update(slot["vc"], beta, g2, n - 2)
                    mean_vr = sh.mine(torch.mean(slot["vr"], dim=-1,
                                                 keepdim=True), n - 1,
                                      skip=(n - 2,))
                denom = torch.sqrt(
                    vr[..., None] * vc[..., None, :] /
                    (mean_vr[..., None] + eps))
                us[k] = g / (denom + eps)
            else:
                if sh is None:
                    v = slot["v"].copy_(beta * slot["v"] + (1 - beta) * g2)
                else:
                    v = sh.update(slot["v"], beta, g2, None)
                us[k] = g / (torch.sqrt(v) + eps)
        # the RMS of each reference leaf: a stacked leaf spans its layers,
        # a sharded one its ranks' blocks (summed over the mesh, each sum
        # of squares weighted by its share)
        split = {_stack_key(k) for k in layout}
        mesh = next(iter(layout.values())).sharding.mesh if layout else None
        sq, count = {}, {}
        for k, u in us.items():
            key = _stack_key(k)
            w = block_share(layout.get(k), mesh) if key in split else 1.0
            sq[key] = sq.get(key, 0.0) + torch.sum(u * u) * w
            count[key] = count.get(key, 0) + (
                math.prod(layout[k].shape) if k in layout else u.numel())
        if split:
            sq = _sum_over_mesh(sq, split, mesh)
        for k, p in params.items():
            key = _stack_key(k)
            rms = torch.sqrt(sq[key] / count[key] + eps)
            u = us[k] / torch.clamp(rms / clip_threshold, min=1.0)
            p.add_((-lr_t * u).to(p.dtype))
        return state

    return Optimizer(init, update)


class _Sharded:
    """Adafactor's statistics of one sharded leaf: its sharded dimensions,
    their splits, and the moves between this rank's block and a whole,
    replicated slot."""

    def __init__(self, placement):
        mesh = placement.sharding.mesh
        self.shape = tuple(placement.shape)
        self.nd = len(self.shape)
        self.dims = {}
        for d, a in enumerate(placement.spec):
            if a is not None and axes_split(mesh, a).size > 1:
                self.dims[d] = axes_split(mesh, a)

    def mine(self, whole: torch.Tensor, dropped=None, skip=()) -> \
            torch.Tensor:
        """This rank's block of a slot shaped as the leaf with dimension
        ``dropped`` (a leaf dimension, or None) taken out; the leaf
        dimensions in ``skip`` are not cut."""
        out = whole
        for d, sp in self.dims.items():
            if d == dropped or d in skip:
                continue
            start, n = sp.block(self.shape[d])
            out = out.narrow(self._at(d, dropped), start, n)
        return out

    def _at(self, d: int, dropped) -> int:
        return d if dropped is None or d < dropped else d - 1

    def update(self, slot: torch.Tensor, beta, g2: torch.Tensor, dim):
        """``slot = beta·slot + (1 − beta)·stat`` where stat is g2 (``dim``
        None) or its mean over leaf dimension ``dim`` of the global leaf;
        returns this rank's block of the new slot, which is written
        whole."""
        if dim is None:
            stat = g2
        else:
            stat = g2.sum(dim=dim)
            if dim in self.dims:
                stat = C.all_reduce_(stat, self.dims[dim].group,
                                     tag="adafactor_moment")
            stat = stat / self.shape[dim]
        new = beta * self.mine(slot, dim) + (1 - beta) * stat
        whole = new
        for d, sp in self.dims.items():
            if d != dim:
                whole = C.all_gather(whole, sp.group, dim=self._at(d, dim),
                                     tag="adafactor_slot")
        slot.copy_(whole)
        return new


def _sum_over_mesh(sq: dict, keys: set, mesh) -> dict:
    """``sq`` with the entries of ``keys`` (each rank's share) summed over
    every rank of the mesh in one all-reduce."""
    keys = sorted(keys)
    group = batch_mesh(mesh, axis_names(mesh)).get_group()
    vec = C.all_reduce_(torch.stack([torch.as_tensor(sq[k]).float()
                                     for k in keys]), group,
                        tag="adafactor_rms")
    return dict(sq, **{k: vec[i] for i, k in enumerate(keys)})


def sgd(lr=1e-2, momentum=0.9) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        params = named(params)
        return {"mom": {k: torch.zeros_like(p, dtype=torch.float32)
                        for k, p in params.items()},
                "step": _step_counter(params)}

    @torch.no_grad()
    def update(grads, state, params):
        params = named(params)
        state["step"] += 1
        lr_t = lr_fn(state["step"])
        for k, p in params.items():
            mom = state["mom"][k].copy_(momentum * state["mom"][k]
                                        + grads[k].float())
            p.add_((-lr_t * mom).to(p.dtype))
        return state

    return Optimizer(init, update)
