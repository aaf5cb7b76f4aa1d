"""Batch shardings over the mesh (port of the batch part of
``repro.distributed.sharding``).

:func:`batch_specs` gives every leaf of a batch dict its layout: the
"batch" logical axis split over the mesh's data axes, the sequence and
feature axes whole.  The layouts are
:class:`repro_torch.distributed.ctx.NamedSharding` objects, whose
``place`` lays a full tensor out as a DTensor (``trainer.place_batch``).

The parameter, cache and optimizer-state specs (``param_specs``,
``cache_specs``, ``opt_state_specs`` with the ``_PARAM_RULES`` table) are
ROADMAP.md queue 1, item 15: they shard parameters over the model axis,
which the port does not execute yet.
"""
from __future__ import annotations

from .ctx import NamedSharding, clean_spec, resolve_spec, sharding_ctx


def _path_str(path) -> str:
    """A tree path (a tuple of dict keys and sequence indices) as the
    reference's ``a/b/0`` string."""
    return "/".join(str(p) for p in path)


# the reference's name of the divisibility and first-wins guard
_clean_spec = clean_spec


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def batch_specs(batch, mesh, rules: dict | None = None):
    """A tree of :class:`NamedSharding` matching ``batch`` (dicts, lists
    and tuples of tensors): (3-D) ``positions`` (3, B, S) split on dim 1,
    other leaves of 2 or more dims on dim 0 (the batch), scalars and 1-D
    leaves replicated."""
    def one(path, leaf):
        name = _path_str(path)
        ndim = len(leaf.shape)
        with sharding_ctx(mesh, rules):
            if name.endswith("positions") and ndim == 3:
                spec = resolve_spec(None, "batch", "seq")
            elif ndim >= 3:   # embeds / frames / paths (B, S, d)
                spec = resolve_spec("batch", "seq", *([None] * (ndim - 2)))
            elif ndim == 2:   # tokens / labels
                spec = resolve_spec("batch", "seq")
            else:
                spec = ()
        return NamedSharding(mesh, _clean_spec(leaf.shape, spec, mesh))

    return _rebuild(batch, one)
