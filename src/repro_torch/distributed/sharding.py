"""Parameter, cache, optimizer-state and batch shardings over the mesh
(port of ``repro.distributed.sharding``: FSDP x TP x EP).

- ``"model"`` axis: Megatron tensor parallelism: heads, d_ff, vocabulary
  and experts;
- ``"data"`` axis: the batch, and ZeRO-3 sharding of parameters and
  optimizer slots (the ``"fsdp"`` logical axis);
- ``"pod"`` axis: pure data parallelism across pods.

Rules are name-based over the parameter path, as in the reference.  The
port's layers are per-layer ``ModuleList`` entries (``layers.3.attn.wq``,
path ``layers/3/attn/wq``) where the reference stacks them on a leading L
axis (``layers/attn/wq``): the rule is the same, and the port's spec is
the reference's without the leading ``None``.  Every spec function reads
only axis names and sizes, so it accepts an
:class:`~repro_torch.distributed.ctx.AbstractMesh` as well as a device
mesh.  Specs are :class:`~repro_torch.distributed.ctx.NamedSharding`
objects; :mod:`repro_torch.distributed.model_parallel` executes them.
"""
from __future__ import annotations

import re

from .ctx import NamedSharding, clean_spec, resolve_spec, sharding_ctx

# (regex over path, logical spec per trailing dims): the reference's table
_PARAM_RULES: list[tuple[str, tuple]] = [
    # embeddings / unembedding: the embedding is vocab-parallel only (a
    # data-sharded d-dim would make a sharded lookup gather the batch)
    (r"embed$",            ("vocab", None)),
    (r"lm_head$",          ("fsdp", "vocab")),
    (r"pos_dec$",          (None, "fsdp")),
    # attention: wk/wv stay replicated over the model axis (no pool arch
    # has kv_heads divisible by 16)
    (r"attn/wq$",          ("fsdp", "heads")),
    (r"attn/w[kv]$",       ("fsdp", None)),
    (r"attn/wo$",          ("heads", "fsdp")),
    (r"attn/bq$",          ("heads",)),
    (r"attn/b[kv]$",       (None,)),
    (r"attn/(q_norm|k_norm)$", (None,)),
    # MLA
    (r"attn/w_dkv$",       ("fsdp", None)),
    (r"attn/w_krope$",     ("fsdp", None)),
    (r"attn/w_dq$",        ("fsdp", None)),
    (r"attn/w_u[kvq]$",    (None, "heads")),
    (r"attn/kv_norm$",     (None,)),
    # dense MLP
    (r"mlp/w_(up|gate)$",  ("fsdp", "ff")),
    (r"mlp/w_down$",       ("ff", "fsdp")),
    # MoE
    (r"moe/router$",       ("fsdp", None)),
    (r"moe/w_(up|gate)$",  ("expert", "fsdp", None)),
    (r"moe/w_down$",       ("expert", None, "fsdp")),
    (r"moe/shared/w_(up|gate)$", ("fsdp", "ff")),
    (r"moe/shared/w_down$", ("ff", "fsdp")),
    # mamba
    (r"mamba/w_in$",       ("fsdp", "ff")),
    (r"mamba/w_out$",      ("ff", "fsdp")),
    (r"mamba/conv_[wb]$",  None),
    (r"mamba/(A_log|D|dt_bias|norm)$", None),
    # rwkv
    (r"w_(r|k|v|g|ck|cr)$", ("fsdp", "ff")),
    (r"w_(o|cv)$",         ("ff", "fsdp")),
    (r"w_lora_[ab]$",      None),
    (r"(mu_\w+|w0|u|ln_x|ln1|ln2)$", None),
    # norms & defaults
    (r"ln_\w+$",           None),
]


def param_logical_spec(path: str, ndim: int) -> tuple:
    """The logical spec of the parameter at ``path`` (``a/b/c``): the
    first matching rule, padded on the left with ``None`` (a layer axis
    the rule does not name); replicated when no rule matches."""
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            if spec is None:
                return (None,) * ndim
            if len(spec) < ndim:
                return (None,) * (ndim - len(spec)) + tuple(spec)
            return tuple(spec)
    return (None,) * ndim


def _path_str(path) -> str:
    """A tree path (a tuple of dict keys and sequence indices, or a dotted
    parameter name) as the reference's ``a/b/0`` string."""
    if isinstance(path, str):
        return path.replace(".", "/")
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


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _flat_params(params) -> dict:
    """``{dotted name: full shape}`` of a model (its recorded full shapes
    once :func:`~repro_torch.distributed.model_parallel.shard_model` has
    sharded it) or of a flat dict of tensors or shapes."""
    if isinstance(params, dict):
        return {k: _shape(v) for k, v in params.items()}
    from .model_parallel import full_shapes
    return full_shapes(params)


def param_specs(params, mesh, rules: dict | None = None) -> dict:
    """``{dotted name: NamedSharding}`` of a model's parameters (or of a
    flat ``{name: tensor or shape}`` dict: meta tensors do).  Each
    parameter's logical spec (:data:`_PARAM_RULES`) is resolved under
    ``rules`` and guarded by the divisibility and first-wins rule."""
    out = {}
    for name, shape in _flat_params(params).items():
        logical = param_logical_spec(_path_str(name), len(shape))
        with sharding_ctx(mesh, rules):
            spec = resolve_spec(*logical)
        out[name] = NamedSharding(mesh, _clean_spec(shape, spec, mesh))
    return out


def cache_specs(cache, mesh, rules: dict | None = None):
    """The decode cache's shardings, a tree matching ``cache``: heads on
    the model axis, the batch on the data axes, ``kv_seq`` as the rules
    say (context parallelism)."""
    def one(path, leaf):
        name = _path_str(path)
        shape = _shape(leaf)
        ndim = len(shape)
        with sharding_ctx(mesh, rules):
            if re.search(r"(^|/)(k|v|self_k|self_v|cross_k|cross_v)$",
                         name) and ndim == 5:
                # (L, B, S, H, hd)
                spec = resolve_spec(None, "batch", "kv_seq", "kv_heads",
                                    None)
            elif re.search(r"c_kv$", name):
                spec = resolve_spec(None, "batch", "kv_seq", None)
            elif re.search(r"k_rope$", name):
                spec = resolve_spec(None, "batch", "kv_seq", None)
            elif re.search(r"ssm$", name) and ndim == 5:
                # (L, B, nh, hd, ds)
                spec = resolve_spec(None, "batch", "heads", None, None)
            elif re.search(r"wkv$", name) and ndim == 5:
                spec = resolve_spec(None, "batch", "heads", None, None)
            elif re.search(r"conv$", name) and ndim == 4:
                spec = resolve_spec(None, "batch", None, "ff")
            elif re.search(r"(shift_a|shift_c)$", name) and ndim == 3:
                spec = resolve_spec(None, "batch", None)
            else:
                spec = ()
        return NamedSharding(mesh, _clean_spec(shape, spec, mesh))

    return _rebuild(cache, one)


def opt_state_specs(opt_state, params_specs: dict, mesh):
    """Optimizer slots shard exactly like their parameters (ZeRO): a slot
    whose path ends with a parameter's name and has its rank takes its
    spec; factored slots and scalars are replicated."""
    def one(path, leaf):
        ndim = len(_shape(leaf))
        parts = [str(p) for p in path]
        for i in range(len(parts)):      # the longest matching suffix
            sh = params_specs.get("/".join(parts[i:]))
            if sh is not None and len(sh.spec) == ndim:
                return sh
        return NamedSharding(mesh, ())

    return _rebuild(opt_state, one)
