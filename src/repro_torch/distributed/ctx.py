"""Logical-axis sharding context over a ``torch.distributed`` device mesh.

Port of ``repro.distributed.ctx``.  Code annotates tensors with *logical*
axis names; a launcher installs a mesh and a rule set that maps them to
mesh axes.  Outside any context the annotations are no-ops, so the same
code runs on one card and on a mesh of ranks.

The mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with the
reference's axis names (``"data"``, ``"model"``, optionally ``"pod"``),
built by :mod:`repro_torch.launch.mesh` on the default process group.
Where the reference answers a ``PartitionSpec``, :func:`resolve_spec`
answers a tuple with one entry per tensor dimension: ``None``, a mesh
axis name, or a tuple of names.  :func:`named_sharding` turns one into
DTensor placements on the mesh (:class:`NamedSharding`).

Rules are a mutable dict, as in the reference: a caller flips entries
(``"kv_seq": "data"``) and runs again.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import torch

_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_sharding_ctx", default=None)

# default logical-axis rules; tuple values mean "sharded over several axes"
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),   # axes absent from the mesh are dropped
    "seq": None,
    "kv_seq": None,             # flipped to "data" for long-context decode
    "model": "model",
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "embed": None,
    "expert": "model",
    # expert-slot axis of the MoE dispatch (E, slots, d): the factors of the
    # token sharding not consumed by the expert axis
    "moe_slots": ("pod", "data"),
    "fsdp": "data",             # parameter sharding axis (ZeRO-3)
    # signature-stack axes (repro_torch.kernels.ops mesh path): the time axis
    # of a path and the word-coordinate axis of a signature are never
    # sharded by default; they exist as logical names so rules can annotate
    # them without touching the batch split.
    "path_time": None,
    "sig_words": None,
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no process group behind them (the
    counterpart of ``jax.sharding.AbstractMesh``): the spec functions of
    :mod:`repro_torch.distributed.sharding` read nothing else, so a
    production mesh (16 x 16, 2 x 16 x 16) can be specified on one
    process."""
    shape: tuple
    mesh_dim_names: tuple

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.mesh_dim_names} differ in length")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def axis_names(mesh) -> tuple[str, ...]:
    """The mesh's axis names (a DeviceMesh's ``mesh_dim_names``)."""
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, name: str) -> int:
    """The number of ranks along one named mesh axis."""
    return int(mesh.shape[axis_names(mesh).index(name)])


@contextlib.contextmanager
def sharding_ctx(mesh, rules: dict | None = None):
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    token = _CTX.set((mesh, merged))
    try:
        yield
    finally:
        _CTX.reset(token)


@contextlib.contextmanager
def no_mesh():
    """Run a block with no sharding context: code that computes on one
    rank's own rows (a session pool's block) takes the single-device
    path."""
    token = _CTX.set(None)
    try:
        yield
    finally:
        _CTX.reset(token)


def current_mesh():
    ctx = _CTX.get()
    return ctx[0] if ctx else None


def current_rules() -> Optional[dict]:
    """The merged rule dict of the innermost context (None outside any)."""
    ctx = _CTX.get()
    return ctx[1] if ctx else None


def logical_axes(logical: str) -> tuple[str, ...]:
    """Mesh axis names a logical axis maps to under the current context
    (() outside any context, when the rule is None, or when no mapped axis
    is present in the mesh)."""
    ctx = _CTX.get()
    if ctx is None:
        return ()
    mesh, rules = ctx
    r = rules.get(logical)
    if r is None:
        return ()
    names = (r,) if isinstance(r, str) else tuple(r)
    present = set(axis_names(mesh))
    return tuple(a for a in names if a in present)


def logical_axis_size(logical: str) -> int:
    """Total number of shards of a logical axis under the current context
    (1 outside any context or when unmapped)."""
    ctx = _CTX.get()
    if ctx is None:
        return 1
    size = 1
    for a in logical_axes(logical):
        size *= axis_size(ctx[0], a)
    return size


def resolve_spec(*logical: Optional[str]) -> Optional[tuple]:
    """Logical axis names -> one entry per dimension (None, a mesh axis
    name or a tuple of them) under the current rules; None outside any
    context."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    mesh, rules = ctx
    names = set(axis_names(mesh))
    dims = []
    for lg in logical:
        r = None if lg is None else rules.get(lg)
        if r is None:
            dims.append(None)
        elif isinstance(r, tuple):
            use = tuple(a for a in r if a in names)
            dims.append(use if use else None)
        else:
            dims.append(r if r in names else None)
    return tuple(dims)


def clean_spec(shape, spec, mesh) -> tuple:
    """Divisibility and uniqueness guard (the reference's
    ``distributed.sharding._clean_spec``): a dimension that its mesh axes
    do not divide stays unsharded, and a mesh axis shards at most one
    dimension (the first wins)."""
    spec = tuple(spec or ())
    clean = []
    used: set = set()
    for dim, axes in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        if axes is None:
            clean.append(None)
            continue
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        names = tuple(a for a in names if a not in used)
        size = 1
        for a in names:
            size *= axis_size(mesh, a)
        if not names or dim % size:
            clean.append(None)
        else:
            used.update(names)
            clean.append(names if len(names) > 1 else names[0])
    return tuple(clean)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A per-dimension spec on a mesh, the counterpart of
    ``jax.sharding.NamedSharding``: :meth:`placements` gives DTensor
    placements, one per mesh axis, and :meth:`place` lays a full tensor
    (the same on every rank) out against them without communication."""
    mesh: object
    spec: tuple

    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in axis_names(self.mesh):
            dim = next((i for i, axes in enumerate(self.spec)
                        if axes == name or (isinstance(axes, tuple)
                                            and name in axes)), None)
            out.append(Replicate() if dim is None else Shard(dim))
        return tuple(out)

    def place(self, x: torch.Tensor):
        """The full tensor ``x`` -> a DTensor holding this rank's block of
        every sharded dimension (each rank slices its own block: nothing
        is sent), or ``x`` itself when the spec shards nothing."""
        from torch.distributed.tensor import DTensor
        spec = clean_spec(x.shape, self.spec, self.mesh)
        if all(a is None for a in spec):
            return x
        sh = NamedSharding(self.mesh, spec)
        local = x
        coord = self.mesh.get_coordinate()
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            names = (axes,) if isinstance(axes, str) else axes
            size, pos = 1, 0
            for a in names:
                n = axis_size(self.mesh, a)
                pos = pos * n + coord[axis_names(self.mesh).index(a)]
                size *= n
            per = x.shape[dim] // size
            local = local.narrow(dim, pos * per, per)
        return DTensor.from_local(local.contiguous(), self.mesh,
                                  sh.placements(), run_check=False,
                                  shape=x.shape,
                                  stride=torch.empty(x.shape,
                                                     device="meta").stride())


def shard(x, *logical: Optional[str]):
    """Constrain a DTensor's layout under the current logical rules (no-op
    when no mesh is installed, and on a plain tensor, which every rank
    holds whole).  Dimensions that their axes do not divide are left
    unsharded and a mesh axis shards one dimension at most, as in the
    reference."""
    from torch.distributed.tensor import DTensor
    spec = resolve_spec(*logical)
    ctx = _CTX.get()
    if spec is None or ctx is None or not isinstance(x, DTensor):
        return x
    mesh = ctx[0]
    want = NamedSharding(mesh, clean_spec(x.shape, spec, mesh)).placements()
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def named_sharding(*logical: Optional[str]) -> Optional[NamedSharding]:
    ctx = _CTX.get()
    if ctx is None:
        return None
    return NamedSharding(ctx[0], resolve_spec(*logical))
