"""Model-parallel execution of the parameter specs: tensor, expert and
FSDP parallelism on a ``("data", "model")`` mesh (the port's counterpart
of what GSPMD does with the reference's ``shard(...)`` annotations).

:func:`shard_model` lays a model out by
:func:`~repro_torch.distributed.sharding.param_specs`: every rank holds
the full tree (initialised from the same generator), keeps its block of
each parameter, and records the parameter's :class:`Placement` on the
``ParamTree`` that owns it.  Then:

- a dimension sharded over an axis other than ``"model"`` (``"fsdp"`` ->
  ``"data"``) is ZeRO-3: ``p[key]`` all-gathers it before its layer runs
  (:class:`GatherScatter`), and the backward reduce-scatters the gradient
  back to the shard, summed over the data ranks;
- a dimension sharded over ``"model"`` is a tensor-parallel block: the
  layer code (:mod:`repro_torch.models.layers`, ``transformer``, ``ssm``)
  runs its heads, columns, experts or vocabulary rows on it.  Activations
  cross the model group through autograd pairs, as in Megatron-LM: at a
  column-parallel input :func:`copy_to` (identity forward, all-reduce
  backward), at a row-parallel output :func:`reduce_from` (all-reduce
  forward, identity backward), and :func:`gather_from` where a replicated
  computation needs the whole of a split tensor (all-gather forward, this
  rank's block of the gradient backward: the computation downstream is
  the same on every rank of the group).

Under the ``"seq"`` rule the ranks of a group hold different blocks of
every sequence, and the blocks exchange activations through two more
pairs: :func:`seq_gather` (all-gather forward, reduce-scatter of the
gradient backward: each rank computes only its own block's share from the
gathered tensor, so every rank's gradient of every block is summed) and
:func:`seq_scatter` (reduce-scatter forward, all-gather backward).  A
gather whose consumer every rank of the group runs the same is
:func:`gather_from`.  Each backward collective is logged under its
forward tag with ``_grad`` appended.

Where the model axis both cuts the sequence and splits a layer's weights
(Megatron-LM's sequence parallelism, :func:`seq_tp`), the layer's input
block is all-gathered over the group in place of :func:`copy_to`
(:func:`tp_enter`, tag ``sp_tp_in``; its backward reduce-scatters the
gradient, which sums the ranks' partial input gradients) and its
row-parallel output is reduce-scattered back to the block in place of
:func:`reduce_from`'s all-reduce (:func:`tp_exit`, ``sp_tp_out``).  Inside
that region every rank runs its heads, columns or experts over the
group's whole sequences, and a weight it reads whole takes no
:func:`copy_to`: its gradient there is the rank's partial one, which the
step's gradient reduction sums over the model axis once (it splits the
batch's tokens), as it sums the gradient of a weight read on the block.
A model-axis block read whole under such a split (:func:`full_view`) is
gathered with the same summing backward.  Where the sequence is cut over
the model axis and other axes (context parallelism), the model group's
blocks are consecutive and gathered make a super-block: the same pairs run
over the model group, and what crosses super-blocks is exchanged over the
other axes (:class:`SeqTP`).

A decode cache is laid out as the reference's ``cache_specs`` place it
(:func:`local_cache`): a :class:`LocalCache` of this rank's blocks, from
which a decode step reads its rows of the requests (:func:`decode_rows`)
and its block of each attention cache's sequence (:func:`cache_split`).

Every collective goes through :mod:`repro_torch.distributed.collectives`
and is logged there with its transport.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import collectives as C
from .ctx import AbstractMesh, NamedSharding, axis_names, axis_size

MODEL = "model"


@dataclasses.dataclass(frozen=True)
class Split:
    """This rank's block of a dimension split over mesh axes: the axes'
    process group, the number of blocks, this rank's index and the axes'
    names in mesh order."""
    group: object
    size: int
    index: int
    axes: tuple = ()
    # the mesh the split was made on (None for one made by hand), from
    # which a split of some of its axes is made (:func:`seq_tp`)
    mesh: object = dataclasses.field(default=None, compare=False,
                                     repr=False)

    def block(self, n: int) -> tuple[int, int]:
        """(start, length) of this rank's block of a dimension of n."""
        per = n // self.size
        return self.index * per, per


@dataclasses.dataclass(frozen=True)
class Placement:
    """A sharded parameter's layout: its sharding and its full shape."""
    sharding: NamedSharding
    shape: tuple

    def __deepcopy__(self, memo):       # a mesh is shared, never copied
        return self

    @property
    def spec(self) -> tuple:
        return self.sharding.spec


_GROUPS: dict = {}


def axes_split(mesh, axes) -> Split:
    """The :class:`Split` of the mesh axes ``axes`` (a name or a tuple of
    names) for this rank: one axis's group, or the group of several axes
    flattened in mesh order.  On an :class:`~repro_torch.distributed.ctx.
    AbstractMesh` (shapes only) it is rank 0's, with no group."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    order = tuple(a for a in axis_names(mesh) if a in names)
    key = (id(mesh), order)
    if key not in _GROUPS:
        from .batch import batch_mesh
        size = 1
        for a in order:
            size *= axis_size(mesh, a)
        if isinstance(mesh, AbstractMesh):
            _GROUPS[key] = (mesh, Split(None, size, 0, order, mesh))
            return _GROUPS[key][1]
        coord = mesh.get_coordinate()
        index = 0
        for a in order:
            index = index * axis_size(mesh, a) + \
                coord[axis_names(mesh).index(a)]
        sub = mesh[order[0]] if len(order) == 1 else batch_mesh(mesh, order)
        _GROUPS[key] = (mesh, Split(sub.get_group(), size, index, order,
                                    mesh))
    return _GROUPS[key][1]


# ---------------------------------------------------------------------------
# autograd pairs
# ---------------------------------------------------------------------------

class CopyTo(torch.autograd.Function):
    """Identity forward, sum over the group backward: a replicated tensor
    entering a computation split over the group."""

    @staticmethod
    def forward(ctx, x, group, tag):
        ctx.group, ctx.tag = group, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return C.all_reduce_(g.contiguous().clone(), ctx.group,
                             tag=ctx.tag), None, None


class ReduceFrom(torch.autograd.Function):
    """Sum over the group forward, identity backward: the partial outputs
    of a split computation added into the replicated result."""

    @staticmethod
    def forward(ctx, x, group, tag):
        return C.all_reduce_(x.contiguous().clone(), group, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class GatherFrom(torch.autograd.Function):
    """All-gather along ``dim`` forward, this rank's block backward: a
    split tensor made whole for a computation that every rank of the
    group runs the same."""

    @staticmethod
    def forward(ctx, x, group, index, dim, tag):
        ctx.index, ctx.dim, ctx.n = index, dim, x.shape[dim]
        return C.all_gather(x, group, dim=dim, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n).contiguous(),
                None, None, None, None)


class GatherScatter(torch.autograd.Function):
    """All-gather along ``dim`` forward, reduce-scatter (sum) of the
    gradient backward: a tensor split over the group made whole for
    computations that differ from rank to rank, each of which
    differentiates its own share (ZeRO-3's parameter gather, the sequence
    blocks' exchanges): the gradient comes back to this rank's block
    summed over the group's ranks."""

    @staticmethod
    def forward(ctx, x, group, dim, tag, grad_tag):
        ctx.group, ctx.dim, ctx.grad_tag = group, dim, grad_tag
        return C.all_gather(x, group, dim=dim, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return C.reduce_scatter(g.contiguous(), ctx.group, dim=ctx.dim,
                                tag=ctx.grad_tag), None, None, None, None


class ScatterGather(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward, all-gather of the gradient
    backward: partial sums over the whole group's rows added and cut back
    to each rank's block (the vocabulary-parallel embedding of a sequence
    in blocks)."""

    @staticmethod
    def forward(ctx, x, group, dim, tag, grad_tag):
        ctx.group, ctx.dim, ctx.grad_tag = group, dim, grad_tag
        return C.reduce_scatter(x.contiguous(), group, dim=dim, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return C.all_gather(g.contiguous(), ctx.group, dim=ctx.dim,
                            tag=ctx.grad_tag), None, None, None, None


def copy_to(x, split: Split | None, tag: str = "tp_in"):
    return x if split is None else CopyTo.apply(x, split.group, tag)


def reduce_from(x, split: Split | None, tag: str = "tp_out"):
    return x if split is None else ReduceFrom.apply(x, split.group, tag)


def gather_from(x, split: Split | None, dim: int = -1,
                tag: str = "tp_gather"):
    if split is None:
        return x
    return GatherFrom.apply(x, split.group, split.index, dim % x.ndim, tag)


def seq_gather(x, split: Split, dim: int, tag: str):
    """Every block of ``x`` over the split's group, concatenated along
    ``dim`` (:class:`GatherScatter`: the backward sums the blocks'
    gradients over the group)."""
    return GatherScatter.apply(x, split.group, dim % x.ndim, tag,
                               tag + "_grad")


def seq_scatter(x, split: Split, dim: int, tag: str):
    """The sum of every rank's ``x`` over the split's group, cut to this
    rank's block along ``dim`` (:class:`ScatterGather`)."""
    return ScatterGather.apply(x, split.group, dim % x.ndim, tag,
                               tag + "_grad")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _dims(placement: Placement):
    """(dim, axes) of each sharded dimension."""
    return [(d, a) for d, a in enumerate(placement.spec) if a is not None]


def fsdp_view(w: torch.Tensor, placement: Placement) -> torch.Tensor:
    """The parameter as its layer uses it: every dimension sharded over
    axes other than the model axis gathered (differentiably), the
    model-axis blocks kept."""
    mesh = placement.sharding.mesh
    for d, axes in _dims(placement):
        if axes != MODEL:
            sp = axes_split(mesh, axes)
            if sp.size > 1:
                w = GatherScatter.apply(w, sp.group, d, "fsdp_gather",
                                        "fsdp_grad")
    return w


def model_split(placement: Placement | None, dim: int) -> Split | None:
    """The model axis's :class:`Split` when ``dim`` of the parameter is a
    tensor-parallel block, else None."""
    if placement is None or placement.spec[dim % len(placement.shape)] \
            != MODEL:
        return None
    sp = axes_split(placement.sharding.mesh, MODEL)
    return sp if sp.size > 1 else None


def full_view(w: torch.Tensor, placement: Placement | None):
    """The whole parameter: its FSDP view with the model-axis blocks
    gathered too: by :func:`gather_from` where the ranks of the model
    group hold the same tokens, and by :class:`GatherScatter` where the
    model axis cuts the sequence (each rank then uses the whole weight
    on its own tokens or heads, and its gradient is summed over the
    group)."""
    if placement is None:
        return w
    w = fsdp_view(w, placement)
    from .batch import current_seq
    seq = current_seq()
    differ = seq is not None and MODEL in seq.axes
    for d in range(len(placement.shape)):
        sp = model_split(placement, d)
        if sp is None:
            continue
        if differ:
            w = GatherScatter.apply(w, sp.group, d, "tp_param_gather",
                                    "tp_param_gather_grad")
        else:
            w = gather_from(w, sp, dim=d, tag="tp_param_gather")
    return w


class SeqTP(NamedTuple):
    """The two levels of a sequence cut over the model axis for a layer
    split over it (:func:`seq_tp`): ``inner``, the model axis's group
    inside the sequence's, over which the layer gathers its input block
    into a super-block of the sequence and reduce-scatters its output
    back; ``outer``, the split of the super-blocks over the sequence's
    other axes, None where the model axis alone cuts the sequence."""
    inner: Split
    outer: Split | None


def seq_tp(split: Split | None, seq) -> SeqTP | None:
    """How a layer split over the model axis (``split``) runs on a block
    of a sequence cut over ``seq``: None where the model axis does not
    cut the sequence (the ranks of ``split`` hold the same tokens) or
    nothing is split, else a :class:`SeqTP`.  Over the model axis alone,
    ``inner`` is ``seq`` and ``outer`` None: every rank runs its share of
    the layer over the group's whole sequences.  Over the model axis and
    others (context parallelism, ``{"seq": ("data", "model")}``) the model
    group of a rank holds consecutive blocks of the sequence, since a
    group's axes are flattened in mesh order with the model axis last:
    its blocks gathered are a super-block, ``inner`` is the model split
    and ``outer`` the super-blocks' split over the other axes (None when
    they have one rank).  A layer then runs its share over its
    super-block and exchanges what crosses super-blocks (keys and
    values, halo rows, states) over ``outer``.  A mesh whose model axis
    is not the last of the sequence's raises."""
    if split is None or seq is None or MODEL not in seq.axes:
        return None
    if tuple(seq.axes) == tuple(split.axes):
        return SeqTP(seq, None)
    rest = tuple(a for a in seq.axes if a != MODEL)
    outer = axes_split(seq.mesh, rest)
    if seq.axes[-1] != MODEL or outer.size * split.size != seq.size or \
            outer.index * split.size + split.index != seq.index:
        raise ValueError(
            f"a sequence cut over {seq.axes} (rank's block {seq.index} of "
            f"{seq.size}) with a layer split over {split.axes} (block "
            f"{split.index} of {split.size}): the model axis must be the "
            f"last of the sequence's, so that a model group holds "
            f"consecutive blocks")
    return SeqTP(split, outer if outer.size > 1 else None)


def tp_enter(x, split: Split | None, whole: SeqTP | None):
    """A split layer's input: its super-block of the sequence under a
    split over an axis that cuts it (``whole``, from :func:`seq_tp`: one
    all-gather over ``whole.inner``, tag ``sp_tp_in``, whose backward
    reduce-scatters), else :func:`copy_to` over ``split``."""
    if whole is not None:
        return seq_gather(x, whole.inner, 1, "sp_tp_in")
    return copy_to(x, split)


def tp_exit(x, split: Split | None, whole: SeqTP | None):
    """A split layer's row-parallel output summed over the group: cut
    back to this rank's block of its super-block under ``whole`` (one
    reduce-scatter over ``whole.inner``, tag ``sp_tp_out``, whose
    backward all-gathers), else :func:`reduce_from` over ``split``."""
    if whole is not None:
        return seq_scatter(x, whole.inner, 1, "sp_tp_out")
    return reduce_from(x, split)


def block(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``sharding``
    (nothing is sent)."""
    whole = x
    for d, axes in enumerate(sharding.spec):
        if axes is not None:
            start, n = axes_split(sharding.mesh, axes).block(x.shape[d])
            x = x.narrow(d, start, n)
    # a copy, so that the full tensor's storage can go
    return x.clone(memory_format=torch.contiguous_format) if x is not whole \
        else x


def _owners(model):
    """(dotted name, owning ParamTree, key) of every parameter."""
    for mname, mod in model.named_modules():
        for key in list(mod._parameters):
            if mod._parameters[key] is not None:
                yield (f"{mname}.{key}" if mname else key), mod, key


def placements(model) -> dict:
    """``{dotted name: Placement}`` of a sharded model's parameters."""
    return {name: mod._placed[key] for name, mod, key in _owners(model)
            if key in getattr(mod, "_placed", {})}


def full_shapes(model) -> dict:
    """``{dotted name: full shape}``: the recorded shape of a sharded
    parameter, else its own."""
    pl = placements(model)
    return {name: tuple(pl[name].shape) if name in pl else
            tuple(mod._parameters[key].shape)
            for name, mod, key in _owners(model)}


def shard_model(model, mesh, rules: dict | None = None):
    """Lay ``model`` (the full tree, the same on every rank) out over the
    mesh by :func:`~repro_torch.distributed.sharding.param_specs`: each
    parameter keeps this rank's block in place (the ``nn.Parameter``
    objects stay) and its owner records the :class:`Placement`.  Returns
    the model."""
    from .sharding import param_specs
    specs = param_specs(model, mesh, rules)
    with torch.no_grad():
        for name, mod, key in list(_owners(model)):
            sh = specs[name]
            if all(a is None for a in sh.spec):
                continue
            p = mod._parameters[key]
            full = tuple(p.shape)
            p.data = block(p.data, sh)
            mod._placed[key] = Placement(sh, full)
    return model


def model_mesh(model):
    """The mesh a model was sharded over (None when no parameter is
    sharded)."""
    pl = placements(model)
    return next(iter(pl.values())).sharding.mesh if pl else None


@torch.no_grad()
def gather_tensor(x: torch.Tensor, placement: Placement) -> torch.Tensor:
    """The full tensor from this rank's block (every rank of the mesh
    calls it; not differentiable)."""
    mesh = placement.sharding.mesh
    for d, axes in _dims(placement):
        x = C.all_gather(x, axes_split(mesh, axes).group, dim=d,
                         tag="gather")
    return x


def gather_params(model) -> dict:
    """``{dotted name: full tensor}`` of a (sharded) model's parameters:
    the reference's arrays on every rank."""
    pl = placements(model)
    return {name: gather_tensor(mod._parameters[key].detach(), pl[name])
            if name in pl else mod._parameters[key].detach()
            for name, mod, key in _owners(model)}


def opt_placements(opt_state, model) -> dict:
    """The optimizer state's layout: a tree of :class:`Placement` (None
    for a replicated leaf) by
    :func:`~repro_torch.distributed.sharding.opt_state_specs`."""
    from .sharding import _rebuild, opt_state_specs
    pl = placements(model)
    mesh = model_mesh(model)
    specs = opt_state_specs(opt_state, {k: p.sharding for k, p in
                                        pl.items()}, mesh)
    shapes = {k: p.shape for k, p in pl.items()}

    def one(path, sh):
        if all(a is None for a in sh.spec):
            return None
        parts = [str(p) for p in path]
        pname = next("/".join(parts[i:]) for i in range(len(parts))
                     if "/".join(parts[i:]) in shapes)
        return Placement(sh, shapes[pname])
    return _rebuild(specs, one)


def gather_opt_state(opt_state, model):
    """The optimizer state with every sharded slot gathered to the
    reference's full array (every rank calls it)."""
    from .sharding import _rebuild, _leaves_with_path
    pl = dict(_leaves_with_path(opt_placements(opt_state, model)))
    return _rebuild(opt_state, lambda path, t: t if pl.get(path) is None
                    else gather_tensor(t, pl[path]))


class LocalCache(dict):
    """A decode cache cut to this rank's blocks (:func:`local_cache`): the
    tree of local tensors, and ``placements``, ``{leaf path:
    Placement}`` (each leaf's sharding and whole shape), from which decode
    reads this rank's rows of the batch (:func:`decode_rows`) and its
    block of each cache's sequence (:func:`cache_split`)."""

    def __init__(self, tree: dict, placements: dict):
        super().__init__(tree)
        self.placements = placements

    def copy(self) -> "LocalCache":
        return LocalCache(self, self.placements)


def local_cache(cache, mesh, rules: dict | None = None, device=None):
    """A decode cache of this rank's blocks of ``cache`` by
    :func:`~repro_torch.distributed.sharding.cache_specs` under ``rules``,
    as the reference lays it out: the batch over the data axes, each
    attention cache's sequence over the axes of ``kv_seq``, heads and
    states over the model axis, where the axes divide the dimension (else
    it stays whole).  The ``index`` leaves are global positions, whole on
    every rank.  Only the leaves' shapes and dtypes are read (meta tensors
    will do): the blocks are a new cache's zeros, on ``device`` (default
    each leaf's own), so the whole cache is never allocated.  Returns a
    :class:`LocalCache`."""
    from .sharding import _leaves_with_path, _rebuild, cache_specs
    specs = dict(_leaves_with_path(cache_specs(cache, mesh, rules)))

    def zeros(path, t):
        return torch.zeros(block(t.to("meta"), specs[path]).shape,
                           dtype=t.dtype,
                           device=t.device if device is None else device)
    return LocalCache(_rebuild(cache, zeros),
                      {path: Placement(specs[path], tuple(t.shape))
                       for path, t in _leaves_with_path(cache)})


def cache_split(cache, path: tuple, dim: int) -> Split | None:
    """The :class:`Split` of dimension ``dim`` of the cache leaf at
    ``path`` (a :class:`LocalCache`'s), None when every rank holds it
    whole."""
    pl = getattr(cache, "placements", {}).get(path)
    if pl is None or pl.spec[dim] is None:
        return None
    sp = axes_split(pl.sharding.mesh, pl.spec[dim])
    return sp if sp.size > 1 else None


def decode_rows(cache, B: int | None = None) -> Split | None:
    """The batch axes' :class:`Split` of the requests of a decode cache
    (every leaf is (L, B, ...) or a 1-D ``index``): None when every rank
    decodes every request.  ``B``, the whole batch a step is given, must
    be the cache's."""
    for path, pl in getattr(cache, "placements", {}).items():
        if len(pl.shape) >= 2:
            if B is not None and B != pl.shape[1]:
                raise ValueError(
                    f"a decode step of {B} requests on a cache of "
                    f"{pl.shape[1]}: pass the whole batch, the same on "
                    f"every rank")
            return cache_split(cache, path, 1)
    return None


def gather_decode_rows(x: torch.Tensor, cache, *, tag: str = "decode_rows"):
    """The whole batch on every rank from this rank's rows ``x`` of a
    decode step on ``cache`` (an all-gather over the batch axes); ``x``
    itself when every rank decodes every request."""
    rows = decode_rows(cache)
    return x if rows is None else C.all_gather(x, rows.group, dim=0,
                                               tag=tag)


def _names(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def grad_reduction(placement: Placement | None, mesh,
                   batch_axes: tuple) -> tuple[tuple, int]:
    """How one rank's gradient of a parameter becomes the step's, the
    batch's rows and blocks split over the mesh axes ``batch_axes``: ->
    (the axes to all-reduce it over, the count to divide it by).  The
    backward of an FSDP gather has summed it over the parameter's axes
    other than the model axis; where the batch is not split over one of
    them, each of its ranks computed the same share and the sum counts it
    that many times.  A batch axis the parameter is not held over is
    summed by the all-reduce; a model-axis block is this rank's whole
    gradient of it over the tokens of its model group (tensor
    parallelism, its sequence-parallel form too, or the vocabulary's
    exchanges under a sequence split), summed here over the batch axes
    that hold other tokens (under context parallelism, the other
    super-blocks).  Under a sequence cut over the model axis a weight it
    does not split is summed over that axis once here, whether the rank
    read it on its block or on its super-block for its heads or experts
    (:func:`seq_tp`): each rank's gradient is then its share, never the
    same as another's."""
    held, summed = set(), set()
    if placement is not None:
        for _, axes in _dims(placement):
            held.update(_names(axes))
            if axes != MODEL:
                summed.update(_names(axes))
    over = 1
    for a in summed - set(batch_axes):
        over *= axis_size(mesh, a)
    return tuple(a for a in batch_axes if a not in held), over


def block_share(placement: Placement | None, mesh) -> float:
    """The weight of one rank's sum over its block in a sum over every rank
    of the mesh: the number of distinct blocks over the mesh's size (1 /
    size for a replicated tensor)."""
    held = 1
    if placement is not None:
        for _, axes in _dims(placement):
            held *= axes_split(mesh, axes).size
    return held / mesh.size()


def sharded_norm(grads: dict, model) -> torch.Tensor:
    """The global norm of sharded gradients: each rank's sum of squares,
    weighted by its :func:`block_share`, added over the mesh (one
    all-reduce)."""
    from .batch import batch_mesh
    pl = placements(model)
    mesh = model_mesh(model)
    total = None
    for name, g in grads.items():
        sq = torch.sum(torch.square(g.float())) * block_share(pl.get(name),
                                                              mesh)
        total = sq if total is None else total + sq
    group = batch_mesh(mesh, axis_names(mesh)).get_group()
    return torch.sqrt(C.all_reduce_(total, group, tag="grad_norm"))


def save_sharded(checkpointer, model, opt_state, step: int, *,
                 write: bool, extra: dict | None = None) -> None:
    """Save the reference's full arrays of a sharded model and its
    optimizer state: every rank gathers (collectively), ``write`` ranks
    (one) write."""
    params = gather_params(model)
    state = gather_opt_state(opt_state, model)
    if write:
        checkpointer.save(params, state, step, extra=extra)


def restore_sharded(checkpointer, model, opt_state, step: int):
    """Restore a checkpoint of full arrays (either package's) onto a
    sharded model and optimizer state: each rank reads the arrays and
    keeps its blocks (``Checkpointer.restore(shardings=)``), copied into
    the parameters in place.  Returns ``(opt_state, extra)``."""
    from .sharding import _leaves_with_path, _rebuild
    pl = placements(model)
    opl = opt_placements(opt_state, model)
    params = {name: mod._parameters[key] for name, mod, key in _owners(model)}

    def empty(t, placement):
        return t if placement is None else t.new_empty(placement.shape)

    full_p = {k: empty(t.detach(), pl.get(k)) for k, t in params.items()}
    opl_flat = dict(_leaves_with_path(opl))
    full_o = _rebuild(opt_state, lambda path, t: empty(t, opl_flat.get(path)))
    sh = {"params": {k: None if k not in pl else pl[k].sharding
                     for k in params},
          "opt_state": _rebuild(opl, lambda path, p: None if p is None
                                else p.sharding)}
    got_p, got_o, extra = checkpointer.restore(full_p, full_o, step,
                                               shardings=sh)

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t
    with torch.no_grad():
        for k, t in params.items():
            t.copy_(local(got_p[k]))
    return _rebuild(got_o, lambda path, t: local(t)), extra
