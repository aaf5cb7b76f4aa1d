"""The batch layout of the mesh path: which rows a rank owns, and the move
between a rank's rows and a batch-sharded DTensor.

The reference pads the batch to a multiple of the shard count P with zero
rows and splits it evenly (``kernels/ops.py::_pad_rows``): rank r owns
rows [r·c, (r+1)·c) of the padded batch, c = ⌈B/P⌉.  Its true rows, the
first ``min(c, B − r·c)`` of them, are exactly the block
``torch.chunk``-style ``Shard(0)`` gives rank r of a (B, ...) DTensor, so
the sharded results are DTensors of the true global shape with no padding
left in them.  (Port-only module: the reference's arrays carry their
layout.)

Under a ``"seq"`` rule (``launch.dryrun.rules_for``'s prefill and train
cells) a placed leaf is also cut on its sequence: :func:`rows_scope`
installs that split with the rows (``Rows.seq``), and the layers that run
a block of a sequence read it (:func:`current_seq`); the paths that cannot
refuse it (:func:`refuse_seq`).  A loss over such a batch is summed over
the ranks of every axis that splits it (:func:`shard_group`).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import torch

from .ctx import axis_names, axis_size


def batch_mesh(mesh, names: tuple):
    """The 1-D mesh of the batch axes ``names`` (several axes flattened
    into one, in mesh order)."""
    if mesh.ndim == 1:
        return mesh
    if len(names) == 1:
        return mesh[names[0]]
    order = tuple(a for a in axis_names(mesh) if a in names)
    return mesh[order]._flatten()


def rows_of(B: int, P: int, r: int) -> tuple[int, int, int]:
    """-> (start, true rows, padded rows c) of rank r's block of a batch of
    B rows over P shards."""
    c = -(-B // P)
    start = min(B, r * c)
    return start, max(0, min(c, B - r * c)), c


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(1, n)
    return tuple(reversed(stride))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_rows(x, bmesh, B: int | None = None, pad: bool = True):
    """This rank's rows of a batch: ``x.to_local()`` for a DTensor (placed
    ``Shard(0)`` over the batch axes), rows [start, start + n) of a plain
    tensor (the full batch, the same on every rank).  ``pad`` zero-pads
    them to the block's c rows."""
    P, r = bmesh.size(), bmesh.get_local_rank()
    if B is None:
        B = x.shape[0]
    start, n, c = rows_of(B, P, r)
    if is_dtensor(x):
        loc = x.to_local()
        if loc.shape[0] != n:
            raise ValueError(
                f"a batch DTensor of {B} rows over {P} shards holds "
                f"{loc.shape[0]} rows on rank {r}, expected {n}: place it "
                f"Shard(0) over the mesh's batch axes")
    else:
        loc = x[start:start + n]
    if pad and n < c:
        loc = torch.nn.functional.pad(
            loc, (0, 0) * (loc.ndim - 1) + (0, c - n))
    return loc


def from_rows(local: torch.Tensor, bmesh, B: int):
    """A rank's true rows -> the (B, ...) DTensor placed ``Shard(0)`` on
    the batch mesh (differentiable: the gradient comes back as the rank's
    rows of the output's gradient)."""
    from torch.distributed.tensor import DTensor, Shard
    shape = (B,) + tuple(local.shape[1:])
    return DTensor.from_local(local, bmesh, [Shard(0)], run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def rows_like(local: torch.Tensor, ref):
    """``local`` rows laid out as the batch DTensor ``ref``'s rows are (same
    mesh, its rows over the same axes, replicated over the others, which
    may cut its sequence; the global row count); ``local`` itself when
    ``ref`` is a plain tensor or holds every row (its rows whole, or
    split over axes of size 1)."""
    if not is_dtensor(ref):
        return local
    axes = _sharding_axes(ref, 0)
    if not axes or math.prod(axis_size(ref.device_mesh, a)
                             for a in axes) == 1:
        return local
    from torch.distributed.tensor import DTensor, Replicate, Shard
    shape = (ref.shape[0],) + tuple(local.shape[1:])
    rows = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in ref.placements)
    return DTensor.from_local(local, ref.device_mesh, rows,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def group_of(x):
    """The process group over the mesh axes that shard a batch DTensor's
    rows (its whole mesh when that is 1-D)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    if mesh.ndim == 1:
        return mesh.get_group()
    names = tuple(n for n, p in zip(axis_names(mesh), x.placements)
                  if isinstance(p, Shard) and p.dim == 0)
    return batch_mesh(mesh, names).get_group()


def shard_axes(x) -> tuple:
    """The mesh axes (in mesh order) over which a batch DTensor is split
    on any dimension: its rows' and, under the ``"seq"`` rule, its
    sequence's; the ranks along them hold different tokens."""
    from torch.distributed.tensor import Shard
    return tuple(n for n, p in zip(axis_names(x.device_mesh), x.placements)
                 if isinstance(p, Shard))


def shard_group(x):
    """The process group over :func:`shard_axes` (its whole mesh when that
    is 1-D): the ranks over which a loss of the batch DTensor ``x`` is
    summed."""
    mesh = x.device_mesh
    if mesh.ndim == 1:
        return mesh.get_group()
    return batch_mesh(mesh, shard_axes(x)).get_group()


def to_local(x):
    """A DTensor's local block, anything else as it is."""
    return x.to_local() if is_dtensor(x) else x


def gather_rows(x, *, tag: str = "gather"):
    """The whole (B, ...) tensor on every rank from a batch DTensor, by the
    group's all-gather (staged through the host on a gloo group of CUDA
    tensors); a plain tensor comes back as it is.  Not differentiable."""
    if not is_dtensor(x):
        return x
    from . import collectives as C
    mesh = x.device_mesh
    if mesh.ndim != 1:
        raise ValueError("gather_rows takes a DTensor on a 1-D batch mesh")
    B, P = x.shape[0], mesh.size()
    _, n, c = rows_of(B, P, mesh.get_local_rank())
    loc = x.to_local().detach()
    if n < c:
        loc = torch.nn.functional.pad(loc, (0, 0) * (loc.ndim - 1) + (0, c - n))
    return C.all_gather(loc, mesh.get_group(), tag=tag)[:B]


@dataclasses.dataclass(frozen=True)
class Rows:
    """This rank's rows of a placed batch: the group over the batch axes
    (None where the batch is whole on every rank), the global row count
    B, this rank's first row and its row count; and ``seq``, the
    :class:`~repro_torch.distributed.model_parallel.Split` of the axes
    that cut the sequence (the ``"seq"`` rule), under which each rank
    holds block ``seq.index`` of every sequence, its first position
    ``seq.index`` times its length (None when the sequence is whole)."""
    group: object
    B: int
    start: int
    n: int
    seq: object = None

    def seq_start(self, n: int) -> int:
        """The global position of this rank's first of a block of n."""
        return 0 if self.seq is None else self.seq.index * n


_ROWS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_rows", default=None)


def _sharding_axes(x, dim: int) -> tuple:
    """The mesh axes (in mesh order) over which a DTensor is sharded on
    ``dim``."""
    from torch.distributed.tensor import Shard
    return tuple(n for n, p in zip(axis_names(x.device_mesh), x.placements)
                 if isinstance(p, Shard) and p.dim == dim)


def seq_split(x, dim: int = 1):
    """The :class:`~repro_torch.distributed.model_parallel.Split` of the
    axes that cut a placed batch leaf's sequence (dimension ``dim``: 1 for
    (B, S, ...) leaves, 2 for M-RoPE's (3, B, S) positions), None for a
    plain tensor or a whole sequence."""
    if not is_dtensor(x):
        return None
    axes = _sharding_axes(x, dim)
    if not axes:
        return None
    from .model_parallel import axes_split
    return axes_split(x.device_mesh, axes)


@contextlib.contextmanager
def rows_scope(placed):
    """Run a block that computes on this rank's rows of the placed batch
    DTensor ``placed``: statistics over the global batch (the MoE aux
    loss and dispatch groups) read :func:`current_rows`, and so do the
    layers that run a block of a sequence cut over the ``"seq"`` rule's
    axes (``Rows.seq``).  A plain tensor installs nothing."""
    if not is_dtensor(placed):
        yield None
        return
    B = placed.shape[0]
    if _sharding_axes(placed, 0):
        import torch.distributed as dist
        group = group_of(placed)
        start, n, _ = rows_of(B, dist.get_world_size(group),
                              dist.get_rank(group))
    else:
        group, start, n = None, 0, B
    token = _ROWS.set(Rows(group, B, start, n, seq_split(placed)))
    try:
        yield _ROWS.get()
    finally:
        _ROWS.reset(token)


def current_rows():
    """The :class:`Rows` of the innermost :func:`rows_scope` (None outside
    one)."""
    return _ROWS.get()


def current_seq():
    """The sequence :class:`~repro_torch.distributed.model_parallel.Split`
    of the innermost :func:`rows_scope` (None outside one, or where the
    sequence is whole)."""
    rows = _ROWS.get()
    return None if rows is None else rows.seq


ITEM_21 = ("ROADMAP item 21's remainder (whisper trained with its frames "
           "cut and its tokens whole, or with its tokens cut over the "
           "model axis and its frames not while its encoder runs tensor "
           "parallelism over that axis; a decode step whose tokens are "
           "cut)")


def whole_seq(x, dim: int = 1, *, tag: str = "gather"):
    """A batch DTensor whose sequence (dimension ``dim``) is cut, made
    whole: this rank's block all-gathered over the split's group, placed
    on its rows only (not differentiable: data, such as reference paths
    or a mask).  Anything else comes back as it is."""
    sp = seq_split(x, dim)
    if sp is None:
        return x
    from . import collectives as C
    return rows_like(C.all_gather(x.to_local(), sp.group, dim=dim, tag=tag),
                     x)


def batch_seq(batch: dict):
    """The sequence split of a placed batch: that of its first leaf whose
    sequence is cut (M-RoPE's (3, B, S) ``positions`` on dimension 2,
    other leaves of two or more dimensions on 1), else None."""
    for k, v in batch.items():
        if is_dtensor(v) and v.ndim >= 2:
            sp = seq_split(v, 2 if k.endswith("positions") and v.ndim == 3
                           else 1)
            if sp is not None:
                return sp
    return None


def refuse_seq(where: str, batch: dict | None = None) -> None:
    """Raise ``NotImplementedError`` when the innermost :func:`rows_scope`
    (or the placed ``batch``) holds a block of a sequence cut over the
    ``"seq"`` rule's axes: only the prefill and the train and eval steps
    run such a block; ``where`` names the path refused."""
    if current_seq() is not None or (batch is not None
                                     and batch_seq(batch) is not None):
        raise NotImplementedError(
            f"{where} on a batch whose sequence is cut over the mesh (the "
            f"'seq' rule) would compute a block as if it were the whole "
            f"sequence: only the prefill and the train and eval steps run "
            f"under a sequence split; {ITEM_21} is not ported")


@contextlib.contextmanager
def rows_set(rows):
    """Install ``rows`` (a :func:`current_rows` taken earlier, or None):
    a layer recomputed in the backward sees the rows its forward saw."""
    token = _ROWS.set(rows)
    try:
        yield rows
    finally:
        _ROWS.reset(token)


def microbatches(x, n: int) -> list:
    """The ``n`` microbatches of a batch leaf, the reference's contiguous
    slices of the global batch: microbatch i holds global rows
    [i·B/n, (i+1)·B/n).  A placed leaf (a DTensor over the batch axes)
    gives placed microbatches: rank r's block of microbatch i is the r-th
    shard of those rows, gathered from the ranks that hold them (one
    all-gather of the leaf's rows over the batch group a step; every
    microbatch must split evenly, B divisible by n times the shard
    count), its block of the sequence kept.  A plain leaf, or a placed one
    whose rows are whole, is sliced on its first axis."""
    from torch.distributed.tensor import DTensor

    def placed(loc):
        shape = (x.shape[0] // n,) + tuple(x.shape[1:])
        return DTensor.from_local(loc, x.device_mesh, x.placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))
    if not is_dtensor(x) or not _sharding_axes(x, 0):
        loc = to_local(x)
        per = loc.shape[0] // n
        parts = [loc[i * per:(i + 1) * per] for i in range(n)]
        return [placed(p) for p in parts] if is_dtensor(x) else parts
    import torch.distributed as dist
    from . import collectives as C
    B, group = x.shape[0], group_of(x)
    P, r = dist.get_world_size(group), dist.get_rank(group)
    if B % (n * P):
        raise ValueError(
            f"microbatch {n} of a batch of {B} rows over {P} shards: the "
            f"rows must split evenly, B divisible by {n * P}")
    whole = C.all_gather(x.to_local(), group, tag="microbatch")
    per = B // (n * P)
    return [placed(whole[(i * P + r) * per:(i * P + r + 1) * per])
            for i in range(n)]
