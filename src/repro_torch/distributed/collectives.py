"""The port's collectives: transport, a differentiable all-reduce for
losses, the ring step of the Gram, and a log of every collective issued.

The reference's collectives are ``jax.lax`` calls that XLA schedules; the
port issues ``torch.distributed`` calls on the mesh's process group, and
this module is the one place that does so.

Transport follows the group's backend (``dist.get_backend(group)``):

- ``nccl`` takes CUDA tensors for every operation;
- ``gloo`` takes CPU tensors for every operation, and CUDA tensors for
  ``all_reduce`` and ``broadcast`` only (PyTorch's backend table).  So on a
  gloo group a CUDA tensor's ``send``/``recv`` and ``all_gather`` are
  staged through a host buffer: the tensor is copied to the host, sent,
  and the received buffer copied back.  That is gloo's only transport for
  those operations, not a fallback: the kernels run on the card either
  way.
- ``fake`` (``torch.testing._internal.distributed.fake_pg``, the dry
  run's world of meta tensors) accepts every operation but a send/recv,
  which it cannot take for a meta tensor: the ring's permutes are logged
  with their bytes and nothing is issued.  gloo has no reduce-scatter for any tensor: on a gloo group it is
  an all-reduce of the whole tensor of which each rank keeps its block
  (``"gloo-allreduce"``).  The choice is logged once per (backend,
  operation).

Every operation appends a record to :data:`LOG` (kind, result bytes, wire
bytes by the ring model of ``repro.distributed.hlo``, group size, order),
which :func:`repro_torch.distributed.hlo.collective_stats` and
:func:`~repro_torch.distributed.hlo.ring_overlap` read in place of the
reference's lowered HLO.
"""
from __future__ import annotations

import collections
import dataclasses
import logging

import torch
import torch.distributed as dist

from ..obs.compile import freed_on_return

_logger = logging.getLogger(__name__)

# the reference's HLO collective kinds
ALL_REDUCE = "all-reduce"
ALL_GATHER = "all-gather"
REDUCE_SCATTER = "reduce-scatter"
BROADCAST = "broadcast"
PERMUTE = "collective-permute"


@dataclasses.dataclass
class Record:
    kind: str               # a collective kind, or a marker ("tile", ...)
    result_bytes: int = 0   # bytes of the operation's result on this rank
    wire_bytes: float = 0.0
    group_size: int = 1
    tag: str = ""           # the caller's site ("gram_ring", "loss", ...)
    step: int = -1          # ring step (markers and permutes)
    transport: str = ""
    ranks: tuple = ()       # the group's global ranks


class CollectiveLog:
    """Bounded, ordered record of the collectives this process issued (and
    the ring's tile markers), with the transport each one took."""

    def __init__(self, maxlen: int = 100_000):
        self.records: collections.deque = collections.deque(maxlen=maxlen)
        self.transports: dict[str, str] = {}

    def reset(self) -> None:
        self.records.clear()

    def add(self, rec: Record) -> None:
        self.records.append(rec)
        if rec.transport:
            self.transports[rec.kind] = rec.transport

    def mark(self, kind: str, *, tag: str = "", step: int = -1) -> None:
        self.records.append(Record(kind, tag=tag, step=step))


LOG = CollectiveLog()
_ANNOUNCED: set = set()


def _wire(kind: str, nbytes: int, n: int) -> float:
    """Per-rank wire bytes by the ring model of the reference's
    ``collective_stats``."""
    if kind == ALL_REDUCE:
        return 2.0 * nbytes * (n - 1) / max(n, 1)
    if kind in (ALL_GATHER, BROADCAST):
        return nbytes * (n - 1) / max(n, 1)
    if kind == REDUCE_SCATTER:      # the result is the scattered block
        return float(nbytes * (n - 1))
    return float(nbytes)


def transport(group, t: torch.Tensor, kind: str) -> str:
    """``"nccl"``, ``"gloo"`` or ``"gloo-host"`` (a CUDA tensor staged
    through a host buffer) for one operation of ``kind`` on ``group``."""
    backend = str(dist.get_backend(group))
    if backend == "gloo" and kind == REDUCE_SCATTER:
        how = "gloo-allreduce"
    elif t.device.type == "cuda" and backend == "gloo" \
            and kind not in (ALL_REDUCE, BROADCAST):
        how = "gloo-host"
    else:
        how = backend
    if (backend, kind, how) not in _ANNOUNCED:
        _ANNOUNCED.add((backend, kind, how))
        _logger.info("collectives: %s on a %s group of %s tensors goes by "
                     "%s", kind, backend, t.device.type, how)
    return how


_RANKS: dict = {}


def group_ranks(group) -> tuple:
    """The group's global ranks (one shared tuple a group)."""
    key = id(group)
    if key not in _RANKS or _RANKS[key][0] is not group:
        _RANKS[key] = (group, tuple(dist.get_process_group_ranks(group)))
    return _RANKS[key][1]


def _log(kind: str, t: torch.Tensor, group, how: str, *, tag: str = "",
         step: int = -1) -> None:
    n = dist.get_world_size(group)
    nbytes = t.numel() * t.element_size()
    LOG.add(Record(kind, nbytes, _wire(kind, nbytes, n), n, tag, step, how,
                   group_ranks(group)))


def all_reduce_(t: torch.Tensor, group, *, tag: str = "",
                op: str = "sum") -> torch.Tensor:
    """Sum (``op="max"``: the maximum of) ``t`` over the group, in place;
    returns ``t``."""
    how = transport(group, t, ALL_REDUCE)
    if op == "max":
        # gloo's CUDA all-reduce is a sum: a maximum is staged on the host
        if how == "gloo" and t.device.type == "cuda":
            how = "gloo-host"
        src = t.cpu() if how == "gloo-host" else t
        dist.all_reduce(src, op=dist.ReduceOp.MAX, group=group)
        if src is not t:
            t.copy_(src)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    _log(ALL_REDUCE, t, group, how, tag=tag)
    return t


def broadcast_(t: torch.Tensor, src_index: int, group, *,
               tag: str = "") -> torch.Tensor:
    """Overwrite ``t`` with the group member ``src_index``'s, in place."""
    how = transport(group, t, BROADCAST)
    dist.broadcast(t, dist.get_global_rank(group, src_index), group=group)
    _log(BROADCAST, t, group, how, tag=tag)
    return t


def all_gather(t: torch.Tensor, group, *, tag: str = "",
               dim: int = 0) -> torch.Tensor:
    """Every member's ``t`` (equal shapes) concatenated along ``dim`` in
    group order."""
    how = transport(group, t, ALL_GATHER)
    n = dist.get_world_size(group)
    with freed_on_return() as keep:
        src = t.detach().contiguous()
        if how == "gloo-host":
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=dim).to(t.device)
        keep(out)
    _log(ALL_GATHER, out, group, how, tag=tag)
    return out


def reduce_scatter(t: torch.Tensor, group, *, tag: str = "",
                   dim: int = 0) -> torch.Tensor:
    """The sum of every member's ``t`` over the group, of which this rank
    keeps its block along ``dim`` (``t.shape[dim]`` divisible by the group
    size, blocks in group order)."""
    how = transport(group, t, REDUCE_SCATTER)
    n, me = dist.get_world_size(group), dist.get_rank(group)
    per = t.shape[dim] // n
    if how == "gloo-allreduce":
        with freed_on_return() as keep:
            full = t.detach().clone()
            dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
            out = full.narrow(dim, me * per, per).contiguous()
            keep(out)
    else:
        src = t.detach().movedim(dim, 0).contiguous()
        out = src.new_empty((per,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        out = out.movedim(0, dim).contiguous()
    _log(REDUCE_SCATTER, out, group, how, tag=tag)
    return out


class RingShift:
    """One non-blocking ring step: ``tensors`` go to the neighbour
    ``direction`` places round the group (-1: the left neighbour, as the
    reference's ``ppermute((i, i-1))``) while the same shapes arrive from
    the other side.  :meth:`wait` returns the received tensors on the
    sender's device."""

    def __init__(self, tensors, group, *, direction: int = -1,
                 tag: str = "", step: int = -1):
        n = dist.get_world_size(group)
        me = dist.get_rank(group)
        dst = dist.get_global_rank(group, (me + direction) % n)
        src = dist.get_global_rank(group, (me - direction) % n)
        self.device = tensors[0].device
        ops, self.recv = [], []
        for t in tensors:
            how = transport(group, t, PERMUTE)
            send = t.detach().contiguous()
            if how == "gloo-host":
                send = send.cpu()
            recv = torch.empty_like(send)
            ops += [dist.P2POp(dist.isend, send, dst, group),
                    dist.P2POp(dist.irecv, recv, src, group)]
            self.recv.append(recv)
            _log(PERMUTE, t, group, how, tag=tag, step=step)
        self._keep = ops          # the send buffers live until wait()
        # torch.distributed's fake backend (the dry run's world) takes no
        # send/recv of meta tensors: the permutes are logged, nothing moves
        fake = str(dist.get_backend(group)) == "fake"
        self.reqs = [] if fake else dist.batch_isend_irecv(ops)

    def wait(self) -> list:
        for r in self.reqs:
            r.wait()
        self._keep = None
        return [r.to(self.device, non_blocking=True) for r in self.recv]


class AllReduceSum(torch.autograd.Function):
    """Sum over the group with an identity backward: every rank holds the
    same (replicated) loss, and its backward gives each rank the gradient
    of that one loss with respect to its own inputs.  (Summing again in
    the backward would count the loss P times.)"""

    @staticmethod
    def forward(ctx, t, group, tag):
        return all_reduce_(t.detach().clone(), group, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def reduce_sum(t: torch.Tensor, group, *, tag: str = "loss") -> torch.Tensor:
    """Differentiable sum of ``t`` over the group (see
    :class:`AllReduceSum`)."""
    return AllReduceSum.apply(t, group, tag)
