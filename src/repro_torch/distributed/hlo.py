"""Collective, donation and remat accounting: the counterpart of
``repro.distributed.hlo``.

The reference parses the optimized HLO of a lowered computation.  The port
has no HLO: its collectives are the ``torch.distributed`` calls of
:mod:`repro_torch.distributed.collectives`, each recorded in order in
:data:`~repro_torch.distributed.collectives.LOG`.  These functions read
that record and answer with the reference's dataclasses.  Clear the log
(``LOG.reset()``) before the computation to be accounted.

Donation: the reference counts the input/output-aliased buffers of a
lowered computation.  The port's counterpart of a donated buffer is one
updated in place: :func:`buffer_ptrs` records the ``data_ptr`` of every
parameter and cache leaf before a step, and :func:`donation_stats`
counts the leaves still at the same address after it.

Remat: the reference counts repeated dot shapes in the HLO.
:func:`remat_duplication` records the matmuls of one forward plus
backward (``obs.compile.CostCounter``) and answers their count over their
unique (operation, shapes, dtype) keys: recomputed layers repeat the
same products, so ``remat="full"`` gives a larger ratio than
``"none"``.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch

from ..obs.compile import CostCounter
from .collectives import LOG, PERMUTE

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute", "broadcast")


@dataclasses.dataclass
class CollectiveStats:
    # per-kind: [count, result_bytes, wire_bytes_per_device]
    by_kind: dict
    total_wire_bytes: float   # per device, ring-model estimate
    total_result_bytes: float

    def summary(self) -> str:
        lines = [f"{k}: n={v[0]} result={v[1]/2**20:.1f}MiB "
                 f"wire/dev={v[2]/2**20:.1f}MiB" for k, v in
                 sorted(self.by_kind.items())]
        lines.append(f"TOTAL wire/device = {self.total_wire_bytes/2**20:.1f} MiB")
        return "\n".join(lines)


def collective_stats(records=None, *, tag: str | None = None
                     ) -> CollectiveStats:
    """Count, result bytes and ring-model wire bytes by kind over the
    recorded collectives (``records`` defaults to the whole log; ``tag``
    keeps one site's, e.g. ``"gram_ring"``)."""
    recs = LOG.records if records is None else records
    by_kind = defaultdict(lambda: [0, 0.0, 0.0])
    for r in recs:
        if r.kind not in _COLLECTIVES or (tag is not None and r.tag != tag):
            continue
        s = by_kind[r.kind]
        s[0] += 1
        s[1] += r.result_bytes
        s[2] += r.wire_bytes
    total_wire = sum(v[2] for v in by_kind.values())
    total_res = sum(v[1] for v in by_kind.values())
    return CollectiveStats(dict(by_kind), total_wire, total_res)


@dataclasses.dataclass
class RingOverlap:
    n_permutes: int
    n_dots: int
    in_loop: bool                 # a permute waited on before its tile ran
    permute_depends_on_dot: bool  # a step's permute was issued after its tile

    @property
    def overlapped(self) -> bool:
        """True when every step's permute for the next shard was posted
        before the current tile's kernel launch, so the transfer can run
        under the tile."""
        return (self.n_permutes > 0 and self.n_dots > 0
                and not self.in_loop and not self.permute_depends_on_dot)

    def summary(self) -> str:
        return (f"permutes={self.n_permutes} dots={self.n_dots} "
                f"in_loop={self.in_loop} "
                f"permute_depends_on_dot={self.permute_depends_on_dot}")


def ring_overlap(records=None, *, tag: str = "gram_ring") -> RingOverlap:
    """Check the issue order of the last Gram-ring forward in the log.

    The ring marks ``ring_start`` and ``ring_end``; between them each step
    s posts the send/recv of the next shard (a ``collective-permute``
    record of step s) and marks its tile launch (``tile``, step s).  The
    ring overlaps when, for every step but the last, the permute precedes
    the tile (``permute_depends_on_dot`` false) and no step waits on its
    permute before its tile is launched (``in_loop`` false: the transfer
    and the tile are not serialised).
    ``n_dots`` counts the tile launches, ``n_permutes`` the permutes (P−1
    for a ring of P).
    """
    recs = list(LOG.records if records is None else records)
    start = max((i for i, r in enumerate(recs)
                 if r.kind == "ring_start" and r.tag == tag), default=None)
    if start is None:
        return RingOverlap(0, 0, False, False)
    end = next((i for i in range(start, len(recs))
                if recs[i].kind == "ring_end" and recs[i].tag == tag),
               len(recs))
    body = recs[start + 1:end]
    permute_at = {r.step: i for i, r in enumerate(body)
                  if r.kind == PERMUTE and r.tag == tag}
    tile_at = {r.step: i for i, r in enumerate(body)
               if r.kind == "tile" and r.tag == tag}
    wait_at = {r.step: i for i, r in enumerate(body)
               if r.kind == "wait" and r.tag == tag}
    depends = any(s in tile_at and permute_at[s] > tile_at[s]
                  for s in permute_at)
    in_loop = any(s in wait_at and s in tile_at and wait_at[s] < tile_at[s]
                  for s in permute_at)
    return RingOverlap(len(permute_at), len(tile_at), in_loop, depends)


# -- donation ---------------------------------------------------------------

@dataclasses.dataclass
class DonationStats:
    # (output leaf, input leaf, kind) per aliased pair
    pairs: list
    n_aliased: int

    def summary(self) -> str:
        if not self.pairs:
            return "no input/output aliasing"
        return "; ".join(f"out{o} <- arg{p} ({k})" for o, p, k in self.pairs)


def _tensor_leaves(tree, path=()):
    if isinstance(tree, torch.nn.Module):
        for name, t in tree.named_parameters():
            yield path + (name,), t
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensor_leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensor_leaves(v, path + (str(i),))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def buffer_ptrs(tree) -> dict:
    """``{leaf path: (data_ptr, shape)}`` of every tensor of ``tree`` (a
    model's parameters, a cache, an optimizer state, or a tuple of
    them), taken before a step."""
    return {"/".join(p): (t.data_ptr(), tuple(t.shape))
            for p, t in _tensor_leaves(tree)}


def donation_stats(before: dict, after) -> DonationStats:
    """The leaves of ``after`` (the tree after the step) that kept the
    address and shape they had in ``before`` (its :func:`buffer_ptrs`
    before the step): the buffers the step updated in place."""
    now = buffer_ptrs(after)
    index = {k: i for i, k in enumerate(before)}
    pairs = [(o, index[k], "in-place") for o, (k, v) in enumerate(now.items())
             if k in before and before[k] == v]
    return DonationStats(pairs, len(pairs))


def assert_donation(before: dict, after, min_aliased: int = 1
                    ) -> DonationStats:
    """Assert at least ``min_aliased`` buffers were updated in place (a
    step that reallocates its cache or parameters fails here)."""
    st = donation_stats(before, after)
    if st.n_aliased < min_aliased:
        raise AssertionError(
            f"expected >= {min_aliased} buffers updated in place, found "
            f"{st.n_aliased} ({st.summary()})")
    return st


# -- remat -------------------------------------------------------------------

def duplication(keys: list) -> float:
    """The matmul count over the unique keys among them (1.0 when there is
    none)."""
    if not keys:
        return 1.0
    return len(keys) / max(1, len(set(keys)))


def remat_duplication(fn, *args, **kwargs) -> float:
    """Run ``fn(*args, **kwargs)`` (one forward plus backward) and return
    the matmul count over the unique (operation, input shapes, dtype)
    keys among them (1.0 when there is none)."""
    with CostCounter() as cost:
        fn(*args, **kwargs)
    return duplication(cost.matmuls)
