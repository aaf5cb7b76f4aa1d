"""The engine-dispatch layer for truncated and projected signatures and the
weighted signature Gram.

Port of the ``signature``, ``signature_time_parallel``, ``projected``,
``projected_forward_only`` and ``gram`` parts of ``repro.kernels.ops``.
``backend``:

- ``"torch"`` — the plain PyTorch versions: levelwise Horner for truncated
  signatures, the word-table scan for projections, the word-blocked
  product for the Gram (runs anywhere, differentiable by autograd).
- ``"cuda"``  — the hand-written Hopper kernels: ``sig_trunc``
  (:mod:`repro_torch.kernels.sig_trunc`), ``sig_words``
  (:mod:`repro_torch.kernels.sig_words`) and ``sig_gram``
  (:mod:`repro_torch.kernels.sig_gram`), registered operators
  (:mod:`repro_torch.kernels.library`); needs a CUDA device, or the meta
  device, where nothing runs and the operators give their outputs'
  shapes: ``obs.record_cost(site, lambda a: ops.signature(a, N,
  backend="cuda"), x)`` counts the kernel route's work without a card.
- ``"auto"``  — ``cuda`` on a CUDA device, ``torch`` on the CPU and on the
  meta device.

``device=None`` means the CUDA card (:mod:`repro_torch.device`), or the
meta device when the input is a meta tensor.  On the meta device the
autotuner is neither consulted nor timed: the planner's partition is used.

Backend × backward × stream support matrix (✗ raises)
------------------------------------------------------

``signature``:

=========  ======  =============================  ==============  ==========
engine     stream  backward="inverse"             "checkpoint"    "autodiff"
=========  ======  =============================  ==============  ==========
torch      False   scan fwd, §4.2 plain sweep     √M boundaries,  scan AD
                                                  chunk replay
torch      True    streamed scan, plain sweep     ✗               scan AD
cuda       False   kernel fwd, ``sig_sweep``      √M chunks in    (torch)
                   kernel bwd                     one kernel fwd,
                                                  Chen tree, one
                                                  ``sig_sweep``
cuda       True    streamed kernel, ``sig_sweep`` ✗               (torch)
                   kernel bwd
=========  ======  =============================  ==============  ==========

``time_chunks`` > 1 (``cuda``, not streamed): C time chunks folded into
the batch of one kernel launch of the chosen backward's cell, then a
log-depth Chen tree in plain tensor algebra (:func:`_time_parallel_combine`);
autograd carries the tree's adjoint to each chunk signature, so the
backward is that cell's, one ``sig_sweep`` launch.  The torch engine runs
whole paths, as the reference's ``jax`` engine does.

``projected`` (``projected_forward_only`` runs the ``inverse`` column's
forward over the requested words' tiles instead of the closure's, and
keeps no closure state: its backward raises unless the word set is its
own prefix closure):

=========  ======  =============================  ============  ==========
engine     stream  backward="inverse"             "checkpoint"  "autodiff"
=========  ======  =============================  ============  ==========
torch      False   word-table scan, plain sweep   √M boundary   scan AD
                                                  closure
                                                  states, chunk
                                                  replay
torch      True    streamed scan, plain sweep     ✗             scan AD
cuda       False   kernel over the closure tiles, (torch)       (torch)
                   then ``out_rows``;
                   ``sig_sweep`` kernel bwd
cuda       True    streamed kernel over the       ✗             (torch)
                   closure tiles; ``sig_sweep``
                   kernel bwd
hybrid     False   dense W_{<=N-1} + top-word     (torch)       scan AD
                   chains, §4.2 inverse backward
hybrid     True    ✗                              ✗             ✗
=========  ======  =============================  ============  ==========

``gram`` (one row per engine; the product has no stream or backward mode):

=========  ============================================================
engine     forward, backward
=========  ============================================================
torch      word-blocked ``(sx * wb) @ sy.T`` loop, closed-form backward
cuda       ``sig_gram`` kernel, closed-form backward (``torch.matmul``)
hybrid     the torch row (the product has no dense/word split)
=========  ============================================================

``(torch)`` cells route to the torch engine on the same device: the
projected ``cuda`` × ``checkpoint`` cell launches no kernel, because the
word kernel emits no boundary closure states.  The ``inverse`` backward
saves only the increments and the terminal state (the closure state for
projections) and runs the §4.2 reverse sweep, one ``sig_sweep`` launch a
call on the card (:mod:`repro_torch.kernels.sig_sweep`).  The ``cuda``
``checkpoint`` cell (:func:`_checkpoint_cell`) saves the increments and
O(√M) chunk states an example and rebuilds the states within a chunk by
the same sweep.  ``backend="hybrid"`` (:mod:`repro_torch.core.hybrid`,
plain PyTorch on whatever device the tensors are on, as the reference's
is jnp outside any Pallas kernel) runs the dense levelwise Horner step for
every level below the set's top level and per-word chains for its
top-level words only, then gathers the requested coordinates: the §3.3
log-signature's shape.  A set whose depth is below 2 takes the torch
word-table engine, ``checkpoint`` the torch engine's projected
checkpoint, and a transform is materialised first.  For truncated
signatures ``backend="hybrid"`` raises as in the reference: it applies to
projected word sets only.  ``max_rows`` bounds a tile's closure rows (a
caller's ``TiledPlan`` keeps its tiles; ``None`` is the autotuner's pick,
:mod:`repro_torch.kernels.autotune`, else 256); the reference's TPU
``batch_tile`` knob has no counterpart.

Under an installed ``sharding_ctx(mesh)`` whose "batch" axis has two or
more shards, every cell runs data-parallel (the mesh path below): each
rank runs the cell on its rows and gets a DTensor placed ``Shard(0)``,
and ``gram`` runs as a send/recv ring (:class:`GramRingFunction`).

``lengths`` (B,) works in every cell: padded-tail increments are zero-masked
before the engine runs (a zero increment is the identity Chen update), and
streamed outputs are masked after each example's true-terminal slot.

``transform`` column: every cell above also takes ``transform=`` (a
:class:`repro_torch.core.transforms.Transform` or a spec string such as
``"time_augment+lead_lag"``) and ``x0=`` (the path start, needed iff the
transform has a basepoint), applied to the path before signing:

- ``cuda`` × ``inverse`` (truncated and projected, terminal or streamed,
  and ``projected_forward_only``): FUSED.  The raw (B, M, d) increments
  and a (B, 2) fp32 ``[dt, n_valid_aug]`` row enter the kernel, which
  builds each augmented increment ([t?, lag, lead] channels) as it stages
  it; the (B, M_aug, d_aug) tensor is never made on the forward.  The
  backward saves the raw increments, builds the augmented ones
  transiently for the unchanged ``sig_sweep`` kernel, then applies
  :func:`repro_torch.core.transforms.fused_adjoint`.
- ``torch`` signatures: the augment is fused into the scan step
  (``core.signature._fused_torch_signature``).
- ``torch`` projections, every ``autodiff`` and ``checkpoint`` cell of
  them, and the ``cuda`` signature cells with ``checkpoint`` or
  ``time_chunks`` > 1: materialise: ``fused_augment`` builds the augmented
  increments once and the plain cell runs (the augment is linear,
  autograd transposes it).
- ``basepoint``: resolved here by prepending the ``x0`` increment
  (lengths shift by one); a basepoint-only transform runs the plain cell.
- The order of operations is the reference's: mask, prepend x0 (lengths
  + 1), quantise, then ``taux`` from the shifted lengths.  Streamed
  emissions, strides and lengths count augmented steps.  Projected word
  sets are over the augmented alphabet; a plan over the raw alphabet
  raises.
``precision="bf16_fp32"`` rounds the increments to bf16 once, here, before
any engine runs (straight-through gradient); the kernels then store them in
bf16 and accumulate in fp32, and streamed emissions are rounded to bf16.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.projection import projected_signature_from_increments
from ..core.signature import (as_lengths, canon_precision, default_chunk,
                              mask_increments, prepend_basepoint,
                              quantise_increments, signature_combine,
                              signature_from_increments, stream_emit_mask,
                              unsupported_stream_backward)
from ..core.transforms import (as_transform, augment_increments,
                               fused_augment, transform_dim, transform_steps,
                               transform_time_aux)
from ..core.words import (TiledPlan, WordPlan, flat_index, make_plan,
                          make_tiled_plan, sig_dim)
from .. import obs
from ..device import resolve_device
from ..distributed import batch as DB
from ..distributed import collectives as C
from ..distributed.ctx import axis_size, current_mesh, logical_axes
from . import autotune
from .cache import plan_cache, plan_cache_collector
from .sig_gram import sig_gram, sig_gram_plain
from .sig_trunc import plan_launch, sig_trunc
from .sig_words import sig_words

BACKENDS = ("torch", "cuda", "auto")
BACKWARDS = ("inverse", "checkpoint", "autodiff")

obs.register_collector(plan_cache_collector)


# ---------------------------------------------------------------------------
# dispatch observability: per-entry call counters + tracer spans
# ---------------------------------------------------------------------------

def _dispatch_calls():
    return obs.counter(
        "pathsig_dispatch_calls_total",
        "public dispatch entry calls (the port has no trace-time calls: "
        "ctx is always eager)", ("op", "backend", "ctx"))


def _obs_entry(fn):
    """Wrap a public dispatch entry with call accounting
    (``pathsig_dispatch_calls_total{op, backend, ctx="eager"}``) and a
    ``kernels.<op>`` span.  Two flag checks when observability is off."""
    site = fn.__name__

    @functools.wraps(fn)
    def wrapper(x, *args, **kwargs):
        metrics_on = obs.REGISTRY._enabled
        trace_on = obs.TRACER._active
        if not metrics_on and not trace_on:
            return fn(x, *args, **kwargs)
        backend = str(kwargs.get("backend", "auto"))
        if metrics_on:
            _dispatch_calls().inc(op=site, backend=backend, ctx="eager")
        if not trace_on:
            return fn(x, *args, **kwargs)
        with obs.span(f"kernels.{site}", backend=backend, ctx="eager",
                      shapes=obs.shape_key(x)):
            return fn(x, *args, **kwargs)

    return wrapper


def resolve_backend(backend: str, device: torch.device) -> str:
    """backend string -> engine (``"torch"`` | ``"cuda"``) on ``device``;
    ``"cuda"`` is accepted on the meta device, where nothing runs."""
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if backend == "cuda":
        if device.type not in ("cuda", "meta"):
            raise ValueError(f"backend='cuda' needs a CUDA device (or the "
                             f"meta device), got device={device}")
        return "cuda"
    if backend == "torch":
        return "torch"
    if backend == "hybrid":
        raise ValueError(
            "backend='hybrid' only applies to projected word sets (the "
            "truncated signature IS the dense engine); use backend='torch'")
    raise ValueError(f"unknown backend {backend!r}; expected one of "
                     f"{BACKENDS}")


def _entry_device(x, device) -> torch.device:
    """An entry point's device: ``device``, or the meta device when it is
    None and ``x`` is a meta tensor (a cost count, nothing runs)."""
    if device is None and getattr(x, "is_meta", False):
        return x.device
    return resolve_device(device)


def _lookup(kind: str, dev: torch.device, **cell) -> dict:
    """The autotuner's record for a cell; {} on the meta device, where the
    planner's partition is used and nothing is timed."""
    if dev.type == "meta":
        return {}
    return autotune.lookup(kind, **cell)


def _check_backward(backward: str) -> None:
    if backward not in BACKWARDS:
        raise ValueError(
            f"unknown backward mode {backward!r}; expected one of {BACKWARDS}")


def _finish_stream(out: torch.Tensor, precision: str, M: int, stride: int,
                   lengths) -> torch.Tensor:
    """A streamed cell's (B, M_out, D) output over M steps: rounded as
    bf16_fp32 stores its emissions (the kernel rounds on store, so every
    engine agrees on the values), then zeroed after each example's true-
    terminal slot (no-op without lengths or emissions)."""
    out = quantise_increments(out, precision)
    if lengths is None or out.shape[1] == 0:
        return out
    return out * stream_emit_mask(M, stride, lengths)[..., None].to(out.dtype)


class _Fused(NamedTuple):
    """A fused cell's inputs: the raw increments after the basepoint, the
    lengths, the kernel-level (basepoint-free, falsy for basepoint only)
    spec, its time rows (None without a time channel), and the augmented
    steps and lengths."""
    increments: torch.Tensor
    lengths: torch.Tensor | None
    spec: object
    taux: torch.Tensor | None
    M_aug: int
    aug_lengths: torch.Tensor | None


def _fused_inputs(increments: torch.Tensor, lengths, spec, x0,
                  precision: str) -> _Fused:
    """The fused cells' bookkeeping, in the reference's order: mask,
    prepend the x0 increment (lengths + 1), quantise, then the (B, 2) fp32
    ``[dt, n_valid_aug]`` rows from the post-basepoint lengths."""
    increments, lengths, kspec = prepend_basepoint(increments, lengths, spec,
                                                   x0, precision)
    B, M, _ = increments.shape
    taux = transform_time_aux(kspec, B, M, lengths,
                              device=increments.device) if kspec.time else None
    sub = kspec.sub_steps
    return _Fused(increments, lengths, kspec, taux, M * sub,
                  None if lengths is None else lengths * sub)


def _tuned(examples: int | None) -> dict:
    """The ``sig_trunc`` keyword of the autotuner's examples a block (none
    when the planner chooses)."""
    return {} if examples is None else {"examples": examples}


def _signature_local(increments: torch.Tensor, lengths, *, depth: int,
                     engine: str, backward: str, split: int | None,
                     time_chunks: int, stream: bool, stream_stride: int,
                     precision: str, transform=None, x0=None,
                     examples: int | None = None) -> torch.Tensor:
    """Single-device dispatch, in the reference's order: mask, quantise,
    engine, then the streamed output mask.  ``examples`` (the autotuner's)
    applies to the launches over the call's own batch."""
    kw = dict(depth=depth, engine=engine, backward=backward, split=split,
              time_chunks=time_chunks, stream=stream,
              stream_stride=stream_stride, precision=precision,
              examples=examples)
    if transform is not None:
        return _signature_fused(increments, lengths, transform, x0, **kw)
    if lengths is not None:
        lengths = as_lengths(lengths, increments.shape[0], increments.device)
        increments = mask_increments(increments, lengths)
    increments = quantise_increments(increments, precision)
    if stream:
        if engine == "torch" or backward == "autodiff" \
                or increments.shape[1] == 0:  # M=0: no emissions
            out = signature_from_increments(
                increments, depth, stream=True, stream_stride=stream_stride,
                backward=backward, backend="torch",
                device=increments.device)
        else:
            out = sig_trunc(increments, depth, split=split, stream=True,
                            stream_stride=stream_stride, precision=precision,
                            **_tuned(examples))
        return _finish_stream(out, precision, increments.shape[1],
                              stream_stride, lengths)
    if engine == "torch" or backward == "autodiff":
        # the torch engine runs whole paths: time_chunks is a kernel knob
        return signature_from_increments(increments, depth, backward=backward,
                                         backend="torch",
                                         device=increments.device)
    if time_chunks > 1:  # the chunks' launch is over another batch
        return _time_parallel_combine(
            lambda x: _signature_local(x, None, **dict(kw, time_chunks=1,
                                                       examples=None)),
            increments, depth, time_chunks)
    if backward == "checkpoint":
        return _checkpoint_cell(increments, depth, split, precision)
    return sig_trunc(increments, depth, split=split, precision=precision,
                     **_tuned(examples))


def _checkpoint_cell(increments: torch.Tensor, depth: int,
                     split: int | None, precision: str) -> torch.Tensor:
    """The ``cuda`` × ``checkpoint`` cell (the reference's
    ``_pallas_sig_checkpoint``): the ⌈M/√M⌉ chunks of
    :func:`repro_torch.core.signature.default_chunk` steps are folded into
    the batch of one ``sig_trunc`` launch, and the chunk signatures are
    Chen-combined in the log-depth tree of :func:`_time_parallel_combine`.

    What autograd saves is the folded increments (a view of the input when
    the chunks tile it, else its zero-padded copy), the (B, C, D_sig)
    chunk signatures and the tree's O(C) partial products: O(√M) states an
    example.  The backward differs from the reference's: autograd through
    the tree gives each chunk signature S_k its cotangent (the adjoint of
    X ↦ P_k ⊗ X ⊗ Q_k, P_k the product before chunk k and Q_k after it),
    and ``SigTruncFunction``'s backward is then one ``sig_sweep`` launch
    over all B·C chunks, each starting at the identity with S_k as its
    terminal state.  So within a chunk the states are rebuilt by the §4.2
    inverse over at most √M steps, where the reference replays the chunk
    forward from its stored boundary; the tree replaces the reference's
    sequential boundary scan (log C batched products instead of C)."""
    M = increments.shape[1]
    n_chunks = -(-M // default_chunk(M))
    return _time_parallel_combine(
        lambda x: sig_trunc(x, depth, split=split, precision=precision),
        increments, depth, n_chunks)


def _time_parallel_combine(sig_flat_fn, increments: torch.Tensor, depth: int,
                          time_chunks: int) -> torch.Tensor:
    """Fold C time chunks into the batch, sign them with ``sig_flat_fn``
    ((B·C, Mc, d) -> (B·C, D_sig)) and Chen-combine them in a log-depth
    tree of plain tensor algebra, as the reference's
    ``_time_parallel_combine`` does.  The fold is a view when the chunks
    tile the path; otherwise the tail is zero-padded (the identity
    update)."""
    B, M, d = increments.shape
    C = max(1, min(time_chunks, M))
    Mc = -(-M // C)
    x = increments
    if C * Mc != M:
        x = torch.nn.functional.pad(increments, (0, 0, 0, C * Mc - M))
    parts = sig_flat_fn(x.reshape(B * C, Mc, d)).reshape(B, C, -1)
    while parts.shape[1] > 1:
        n = parts.shape[1]
        even, odd = parts[:, 0:n - n % 2:2], parts[:, 1:n:2]
        merged = signature_combine(even, odd, d, depth)
        if n % 2:
            merged = torch.cat([merged, parts[:, -1:]], dim=1)
        parts = merged
    return parts[:, 0]


def _signature_fused(increments: torch.Tensor, lengths, spec, x0, *,
                     depth: int, engine: str, backward: str,
                     split: int | None, time_chunks: int, stream: bool,
                     stream_stride: int, precision: str,
                     examples: int | None) -> torch.Tensor:
    """The fused-transform cells of :func:`signature`: the ``cuda``
    ``inverse`` cells run ``sig_trunc`` on the raw increments and ``taux``
    (the reference's ``_pallas_sig_fused_inverse`` / ``_stream``); the
    torch engine and ``autodiff`` run the torch engine's fused scan;
    ``checkpoint`` and ``time_chunks > 1`` materialise the augmented
    increments and run the plain cell over them (autograd transposes the
    augment), as the reference does."""
    if engine == "torch" or backward == "autodiff" or increments.shape[1] == 0:
        out = signature_from_increments(
            increments, depth, stream=stream, stream_stride=stream_stride,
            backward=backward, backend="torch", lengths=lengths,
            transform=spec, x0=x0, precision=precision,
            device=increments.device)
        return quantise_increments(out, precision) if stream else out
    kw = dict(depth=depth, engine=engine, backward=backward, split=split,
              time_chunks=time_chunks, stream=stream,
              stream_stride=stream_stride, precision=precision,
              examples=examples)
    f = _fused_inputs(increments, lengths, spec, x0, precision)
    if not f.spec:  # basepoint only: one prepended increment, the plain cell
        return _signature_local(f.increments, f.lengths, **kw)
    if not stream and (time_chunks > 1 or backward == "checkpoint"):
        return _signature_local(fused_augment(f.increments, f.taux, f.spec),
                                None, **kw)
    out = sig_trunc(f.increments, depth, split=split, stream=stream,
                    stream_stride=stream_stride, precision=precision,
                    transform=f.spec, taux=f.taux, **_tuned(examples))
    if not stream:
        return out
    return _finish_stream(out, precision, f.M_aug, stream_stride,
                          f.aug_lengths)


# ---------------------------------------------------------------------------
# mesh path: an installed sharding_ctx(mesh) whose rules map the "batch"
# logical axis onto >= 2 ranks makes every dispatch cell data-parallel (the
# reference's shard_map branch).  Each rank pads the batch to a multiple of
# the shard count with zero rows (zero increments are identity updates; the
# padded rows are sliced off, so their cotangents are exactly zero), runs
# the single-device cell on its own rows, and returns its true rows as a
# DTensor placed Shard(0).  Gradients shard as the primals do: the kernels
# see only the local rows.  Outside any context, and under one whose batch
# axis has one shard, the branch is never taken.
# ---------------------------------------------------------------------------

def _as_batch(x, dev: torch.device):
    """A batch argument on ``dev``: a DTensor (a batch placed Shard(0) on
    the mesh) as it is, anything else through ``torch.as_tensor``."""
    return x if DB.is_dtensor(x) else torch.as_tensor(x, device=dev)


def _batch_lengths(lengths, B: int, dev: torch.device):
    """``lengths=`` for the mesh path: a DTensor as it is, else (B,)
    int32."""
    if lengths is None or DB.is_dtensor(lengths):
        return lengths
    return as_lengths(lengths, B, dev)


def _mesh_batch():
    """-> (1-D batch mesh, shard count) when the current sharding context
    shards the "batch" logical axis over >= 2 ranks, else None."""
    mesh = current_mesh()
    if mesh is None:
        return None
    names = logical_axes("batch")
    size = 1
    for a in names:
        size *= axis_size(mesh, a)
    if size <= 1:
        return None
    return _batch_mesh(mesh, names), size


@plan_cache
def _batch_mesh(mesh, names: tuple):
    """The batch axes' 1-D mesh, interned: flattening several axes makes
    process groups, so it happens once a (mesh, axes)."""
    return DB.batch_mesh(mesh, names)


class _Sharded:
    """A cell run per rank: ``local_fn(increments, lengths)`` over the
    rank's padded block, counted under ``site`` once per new local
    shape (the reference's retrace of its jitted shard_map)."""

    def __init__(self, local_fn, site: str):
        self.local_fn, self.site = local_fn, site
        self.shapes: set = set()


def _apply_sharded(fn: _Sharded, bm, increments, lengths, spec=None,
                   x0=None):
    """Take this rank's rows, zero-padded to the block of ⌈B/P⌉ rows (the
    reference's ``_pad_rows``: zero increments are identity updates),
    materialise a transform on them, run ``fn``'s cell and wrap the true
    rows as the (B, ...) DTensor placed Shard(0) on the batch mesh."""
    B = increments.shape[0]
    incs = DB.local_rows(increments, bm)
    lens = None if lengths is None else DB.local_rows(lengths, bm, B)
    if spec:
        # mesh × transform: increment-level materialise (support matrix);
        # the augment is row-wise, so each rank builds its own rows
        x0 = None if x0 is None else DB.local_rows(
            torch.as_tensor(x0, device=incs.device), bm, B)
        if lens is not None:
            incs, lens = augment_increments(incs, spec, x0=x0, lengths=lens)
        else:
            incs = augment_increments(incs, spec, x0=x0)
    obs.compile.count_new_shape(fn.site, fn.shapes, (tuple(incs.shape),
                                                     lens is None), incs)
    out = fn.local_fn(incs, lens)
    _, n, _ = DB.rows_of(B, bm.size(), bm.get_local_rank())
    return DB.from_rows(out[:n], bm, B)


@plan_cache
def _sharded_sig(bm, with_lengths: bool, depth: int, engine: str,
                 backward: str, split: int | None, time_chunks: int,
                 stream: bool, stream_stride: int, precision: str,
                 examples: int | None) -> _Sharded:
    """The truncated-signature cell per rank.  Transforms are materialised
    before it (support matrix), so it needs only the precision knob."""
    return _Sharded(functools.partial(
        _signature_local, depth=depth, engine=engine, backward=backward,
        split=split, time_chunks=time_chunks, stream=stream,
        stream_stride=stream_stride, precision=precision, examples=examples),
        "sharded_sig")


@plan_cache
def _sharded_proj(bm, with_lengths: bool, words: tuple, d: int,
                  engine: str, backward: str, max_rows: int, stream: bool,
                  stream_stride: int, precision: str) -> _Sharded:
    """The projected-signature cell per rank (the hybrid engine too)."""
    return _Sharded(functools.partial(
        _projected_local, wplan=_plan_for_words(words, d), engine=engine,
        backward=backward, max_rows=max_rows, stream=stream,
        stream_stride=stream_stride, precision=precision), "sharded_proj")


@plan_cache
def _sharded_proj_fwd(bm, with_lengths: bool, words: tuple, d: int,
                      engine: str, tplan, max_rows: int,
                      precision: str) -> _Sharded:
    """:func:`projected_forward_only`'s body per rank (a caller's
    TiledPlan as it is)."""
    return _Sharded(functools.partial(
        _projected_fwd_local, wplan=_plan_for_words(words, d), engine=engine,
        tplan=tplan, max_rows=max_rows, precision=precision),
        "sharded_proj_fwd")


@_obs_entry
def signature(increments, depth: int, *, backend: str = "auto",
              backward: str = "inverse", split: int | None = None,
              time_chunks: int = 1, stream: bool = False,
              stream_stride: int = 1, lengths=None, transform=None, x0=None,
              precision: str = "fp32", device=None) -> torch.Tensor:
    """Truncated signature (B, M, d) -> (B, D_sig) on ``device`` (default
    CUDA); see the support matrix in the module docstring.

    ``stream=True`` -> (B, M_out, D_sig) prefix signatures at every
    ``stream_stride``-th step (terminal always included).  ``lengths`` (B,)
    makes the batch ragged.  ``split`` forces the kernel's cone level.
    ``time_chunks`` > 1 folds that many time chunks into the kernel's batch
    and Chen-combines them (:func:`_time_parallel_combine`; the torch engine
    runs whole paths).  ``transform`` / ``x0`` apply a path transform fused
    into the kernel (the ``transform`` column of the support matrix).  On
    the ``cuda`` engine ``split=None`` consults the autotuner
    (:mod:`repro_torch.kernels.autotune`) for the launch's split and
    examples a block; on a miss, and on the meta device, the planner
    chooses.
    """
    dev = _entry_device(increments, device)
    increments = _as_batch(increments, dev)
    engine = resolve_backend(backend, dev)
    _check_backward(backward)
    precision = canon_precision(precision)
    spec = as_transform(transform)
    if stream:
        if stream_stride < 1:
            raise ValueError(
                f"stream_stride must be >= 1, got {stream_stride}")
        if backward == "checkpoint":
            raise unsupported_stream_backward(backward)
        if time_chunks > 1:
            raise NotImplementedError(
                "stream=True is incompatible with time_chunks > 1: chunked "
                "signatures only reconstruct the terminal state")
    if depth < 1:
        raise ValueError("depth must be >= 1")
    examples = None
    B = increments.shape[0]
    d_eff = transform_dim(spec, increments.shape[-1])
    if split is None:  # {} on the torch engine, which has no partition
        hit = _lookup(
            "sig_trunc", dev, engine=engine, d=d_eff, depth=depth,
            M=transform_steps(spec, increments.shape[1]), B=B,
            precision=precision)
        split, examples = hit.get("split"), hit.get("examples")
    if engine == "cuda" and obs.REGISTRY._enabled and B:
        obs.gauge("pathsig_smem_state_bytes",
                  "shared memory a block of the resolved launch plan takes",
                  ("op",)).set(plan_launch(B, d_eff, depth, split,
                                           examples).smem, op="signature")
    mb = _mesh_batch()
    if mb is None:
        return _signature_local(increments, lengths, depth=depth,
                                engine=engine, backward=backward, split=split,
                                time_chunks=time_chunks, stream=stream,
                                stream_stride=stream_stride,
                                precision=precision, transform=spec, x0=x0,
                                examples=examples)
    fn = _sharded_sig(mb[0], lengths is not None, depth, engine, backward,
                      split, time_chunks, stream, stream_stride, precision,
                      examples)
    return _apply_sharded(fn, mb[0], increments,
                          _batch_lengths(lengths, B, dev), spec, x0)


@_obs_entry
def signature_time_parallel(increments, depth: int, time_chunks: int, *,
                            backend: str = "auto", backward: str = "inverse",
                            split: int | None = None,
                            precision: str = "fp32",
                            device=None) -> torch.Tensor:
    """Chunked-time signature on any engine: fold ``time_chunks`` chunks
    into the batch, sign them through :func:`signature` and Chen-combine
    them in a log-depth tree.  Differentiable end to end: each chunk
    signature carries its cell's backward and the tree is plain tensor
    algebra."""
    dev = _entry_device(increments, device)
    return _time_parallel_combine(
        lambda x: signature(x, depth, backend=backend, backward=backward,
                            split=split, precision=precision, device=dev),
        torch.as_tensor(increments, device=dev), depth, time_chunks)


# ---------------------------------------------------------------------------
# plan normalisation + caches, keyed by plan CONTENT (words, d), never by
# WordPlan/TiledPlan identity, so a rebuilt identical plan hits the same
# tables
# ---------------------------------------------------------------------------

@plan_cache
def _plan_for_words(words: tuple, d: int) -> WordPlan:
    """The interned WordPlan of a word set: one object per (words, d)."""
    return make_plan(words, d)


@plan_cache
def _tiled_for_words(words: tuple, d: int, max_rows: int) -> TiledPlan:
    """The interned TiledPlan of a word set (TiledPlan hashes by
    identity)."""
    return make_tiled_plan(words, d, max_rows=max_rows)


@plan_cache
def _closure_tiled_plan(words: tuple, d: int, max_rows: int) -> TiledPlan:
    """Tiled plan whose requested words are the prefix closure of the word
    set: the kernel computes the closure rows anyway, so asking for them
    adds output gather only, and the terminal closure state is what the
    §4.2 backward reconstructs from."""
    return make_tiled_plan(_plan_for_words(words, d).closure, d,
                           max_rows=max_rows)


def _normalise_plans(plan, d: int) -> tuple[WordPlan, TiledPlan | None]:
    """-> (interned WordPlan, the caller's TiledPlan or None) from a
    WordPlan, a TiledPlan or an iterable of letter tuples over d letters."""
    if isinstance(plan, TiledPlan):
        return _plan_for_words(plan.words, plan.d), plan
    if isinstance(plan, WordPlan):
        return _plan_for_words(plan.words, plan.d), None
    return _plan_for_words(tuple(tuple(w) for w in plan), d), None


@plan_cache
def _hybrid_gather(words: tuple, d: int) -> tuple[tuple, np.ndarray]:
    """-> (top_words, out_idx): the level-N words the hybrid engine chains
    explicitly, and the gather from its [dense W_{<=N-1} ++ top] buffer
    back to the requested word order."""
    wplan = _plan_for_words(words, d)
    depth = wplan.depth
    top = tuple(dict.fromkeys(w for w in wplan.words if len(w) == depth))
    top_pos = {w: i for i, w in enumerate(top)}
    lown = sig_dim(d, depth - 1)
    idx = [lown + top_pos[w] if len(w) == depth else flat_index(w, d)
           for w in wplan.words]
    return top, np.asarray(idx, dtype=np.int64)


def _hybrid_projected(increments: torch.Tensor, wplan: WordPlan,
                      backward: str) -> torch.Tensor:
    """The projected signature through the hybrid engine
    (:func:`repro_torch.core.hybrid.hybrid_low_plus_top`), gathered to the
    requested words; a set of depth below 2 has no dense block and runs
    the torch word-table engine."""
    if wplan.depth < 2:
        return projected_signature_from_increments(
            increments, wplan, backward=backward, backend="torch",
            device=increments.device)
    from ..core.hybrid import hybrid_low_plus_top
    top, idx = _hybrid_gather(wplan.words, wplan.d)
    buf = hybrid_low_plus_top(increments, top, wplan.depth,
                              backward=backward)
    return buf[:, torch.from_numpy(idx).to(buf.device)]


def _closure_kernel(increments: torch.Tensor, wplan: WordPlan,
                    max_rows: int, stream: bool, stream_stride: int,
                    precision: str, transform=None,
                    taux=None) -> torch.Tensor:
    """The ``sig_words`` kernel over the closure-tiled plan, read at the
    requested words.  The kernel's (B, W) closure coefficients (B, M_out,
    W when streamed) are the closure state the §4.2 backward reconstructs
    from, as in the reference's ``_pallas_proj_inverse`` (and, with a
    ``transform``, ``_pallas_proj_fused_inverse`` / ``_stream``)."""
    fused = {} if transform is None else dict(transform=transform, taux=taux)
    cw = sig_words(increments,
                   _closure_tiled_plan(wplan.words, wplan.d, max_rows),
                   stream=stream, stream_stride=stream_stride,
                   precision=precision,
                   closure=_plan_for_words(wplan.closure, wplan.d), **fused)
    return cw[..., _closure_cols(wplan.words, wplan.d, increments.device)]


@plan_cache
def _closure_cols(words: tuple, d: int, device: torch.device) -> torch.Tensor:
    """The requested words' columns among the closure words: their state
    rows less the eps row, made on the host."""
    rows = np.asarray(_plan_for_words(words, d).out_rows, np.int64)
    return torch.as_tensor(rows - 1, device=device)


def _projected_local(increments: torch.Tensor, lengths, *, wplan: WordPlan,
                     engine: str, backward: str, max_rows: int, stream: bool,
                     stream_stride: int, precision: str, transform=None,
                     x0=None) -> torch.Tensor:
    """Single-device projected dispatch, in the reference's order: mask,
    quantise, engine, then the streamed output mask.  With a transform:
    the ``cuda`` ``inverse`` cells fuse it into ``sig_words``; every other
    cell materialises the augmented increments once and runs the plain
    cell over them, as the reference does."""
    kw = dict(wplan=wplan, engine=engine, backward=backward,
              max_rows=max_rows, stream=stream, stream_stride=stream_stride,
              precision=precision)
    if transform is not None:
        f = _fused_inputs(increments, lengths, transform, x0, precision)
        if not f.spec:  # basepoint only: one prepended increment
            return _projected_local(f.increments, f.lengths, **kw)
        if engine in ("torch", "hybrid") or backward != "inverse" \
                or f.M_aug == 0:
            return _projected_local(fused_augment(f.increments, f.taux,
                                                  f.spec), f.aug_lengths, **kw)
        out = _closure_kernel(f.increments, wplan, max_rows, stream,
                              stream_stride, precision, f.spec, f.taux)
        if not stream:
            return out
        return _finish_stream(out, precision, f.M_aug, stream_stride,
                              f.aug_lengths)
    if lengths is not None:
        lengths = as_lengths(lengths, increments.shape[0], increments.device)
        increments = mask_increments(increments, lengths)
    increments = quantise_increments(increments, precision)
    M = increments.shape[1]
    if engine == "hybrid":
        if backward == "checkpoint":
            # the hybrid engine keeps no chunk boundaries: the torch cell
            return projected_signature_from_increments(
                increments, wplan, backward=backward, backend="torch",
                device=increments.device)
        return _hybrid_projected(increments, wplan, backward)
    if stream:
        if engine == "torch" or backward == "autodiff" or M == 0:
            out = projected_signature_from_increments(
                increments, wplan, stream=True, stream_stride=stream_stride,
                backward=backward, backend="torch", device=increments.device)
        else:
            out = _closure_kernel(increments, wplan, max_rows, True,
                                  stream_stride, precision)
        return _finish_stream(out, precision, M, stream_stride, lengths)
    if engine == "torch" or backward != "inverse":
        # checkpoint needs boundary closure states the word kernel cannot
        # emit, autodiff the scan's residuals: both run on the torch engine
        return projected_signature_from_increments(
            increments, wplan, backward=backward, backend="torch",
            device=increments.device)
    return _closure_kernel(increments, wplan, max_rows, False, 1, precision)


def _projected_args(increments, plan, backend: str, backward: str,
                    transform, precision: str, device):
    """Validation shared by :func:`projected` and
    :func:`projected_forward_only`."""
    dev = _entry_device(increments, device)
    increments = _as_batch(increments, dev)
    engine = "hybrid" if backend == "hybrid" else resolve_backend(backend,
                                                                  dev)
    _check_backward(backward)
    precision = canon_precision(precision)
    spec = as_transform(transform)
    if increments.ndim != 3:
        raise ValueError(f"expected (B, M, d), got {tuple(increments.shape)}")
    d_in = increments.shape[-1]
    d_eff = transform_dim(spec, d_in)
    wplan, tplan = _normalise_plans(plan, d_eff)
    if spec is not None and wplan.d != d_eff:
        raise ValueError(
            f"projected word plan is over d={wplan.d} letters, but transform "
            f"{spec} maps d={d_in} input channels to {d_eff} augmented "
            f"channels — build the plan over the augmented alphabet")
    if wplan.d != d_in and spec is None:
        raise ValueError(f"the word plan is over d={wplan.d} letters, the "
                         f"increments have {d_in} channels")
    return increments, engine, precision, wplan, tplan, spec


def _max_rows(max_rows: int | None, engine: str, increments: torch.Tensor,
              wplan: WordPlan, spec, precision: str) -> int:
    """An explicit ``max_rows``, else the autotuner's ``sig_words`` pick on
    the ``cuda`` engine off the meta device, else 256."""
    if max_rows is not None:
        return max_rows
    return _lookup(
        "sig_words", increments.device, engine=engine, d=wplan.d,
        depth=wplan.depth,
        M=transform_steps(spec, increments.shape[1]), B=increments.shape[0],
        precision=precision).get("max_rows", 256)


@_obs_entry
def projected(increments, plan, *, backend: str = "auto",
              backward: str = "inverse", max_rows: int | None = None,
              stream: bool = False, stream_stride: int = 1, lengths=None,
              transform=None, x0=None, precision: str = "fp32",
              device=None) -> torch.Tensor:
    """Projected signature over a word set (B, M, d) -> (B, |I|) on
    ``device`` (default CUDA); see the support matrix in the module
    docstring.  ``plan`` is a WordPlan, a TiledPlan or an iterable of letter
    tuples.

    ``stream=True`` -> (B, M_out, |I|) per-step projections at every
    ``stream_stride``-th step (terminal always included).  ``lengths`` (B,)
    makes the batch ragged.  ``max_rows`` bounds the closure tiles of the
    ``cuda`` engine (a TiledPlan's own largest tile sets it instead;
    ``None`` is the autotuner's pick, else 256).
    ``transform`` / ``x0`` apply a path transform (the support matrix's
    ``transform`` column); the word set is then over the augmented
    alphabet.
    """
    increments, engine, precision, wplan, tplan, spec = _projected_args(
        increments, plan, backend, backward, transform, precision, device)
    if engine == "hybrid" and stream:
        raise NotImplementedError(
            "backend='hybrid' has no streamed forward; use backend='torch' "
            "or 'cuda' for stream=True")
    if stream:
        if stream_stride < 1:
            raise ValueError(
                f"stream_stride must be >= 1, got {stream_stride}")
        if backward == "checkpoint":
            raise unsupported_stream_backward(backward)
    if tplan is not None:  # keep the caller's tile granularity
        max_rows = max(p.closure_size for p in tplan.tiles)
    max_rows = _max_rows(max_rows, engine, increments, wplan, spec,
                         precision)
    mb = _mesh_batch()
    if mb is None:
        return _projected_local(increments, lengths, wplan=wplan,
                                engine=engine, backward=backward,
                                max_rows=max_rows, stream=stream,
                                stream_stride=stream_stride,
                                precision=precision, transform=spec, x0=x0)
    fn = _sharded_proj(mb[0], lengths is not None, wplan.words, wplan.d,
                       engine, backward, max_rows, stream, stream_stride,
                       precision)
    return _apply_sharded(fn, mb[0], increments, _batch_lengths(
        lengths, increments.shape[0], increments.device), spec, x0)


@_obs_entry
def projected_forward_only(increments, plan, *, backend: str = "auto",
                           max_rows: int | None = None, lengths=None,
                           transform=None,
                           x0=None, precision: str = "fp32",
                           device=None) -> torch.Tensor:
    """Inference-only projected signature: the ``cuda`` engine runs the
    kernel over the requested words' tiles (a caller's TiledPlan as it is)
    and skips the closure readout, so it keeps no closure state and its
    backward raises (unless the word set is its own prefix closure, whose
    tiles are those of :func:`projected`).  The ``torch`` engine is the
    word-table scan.  (B, M, d) -> (B, |I|).  ``transform`` / ``x0`` as in
    :func:`projected`: the ``cuda`` engine fuses the transform into the
    kernel, the torch engine materialises the augmented increments.
    ``max_rows=None`` is the autotuner's pick, else 256."""
    increments, engine, precision, wplan, tplan, spec = _projected_args(
        increments, plan, backend, "inverse", transform, precision, device)
    if tplan is None:
        max_rows = _max_rows(max_rows, engine, increments, wplan, spec,
                             precision)
    mb = _mesh_batch()
    if mb is None:
        return _projected_fwd_local(increments, lengths, wplan=wplan,
                                    engine=engine, tplan=tplan,
                                    max_rows=max_rows, precision=precision,
                                    transform=spec, x0=x0)
    fn = _sharded_proj_fwd(mb[0], lengths is not None, wplan.words, wplan.d,
                           engine, tplan, max_rows, precision)
    return _apply_sharded(fn, mb[0], increments, _batch_lengths(
        lengths, increments.shape[0], increments.device), spec, x0)


def _projected_fwd_local(increments: torch.Tensor, lengths, *,
                         wplan: WordPlan, engine: str, tplan, max_rows,
                         precision: str, transform=None,
                         x0=None) -> torch.Tensor:
    """Single-device body of :func:`projected_forward_only`."""
    fused = {}
    if transform is not None:
        f = _fused_inputs(increments, lengths, transform, x0, precision)
        increments = f.increments
        if f.spec and engine != "cuda":  # torch and hybrid materialise
            increments = fused_augment(increments, f.taux, f.spec)
        elif f.spec:
            fused = dict(transform=f.spec, taux=f.taux)
    else:
        if lengths is not None:
            lengths = as_lengths(lengths, increments.shape[0],
                                 increments.device)
            increments = mask_increments(increments, lengths)
        increments = quantise_increments(increments, precision)
    if engine == "hybrid":
        return _hybrid_projected(increments, wplan, "inverse")
    if engine == "torch":
        return projected_signature_from_increments(
            increments, wplan, backend="torch", device=increments.device)
    if tplan is None:
        tplan = _tiled_for_words(wplan.words, wplan.d, max_rows)
    return sig_words(increments, tplan, precision=precision, **fused)


# ---------------------------------------------------------------------------
# weighted Gram product: word-blocked routes + closed-form product backward
# ---------------------------------------------------------------------------

def _gram_tile(Sx, Sy, w, engine: str, block_words: int,
               tuned: dict) -> torch.Tensor:
    """One (B_x, B_y) product: a ``sig_gram`` launch on the cuda engine,
    the word-blocked plain product on the torch engine."""
    if engine == "cuda":
        return sig_gram(Sx, Sy, w, **tuned).to(
            torch.promote_types(Sx.dtype, torch.float32))
    return sig_gram_plain(Sx, Sy, w, block_words)


class GramFunction(torch.autograd.Function):
    """G = S_x diag(w) S_yᵀ with the reference's closed-form VJP
    (``_gram_vjp``): products of (B, D) matrices only, so the backward too
    never forms a (B_x, B_y, D) intermediate."""

    @staticmethod
    def forward(ctx, Sx, Sy, w, engine, block_words, tuned):
        ctx.save_for_backward(Sx, Sy, w)
        return _gram_tile(Sx, Sy, w, engine, block_words, tuned)

    @staticmethod
    def backward(ctx, g):
        Sx, Sy, w = ctx.saved_tensors
        # operands of mixed dtypes meet in their promoted dtype
        dt = torch.promote_types(torch.promote_types(Sx.dtype, Sy.dtype),
                                 torch.promote_types(w.dtype, torch.float32))
        g, x, y, v = (t.to(dt) for t in (g, Sx, Sy, w))
        dSx = (g @ (y * v[None, :])).to(Sx.dtype)
        dSy = (g.T @ (x * v[None, :])).to(Sy.dtype)
        dw = ((g.T @ x) * y).sum(dim=0).to(w.dtype)
        return dSx, dSy, dw, None, None, None


class GramRingFunction(torch.autograd.Function):
    """The cross-rank Gram (the reference's ``_gram_ring``) over one rank's
    blocks: ``sx`` (c_x, D) and ``sy`` (c_y, D), each the rank's rows
    padded to the block.

    X rows stay local; Y blocks rotate round the group to the left
    neighbour in P steps.  Step s holds the block of rank (p + s) mod P,
    posts the send/recv of the next block *before* launching its tile (one
    ``sig_gram`` launch) and writes the tile at that block's origin
    columns, so the transfer runs under the tile.  P − 1 sends of one
    (c_y, D) block a forward: the whole of Y crosses the wire once, and no
    rank holds more than two Y blocks and its (c_x, P·c_y) row block.

    The backward is the reversed ring (blocks rotate right) with
    :class:`GramFunction`'s closed-form products: dS_x accumulates
    locally, and each Y block's cotangent travels with the block, summing
    every rank's share, and arrives at its owner after P sends.  ``dw`` is
    this rank's share (its rows of G): a replicated weight's gradient is
    the sum over the ranks, as a parameter's is in the data-parallel
    trainer."""

    @staticmethod
    def forward(ctx, sx, sy, w, group, engine, block_words, tuned):
        P, p = dist.get_world_size(group), dist.get_rank(group)
        cy = sy.shape[0]
        G = sx.new_zeros((sx.shape[0], cy * P),
                         dtype=torch.promote_types(sx.dtype, torch.float32))
        cur = sy
        C.LOG.mark("ring_start", tag="gram_ring")
        for s in range(P):
            nxt = C.RingShift([cur], group, tag="gram_ring", step=s) \
                if s + 1 < P else None
            C.LOG.mark("tile", tag="gram_ring", step=s)
            o = (p + s) % P     # origin rank of the block held at step s
            G[:, o * cy:(o + 1) * cy] = _gram_tile(sx, cur, w, engine,
                                                   block_words, tuned)
            if nxt is not None:
                (cur,) = nxt.wait()
                C.LOG.mark("wait", tag="gram_ring", step=s)
        C.LOG.mark("ring_end", tag="gram_ring")
        ctx.save_for_backward(sx, sy, w)
        ctx.group = group
        return G

    @staticmethod
    def backward(ctx, g):
        sx, sy, w = ctx.saved_tensors
        group = ctx.group
        P, p = dist.get_world_size(group), dist.get_rank(group)
        cy = sy.shape[0]
        dt = torch.promote_types(torch.promote_types(sx.dtype, sy.dtype),
                                 torch.promote_types(w.dtype, torch.float32))
        g, x, v = g.to(dt), sx.to(dt), w.to(dt)
        xw = x * v[None, :]
        dsx = torch.zeros_like(x)
        dw = torch.zeros_like(v)
        acc = torch.zeros((cy, x.shape[1]), dtype=dt, device=x.device)
        cur = sy
        for s in range(P):
            o = (p - s) % P     # origin rank of the block held at step s
            nxt = C.RingShift([cur], group, direction=1, tag="gram_ring_bwd",
                              step=s) if s + 1 < P else None
            gs, y = g[:, o * cy:(o + 1) * cy], cur.to(dt)
            dsx += gs @ (y * v[None, :])
            acc += gs.T @ xw
            dw += ((gs.T @ x) * y).sum(dim=0)
            # the block's cotangent moves on with it; after the last step
            # one more send delivers each to its owner
            (acc,) = C.RingShift([acc], group, direction=1,
                                 tag="gram_ring_bwd", step=s).wait()
            if nxt is not None:
                (cur,) = nxt.wait()
        return (dsx.to(sx.dtype), acc.to(sy.dtype), dw.to(w.dtype), None,
                None, None, None)


def _gram_ring(bm, P: int, Sx, Sy, weights, engine: str, block_words: int,
               precision: str):
    """``gram`` under the mesh: the ring over this rank's blocks, its true
    (B_x/P, B_y) rows returned as a Shard(0) DTensor.  Publishes the
    reference's analytic ring counters at dispatch."""
    Bx, By, D = Sx.shape[0], Sy.shape[0], Sx.shape[1]
    # the tiles the ring launches are the per-shard ones: key the tuned
    # cell on those and on P
    tuned = autotune.partition(autotune.lookup(
        "gram_ring", engine=engine, D=D, Bx=-(-Bx // P), By=-(-By // P), P=P,
        precision=precision), "gram_ring")
    sx = quantise_increments(DB.local_rows(Sx, bm), precision)
    sy = quantise_increments(DB.local_rows(Sy, bm), precision)
    if obs.REGISTRY._enabled:
        # P - 1 sends of one (B_y,pad / P, D) block a forward (the last
        # block held is consumed, not forwarded)
        shard_bytes = sy.shape[0] * D * sy.element_size()
        obs.counter("pathsig_ring_ppermute_total",
                    "ppermute steps issued by the gram ring",
                    ("ctx",)).inc(P - 1, ctx="eager")
        obs.counter("pathsig_ring_wire_bytes_total",
                    "analytic wire bytes moved by gram-ring ppermutes "
                    "(per device)", ("ctx",)).inc((P - 1) * shard_bytes,
                                                  ctx="eager")
    with obs.span("kernels.gram_ring", devices=P,
                  shapes=obs.shape_key(Sx, Sy)):
        G = GramRingFunction.apply(sx, sy, weights, bm.get_group(), engine,
                                   block_words, tuned)
    _, n, _ = DB.rows_of(Bx, P, bm.get_local_rank())
    return DB.from_rows(G[:n, :By], bm, Bx)


@_obs_entry
def gram(Sx, Sy, weights, *, backend: str = "auto",
         block_words: int | None = None, bx_tile: int | None = None,
         by_tile: int | None = None, precision: str = "fp32",
         device=None) -> torch.Tensor:
    """Weighted signature Gram (B_x, D), (B_y, D), (D,) -> (B_x, B_y) on
    ``device`` (default CUDA): k_ω(x, y) = S_x diag(ω) S_yᵀ, blocked over
    the word axis so the (B_x, B_y, D) intermediate never exists.

    Differentiable in all three operands through the closed-form product
    backward.  ``precision="bf16_fp32"`` rounds both signature operands to
    bf16 (straight-through gradient) and accumulates in fp32.
    ``block_words`` (default 512) is the torch engine's slab width;
    ``bx_tile``/``by_tile`` (default 128) are the reference's TPU block
    shapes and are checked only: the CUDA kernel chooses its tile (128 or
    64 rows of S_x by 128 of S_y), its split of the words and its copy
    width from the shape and the pointers (``kernels/sig_gram.py``), or
    takes the autotuner's ``{rows, slice_words}`` for the cell.

    Under an installed ``sharding_ctx(mesh)`` that shards the "batch"
    logical axis, the product runs as the cross-rank ring of
    :class:`GramRingFunction` (both operands batch-sharded, zero rows
    padding them to a multiple of the shard count), and the result is a
    (B_x, B_y) DTensor placed Shard(0).
    """
    dev = _entry_device(Sx, device)
    Sx, Sy = _as_batch(Sx, dev), _as_batch(Sy, dev)
    weights = torch.as_tensor(weights, device=dev)
    # the gram product has no dense/word split: hybrid is the torch engine
    engine = "torch" if backend == "hybrid" else resolve_backend(backend, dev)
    precision = canon_precision(precision)
    if Sx.ndim != 2 or Sy.ndim != 2 or Sy.shape[1] != Sx.shape[1] \
            or tuple(weights.shape) != (Sx.shape[1],):
        raise ValueError(
            f"gram needs Sx (B_x, D), Sy (B_y, D), weights (D,); got "
            f"{tuple(Sx.shape)}, {tuple(Sy.shape)}, {tuple(weights.shape)}")
    block_words = 512 if block_words is None else block_words
    for name, v in (("block_words", block_words),
                    ("bx_tile", 128 if bx_tile is None else bx_tile),
                    ("by_tile", 128 if by_tile is None else by_tile)):
        if v < 1:
            raise ValueError(f"{name} must be >= 1, got {v}")
    mb = _mesh_batch()
    if mb is not None:
        return _gram_ring(mb[0], mb[1], Sx, Sy, weights, engine, block_words,
                          precision)
    Sx = quantise_increments(Sx, precision)
    Sy = quantise_increments(Sy, precision)
    tuned = autotune.partition(_lookup(
        "gram", dev, engine=engine, D=Sx.shape[1], Bx=Sx.shape[0],
        By=Sy.shape[0], precision=precision), "gram")
    return GramFunction.apply(Sx, Sy, weights, engine, block_words, tuned)
