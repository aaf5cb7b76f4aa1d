"""Truncated path signatures with O(1)-in-length backprop (paper §3-4).

Port of ``repro.core.signature``.  Public API:

``signature(path, depth, ...)``              (B, M+1, d) -> (B, D_sig)
``signature_from_increments(incs, depth)``   (B, M, d)   -> (B, D_sig)
``signature(..., stream=True)``              -> (B, M_out, D_sig) prefix
signatures at every ``stream_stride``-th step (terminal step always emitted;
see :func:`stream_emit_steps`).

Backends: ``"torch"`` is the plain levelwise Horner scan in PyTorch (runs
anywhere); ``"cuda"`` is the Hopper ``sig_trunc`` kernel through
:mod:`repro_torch.kernels.ops`; ``"auto"`` picks ``cuda`` on a CUDA device
and ``torch`` on the CPU.  The device rule of :mod:`repro_torch.device`
decides where inputs go.

Backward modes:

- ``"inverse"`` (default, the paper's §4.2): the forward saves only the
  increments and the terminal signature; the backward reconstructs
  S_{0,t_{j-1}} = S_{0,t_j} ⊗ exp(-ΔX_j) in one reverse sweep
  (:func:`inverse_bwd_scan`, :func:`stream_inverse_bwd_scan`), O(B·D_sig)
  live memory whatever M.  On the ``torch`` engine the sweep is
  :func:`repro_torch.kernels.sig_sweep.sig_sweep_plain`; on the ``cuda``
  engine it is the hand-written ``sig_sweep`` kernel.
- ``"autodiff"``: plain autograd through the scan, O(M·B·D_sig) memory
  (the memory-law baseline); the ``cuda`` engine routes it to ``torch``.
- ``"checkpoint"`` (beyond the paper): the forward saves the increments
  and the state at each of the O(√M) chunk boundaries
  (:func:`default_chunk`); the backward replays each chunk from its
  boundary under autograd (:func:`checkpoint_bwd_scan`): O(√M·B·D_sig)
  memory and no inverse-reconstruction drift.  On the ``cuda`` engine the
  cell folds the chunks into one ``sig_trunc`` launch and its backward is
  one ``sig_sweep`` launch, which rebuilds the states within each chunk
  by the §4.2 inverse (:mod:`repro_torch.kernels.ops`).  A transform
  materialises the augmented increments first, as the reference does.

``transform=`` (see :func:`repro_torch.core.transforms.as_transform`)
fuses basepoint / lead_lag / time_augment into the scan: basepoint is an
increment prepend (``x0=``), and each augmented increment is built per
Horner sub-step (:func:`_fused_scan_forward`), so the (B, M_aug, d_aug)
intermediate never exists on the forward; streamed emissions and lengths
are over the augmented step axis.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.cache import plan_cache
from . import tensor_ops as tops
from .words import WordPlan, sig_dim, truncation_plan


def stream_emit_steps(M: int, stride: int = 1) -> np.ndarray:
    """0-based scan steps emitted by a streamed forward: stride-1,
    2·stride-1, ..., with the terminal step M-1 always included.
    len == ceil(M/stride); step j holds S_{0,t_{j+1}}."""
    if stride < 1:
        raise ValueError(f"stream_stride must be >= 1, got {stride}")
    if M == 0:
        return np.zeros((0,), np.int64)
    steps = np.arange(stride - 1, M, stride, dtype=np.int64)
    if steps.size == 0 or steps[-1] != M - 1:
        steps = np.append(steps, M - 1)
    return steps


# ---------------------------------------------------------------------------
# ragged batches: a zero increment is the identity Chen update, so zero-
# masking the padded tail makes the terminal signature of a padded batch
# exactly the per-example unpadded signature on every engine.
# ---------------------------------------------------------------------------

def as_lengths(lengths, B: int, device=None) -> torch.Tensor:
    """Normalise ``lengths=`` to a (B,) int32 tensor (a scalar broadcasts)."""
    lengths = torch.as_tensor(lengths, device=device)
    if lengths.ndim == 0:
        lengths = lengths.expand(B)
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be scalar or shape ({B},), got "
                         f"{tuple(lengths.shape)}")
    return lengths.to(torch.int32)


def length_mask(lengths: torch.Tensor, M: int) -> torch.Tensor:
    """(B,) increment counts -> (B, M) bool, True inside the true path."""
    steps = torch.arange(M, dtype=torch.int32, device=lengths.device)
    return steps[None, :] < lengths[:, None]


def mask_increments(increments: torch.Tensor, lengths) -> torch.Tensor:
    """Zero every increment at or past each example's true end."""
    if lengths is None:
        return increments
    B, M, _ = increments.shape
    m = length_mask(as_lengths(lengths, B, increments.device), M)
    return increments * m[..., None].to(increments.dtype)


def stream_emit_slots(M: int, stride: int,
                      lengths: torch.Tensor) -> torch.Tensor:
    """(B,) emitted slot holding each example's true terminal signature:
    ceil(length / stride) - 1, clamped into [0, M_out)."""
    M_out = -(-M // stride)
    slots = torch.div(lengths + (stride - 1), stride,
                      rounding_mode="floor") - 1
    return slots.clamp(0, max(M_out - 1, 0)).to(torch.int32)


def stream_emit_mask(M: int, stride: int,
                     lengths: torch.Tensor) -> torch.Tensor:
    """(B, M_out) bool: True up to and including each example's true-
    terminal slot; emissions past the end are masked."""
    M_out = -(-M // stride)
    slots = stream_emit_slots(M, stride, lengths)
    steps = torch.arange(M_out, dtype=torch.int32, device=lengths.device)
    return steps[None, :] <= slots[:, None]


def ragged_terminal(stream_out: torch.Tensor, lengths, stride: int = 1,
                    M: int | None = None) -> torch.Tensor:
    """Each example's true terminal state from a streamed output
    (B, M_out, D): the emitted slot of :func:`stream_emit_slots`.  ``M`` is
    the padded increment count (default M_out·stride, exact at stride 1).
    Returns (B, D)."""
    B, M_out, _ = stream_out.shape
    if M is None:
        M = M_out * stride
    slots = stream_emit_slots(M, stride, as_lengths(lengths, B,
                                                    stream_out.device))
    return stream_out[torch.arange(B, device=stream_out.device),
                      slots.long()]


def _as_batched(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    if x.ndim == 2:
        return x[None], True
    if x.ndim == 3:
        return x, False
    raise ValueError(f"expected (M, d) or (B, M, d), got {tuple(x.shape)}")


def _unpack_ragged(path):
    """Duck-typed :class:`repro_torch.ragged.RaggedPaths` unpacking."""
    if hasattr(path, "values") and hasattr(path, "lengths"):
        return path.values, path.lengths
    return path, None


# ---------------------------------------------------------------------------
# forward scan
# ---------------------------------------------------------------------------

def _scan_forward(increments: torch.Tensor, depth: int,
                  stream: bool) -> torch.Tensor:
    """Plain levelwise-Horner Chen scan, a Python loop over time.
    increments: (B, M, d) -> (B, D_sig), or (B, M, D_sig) when streamed."""
    B, M, d = increments.shape
    levels = tops.zero_levels((B,), d, depth, increments.dtype,
                              increments.device)
    ys = []
    for j in range(M):
        levels = tops.horner_step(levels, increments[:, j])
        if stream:
            ys.append(tops.levels_to_flat(levels))
    if stream:
        if not ys:
            return increments.new_zeros((B, 0, sig_dim(d, depth)))
        return torch.stack(ys, 1)
    return tops.levels_to_flat(levels)


def _subsample_stream(out: torch.Tensor, M: int, stride: int) -> torch.Tensor:
    """(B, M, D) full stream -> (B, M_out, D) at the emitted steps."""
    if stride == 1:
        return out
    idx = torch.as_tensor(stream_emit_steps(M, stride), device=out.device)
    return out[:, idx]


# ---------------------------------------------------------------------------
# fused-transform forward: the augmented increment is built per Horner
# sub-step, so the (B, M_aug, d_aug) intermediate never exists.
# ``increments`` already include the basepoint increment (the dispatch
# prepends x0); ``taux`` is transforms.transform_time_aux output.
# ---------------------------------------------------------------------------

def dataclasses_replace_nobp(spec):
    """The kernel-level view of a transform spec: basepoint is an increment
    prepend done by the dispatch, so the scans and kernels see only
    lead_lag and time."""
    import dataclasses
    if spec.basepoint:
        return dataclasses.replace(spec, basepoint=False)
    return spec


def _fused_build_increment(dx: torch.Tensor, taux: torch.Tensor, spec,
                           phase: int, ja: int) -> torch.Tensor:
    """Augmented increment ``ja`` (B, d_aug), in ``dx``'s dtype, from raw
    increment (B, d): [t?, lag, lead] channels, lead moving in phase 0."""
    parts = []
    if spec.time:
        dt, n_valid = taux[:, :1], taux[:, 1:]
        parts.append((dt * (ja < n_valid).to(dt.dtype)).to(dx.dtype))
    if spec.lead_lag:
        z = torch.zeros_like(dx)
        parts += [z, dx] if phase == 0 else [dx, z]
    else:
        parts.append(dx)
    return torch.cat(parts, dim=-1)


def _fused_scan_forward(increments: torch.Tensor, taux: torch.Tensor, spec,
                        depth: int, stream: bool) -> torch.Tensor:
    """Fused levelwise-Horner scan: ``spec.sub_steps`` Horner sub-steps per
    raw step.  increments: (B, M, d) raw -> (B, D_sig(d_aug)), or over the
    augmented axis (B, M_aug, D_sig) when streamed."""
    from .transforms import transform_dim
    B, M, d = increments.shape
    sub = spec.sub_steps
    d_aug = transform_dim(dataclasses_replace_nobp(spec), d)
    levels = tops.zero_levels((B,), d_aug, depth, increments.dtype,
                              increments.device)
    ys = []
    for j in range(M):
        for p in range(sub):
            e = _fused_build_increment(increments[:, j], taux, spec, p,
                                       sub * j + p)
            levels = tops.horner_step(levels, e)
            if stream:
                ys.append(tops.levels_to_flat(levels))
    if stream:
        if not ys:
            return increments.new_zeros((B, 0, sig_dim(d_aug, depth)))
        return torch.stack(ys, 1)
    return tops.levels_to_flat(levels)


# ---------------------------------------------------------------------------
# the §4.2 inverse backward: the forward saves (increments, terminal); one
# reverse sweep over the truncation's word table reconstructs the states
# and pulls the cotangent back (repro_torch.kernels.sig_sweep)
# ---------------------------------------------------------------------------

@plan_cache
def truncation_closure(d: int, depth: int) -> WordPlan:
    """The word plan of W_{<=N}: its level-major closure is the flat
    signature order, so a flat signature is the closure state less eps."""
    return truncation_plan(d, depth)


def inverse_bwd_scan(increments: torch.Tensor, out_flat: torch.Tensor,
                     g_flat: torch.Tensor, depth: int) -> torch.Tensor:
    """§4.2 backward sweep: reconstruct S_{0,t_{j-1}} = S_{0,t_j} ⊗
    exp(-ΔX_j) and accumulate cotangents in one reverse loop.  Any forward
    that produced the terminal ``out_flat`` (B, D_sig) pairs with it.
    Returns the increments' gradient (B, M, d)."""
    from ..kernels.sig_sweep import sig_sweep_plain  # kernels import core
    return sig_sweep_plain(increments,
                           truncation_closure(increments.shape[-1], depth),
                           out_flat, g_flat)


def stream_inverse_bwd_scan(increments: torch.Tensor,
                            terminal_flat: torch.Tensor,
                            g_steps: torch.Tensor, depth: int,
                            stride: int = 1) -> torch.Tensor:
    """§4.2 reverse sweep of a streamed forward: the cotangent of emitted
    step j (:func:`stream_emit_steps`) is added to the running cotangent
    just before step j is pulled back, as the reference's dense scatter
    of strided cotangents does, without the (B, M, D_sig) buffer.  Only
    the terminal signature ``terminal_flat`` is needed as residual."""
    from ..kernels.sig_sweep import sig_sweep_plain
    return sig_sweep_plain(increments,
                           truncation_closure(increments.shape[-1], depth),
                           terminal_flat, g_steps, stream=True,
                           stream_stride=stride)


class InverseSignatureFunction(torch.autograd.Function):
    """The ``torch`` engine's ``backward="inverse"`` cell: the plain scan
    forward, saving only (increments, terminal signature), and the §4.2
    sweep backward.  ``stride`` 0 is the terminal cell, >= 1 the streamed
    one (M >= 1)."""

    @staticmethod
    def forward(ctx, increments, depth, stride):
        if stride == 0:
            out = _scan_forward(increments, depth, False)
            terminal = out
        else:
            full = _scan_forward(increments, depth, True)
            out = _subsample_stream(full, increments.shape[1], stride)
            terminal = full[:, -1].clone()
        ctx.save_for_backward(increments, terminal)
        ctx.depth, ctx.stride = depth, stride
        return out

    @staticmethod
    def backward(ctx, g):
        increments, terminal = ctx.saved_tensors
        if ctx.stride == 0:
            gx = inverse_bwd_scan(increments, terminal, g, ctx.depth)
        else:
            gx = stream_inverse_bwd_scan(increments, terminal, g, ctx.depth,
                                         ctx.stride)
        return gx, None, None


class FusedInverseSignatureFunction(torch.autograd.Function):
    """The ``torch`` engine's fused ``backward="inverse"`` cell: the fused
    scan forward, saving the raw increments, ``taux`` and the terminal
    signature.  The backward materialises the augmented increments
    transiently (:func:`repro_torch.core.transforms.fused_augment`), runs
    the plain §4.2 sweep over them and pulls the cotangent back through
    :func:`repro_torch.core.transforms.fused_adjoint`; ``taux`` gets no
    gradient.  ``stride`` 0 is the terminal cell, >= 1 the streamed one
    (emissions strided over the augmented axis)."""

    @staticmethod
    def forward(ctx, increments, taux, spec, depth, stride):
        full = _fused_scan_forward(increments, taux, spec, depth, stride > 0)
        if stride == 0:
            out = terminal = full
        else:
            out = _subsample_stream(full, full.shape[1], stride)
            terminal = full[:, -1].clone()
        ctx.save_for_backward(increments, taux, terminal)
        ctx.spec, ctx.depth, ctx.stride = spec, depth, stride
        return out

    @staticmethod
    def backward(ctx, g):
        from .transforms import fused_adjoint, fused_augment
        increments, taux, terminal = ctx.saved_tensors
        e = fused_augment(increments, taux, ctx.spec)
        if ctx.stride == 0:
            g_e = inverse_bwd_scan(e, terminal, g, ctx.depth)
        else:
            g_e = stream_inverse_bwd_scan(e, terminal, g, ctx.depth,
                                          ctx.stride)
        gx = fused_adjoint(g_e, ctx.spec, increments.shape[-1])
        return gx, None, None, None, None


# ---------------------------------------------------------------------------
# the √M checkpoint backward (beyond the paper): the forward saves the state
# at each chunk boundary, the backward replays each chunk from its boundary
# ---------------------------------------------------------------------------

def default_chunk(M: int) -> int:
    """√M chunk length for the checkpoint backward."""
    return max(1, math.isqrt(max(M, 1)))


def _chunk_scan(levels: list[torch.Tensor],
                incs: torch.Tensor) -> list[torch.Tensor]:
    """Advance a levels state through one chunk of increments (c, B, d)."""
    for dx in incs:
        levels = tops.horner_step(levels, dx)
    return levels


def _fold_chunks(increments: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, M, d) -> time-major (n_chunks, chunk, B, d), zero-padded (a zero
    increment is the identity update)."""
    B, M, d = increments.shape
    n_chunks = -(-M // chunk)
    incs = torch.nn.functional.pad(increments,
                                   (0, 0, 0, n_chunks * chunk - M))
    return incs.movedim(1, 0).reshape(n_chunks, chunk, B, d)


def checkpoint_bwd_scan(increments: torch.Tensor, boundaries: torch.Tensor,
                        g_flat: torch.Tensor, depth: int,
                        chunk: int) -> torch.Tensor:
    """√M-checkpoint backward: replay each chunk, last first, from its
    stored boundary state under autograd and pull the cotangent back
    through it.  ``boundaries`` (n_chunks, B, D_sig) holds the state before
    each chunk.  Returns the increments' gradient (B, M, d)."""
    B, M, d = increments.shape
    incs = _fold_chunks(increments.detach(), chunk)
    G = tops.flat_to_levels(g_flat, d, depth)
    g_chunks = []
    for k in reversed(range(incs.shape[0])):
        with torch.enable_grad():
            bound = [lv.clone().requires_grad_() for lv in
                     tops.flat_to_levels(boundaries[k].detach(), d, depth)]
            c = incs[k].clone().requires_grad_()
            *G, g_c = torch.autograd.grad(_chunk_scan(bound, c),
                                          bound + [c], G)
        g_chunks.append(g_c)
    g = torch.stack(g_chunks[::-1]).reshape(-1, B, d).movedim(0, 1)
    return g[:, :M]


class CheckpointSignatureFunction(torch.autograd.Function):
    """The ``torch`` engine's ``backward="checkpoint"`` cell: the plain
    scan forward, chunk by chunk, saving the increments and the
    (n_chunks, B, D_sig) boundary states; the backward is
    :func:`checkpoint_bwd_scan` (M >= 1)."""

    @staticmethod
    def forward(ctx, increments, depth, chunk):
        B, _, d = increments.shape
        levels = tops.zero_levels((B,), d, depth, increments.dtype,
                                  increments.device)
        bounds = []
        for c in _fold_chunks(increments, chunk):
            bounds.append(tops.levels_to_flat(levels))
            levels = _chunk_scan(levels, c)
        ctx.save_for_backward(increments, torch.stack(bounds))
        ctx.depth, ctx.chunk = depth, chunk
        return tops.levels_to_flat(levels)

    @staticmethod
    def backward(ctx, g):
        increments, bounds = ctx.saved_tensors
        return (checkpoint_bwd_scan(increments, bounds, g, ctx.depth,
                                    ctx.chunk), None, None)


def checkpoint_signature(increments: torch.Tensor,
                         depth: int) -> torch.Tensor:
    """The checkpoint cell at :func:`default_chunk`; no steps is the
    identity."""
    M = increments.shape[1]
    if M == 0:
        return _scan_forward(increments, depth, False)
    return CheckpointSignatureFunction.apply(increments, depth,
                                             default_chunk(M))


# ---------------------------------------------------------------------------
# precision: "fp32" | "bf16_fp32" (bf16-rounded increments, fp32
# accumulation).  The rounding is the semantics: every engine runs fp32
# Horner updates on the same rounded increments.
# ---------------------------------------------------------------------------

PRECISIONS = ("fp32", "bf16_fp32")


def canon_precision(precision: str) -> str:
    p = {"bf16": "bf16_fp32"}.get(precision, precision)
    if p not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}: expected one of "
                         f"{PRECISIONS}")
    return p


def quantise_increments(x: torch.Tensor, precision: str) -> torch.Tensor:
    """Round to the storage dtype of ``precision`` with a straight-through
    gradient (returned in the original dtype)."""
    if canon_precision(precision) == "bf16_fp32":
        return x.detach().to(torch.bfloat16).to(x.dtype) + (x - x.detach())
    return x


def unsupported_stream_backward(backward: str) -> NotImplementedError:
    """The error for stream=True × backward cells without a sweep."""
    return NotImplementedError(
        f"stream=True does not support backward={backward!r}: the streamed "
        "output already materialises every emitted prefix, so use "
        "backward='inverse' or backward='autodiff'")


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def prepend_basepoint(increments: torch.Tensor, lengths, spec, x0,
                      precision: str):
    """The fused cells' bookkeeping, in the reference's order: mask,
    prepend the x0 increment (lengths + 1), quantise.  Returns the
    increments, the lengths and the kernel-level (basepoint-free) spec."""
    if lengths is not None:
        lengths = as_lengths(lengths, increments.shape[0], increments.device)
        increments = mask_increments(increments, lengths)
    if spec.basepoint:
        if x0 is None:
            raise ValueError("transform with basepoint needs x0= (the path "
                             "start point, shape (B, d)); core.signature."
                             "signature passes it automatically")
        x0 = torch.as_tensor(x0, device=increments.device).to(
            increments.dtype)
        increments = torch.cat([x0[:, None, :], increments], dim=1)
        lengths = None if lengths is None else lengths + 1
    increments = quantise_increments(increments, precision)
    return increments, lengths, dataclasses_replace_nobp(spec)


def _fused_torch_signature(increments: torch.Tensor, depth: int, spec, *,
                           x0, stream: bool, stream_stride: int,
                           backward: str, lengths,
                           precision: str) -> torch.Tensor:
    """Fused-transform route of the torch engine: basepoint is an increment
    prepend, lead_lag/time are built per sub-step inside the scan.
    Streaming, lengths masking and emissions are over the augmented axis.
    """
    from .transforms import fused_augment, transform_dim, transform_time_aux
    B, M, d = increments.shape
    increments, lengths_bp, kspec = prepend_basepoint(increments, lengths,
                                                      spec, x0, precision)
    M_bp = increments.shape[1]
    taux = transform_time_aux(kspec, B, M_bp, lengths_bp,
                              device=increments.device)
    M_aug = M_bp * kspec.sub_steps
    if backward == "checkpoint":
        if stream:
            raise unsupported_stream_backward(backward)
        # materialise, then the plain checkpoint cell: the augment is
        # linear, so autograd through it is the transform's adjoint
        return checkpoint_signature(fused_augment(increments, taux, kspec),
                                    depth)
    if backward not in ("inverse", "autodiff"):
        raise ValueError(f"unknown backward mode {backward!r}")
    if stream:
        if M_aug == 0:  # no steps: no emissions
            return increments.new_zeros(
                (B, 0, sig_dim(transform_dim(kspec, d), depth)))
        if backward == "inverse":
            out = FusedInverseSignatureFunction.apply(increments, taux, kspec,
                                                      depth, stream_stride)
        else:
            out = _subsample_stream(_fused_scan_forward(
                increments, taux, kspec, depth, True), M_aug, stream_stride)
        if lengths_bp is not None:
            aug_lengths = lengths_bp * kspec.sub_steps
            out = out * stream_emit_mask(M_aug, stream_stride, aug_lengths
                                         )[..., None].to(out.dtype)
        return out
    if backward == "inverse" and M_aug:
        return FusedInverseSignatureFunction.apply(increments, taux, kspec,
                                                   depth, 0)
    return _fused_scan_forward(increments, taux, kspec, depth, False)


def signature_from_increments(increments, depth: int, *,
                              stream: bool = False, stream_stride: int = 1,
                              backward: str = "inverse",
                              backend: str = "auto", lengths=None,
                              transform=None, x0=None,
                              precision: str = "fp32",
                              device=None) -> torch.Tensor:
    """Truncated signature from increments (B, M, d) -> (B, D_sig).

    ``backend`` other than ``"torch"`` routes through
    :func:`repro_torch.kernels.ops.signature`.  ``stream=True`` emits every
    ``stream_stride``-th prefix signature as (B, M_out, D_sig).  ``lengths``
    (B,) makes the batch ragged: increments at or past each example's length
    are zero-masked, and streamed emissions past each true-terminal slot are
    masked.  ``transform`` fuses basepoint / lead_lag / time_augment into
    the sweep (streamed emissions and lengths over the augmented axis);
    ``x0`` (B, d) is the path start, required iff the transform has a
    basepoint.  ``precision`` is ``"fp32"`` | ``"bf16_fp32"``.
    """
    dev = resolve_device(device)
    increments, squeeze = _as_batched(torch.as_tensor(increments, device=dev))
    if depth < 1:
        raise ValueError("depth must be >= 1")
    precision = canon_precision(precision)
    if backend != "torch":
        from ..kernels import ops  # deferred: ops imports this module
        out = ops.signature(increments, depth, backend=backend,
                            backward=backward, stream=stream,
                            stream_stride=stream_stride, lengths=lengths,
                            transform=transform, x0=x0, precision=precision,
                            device=dev)
        return out[0] if squeeze else out
    from .transforms import as_transform
    spec = as_transform(transform)
    if spec is not None:
        if stream and stream_stride < 1:
            raise ValueError(
                f"stream_stride must be >= 1, got {stream_stride}")
        out = _fused_torch_signature(increments, depth, spec, x0=x0,
                                     stream=stream,
                                     stream_stride=stream_stride,
                                     backward=backward, lengths=lengths,
                                     precision=precision)
        return out[0] if squeeze else out
    increments = quantise_increments(increments, precision)
    if lengths is not None:
        lengths = as_lengths(lengths, increments.shape[0], dev)
        increments = mask_increments(increments, lengths)
    if backward not in ("inverse", "checkpoint", "autodiff"):
        raise ValueError(f"unknown backward mode {backward!r}")
    if stream:
        if backward == "checkpoint":
            raise unsupported_stream_backward(backward)
        if stream_stride < 1:
            raise ValueError(
                f"stream_stride must be >= 1, got {stream_stride}")
        M = increments.shape[1]
        if backward == "inverse" and M:
            out = InverseSignatureFunction.apply(increments, depth,
                                                 stream_stride)
        else:  # autodiff, or no steps and no emissions
            out = _subsample_stream(_scan_forward(increments, depth, True),
                                    M, stream_stride)
        if lengths is not None and M:
            out = out * stream_emit_mask(M, stream_stride,
                                         lengths)[..., None].to(out.dtype)
    elif backward == "inverse":
        out = InverseSignatureFunction.apply(increments, depth, 0)
    elif backward == "checkpoint":
        out = checkpoint_signature(increments, depth)
    else:
        out = _scan_forward(increments, depth, False)
    return out[0] if squeeze else out


def signature(path, depth: int, *, stream: bool = False,
              stream_stride: int = 1, basepoint: bool = False,
              backward: str = "inverse", backend: str = "auto",
              lengths=None, transform=None, precision: str = "fp32",
              device=None) -> torch.Tensor:
    """Truncated signature of a piecewise-linear path (B, M+1, d).

    ``basepoint=True`` prepends X_0 = 0.  ``stream=True`` returns all prefix
    signatures, strided by ``stream_stride`` (terminal always included).
    ``lengths`` (B,) gives each example's true increment count; a
    :class:`repro_torch.ragged.RaggedPaths` may be passed as ``path`` (its
    lengths are used unless overridden).  ``transform``
    (``"time_augment"`` / ``"lead_lag"`` / ``"basepoint"``, composable)
    applies the path transforms fused into the sweep, the basepoint start
    ``x0`` taken from the path.  ``device=None`` means CUDA.
    """
    dev = resolve_device(device)
    values, rl = _unpack_ragged(path)
    if rl is not None and lengths is None:
        lengths = rl
    path, squeeze = _as_batched(torch.as_tensor(values, device=dev))
    if lengths is not None:
        lengths = as_lengths(lengths, path.shape[0], dev)
    if basepoint:
        path = torch.cat([torch.zeros_like(path[:, :1]), path], dim=1)
        if lengths is not None:
            lengths = lengths + 1
    incs = tops.path_increments(path)
    from .transforms import as_transform
    spec = as_transform(transform)
    x0 = path[:, 0] if spec is not None and spec.basepoint else None
    out = signature_from_increments(incs, depth, stream=stream,
                                    stream_stride=stream_stride,
                                    backward=backward, backend=backend,
                                    lengths=lengths, transform=spec, x0=x0,
                                    precision=precision, device=dev)
    return out[0] if squeeze else out


def signature_combine(flat_a: torch.Tensor, flat_b: torch.Tensor, d: int,
                      depth: int) -> torch.Tensor:
    """Chen combine: signature of concatenated paths from the parts'."""
    a = tops.flat_to_levels(flat_a, d, depth)
    b = tops.flat_to_levels(flat_b, d, depth)
    return tops.levels_to_flat(tops.chen_mul(a, b))


def signature_inverse(flat: torch.Tensor, d: int, depth: int) -> torch.Tensor:
    """Group inverse (= signature of the time-reversed path, Lemma 4.5)."""
    s = tops.flat_to_levels(flat, d, depth)
    return tops.levels_to_flat(tops.tensor_inverse(s))
