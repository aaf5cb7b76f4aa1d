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
- ``"checkpoint"`` (the √M checkpoint sweep) raises, naming its ROADMAP.md
  item.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.cache import plan_cache
from . import tensor_ops as tops
from .words import WordPlan, sig_dim, truncation_plan


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a reference feature that a later slice of the port
    brings; ``item`` names the ROADMAP.md entry."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: it lands with ROADMAP.md "
        f"{item}")


CHECKPOINT_ITEM = ("queue 1 item 5 (training: the √M checkpoint sweep and "
                   "time_chunks)")
TRANSFORM_ITEM = "queue 1 item 6 (transforms and the fused kernel sub-steps)"
HYBRID_ITEM = "queue 1 item 8 (the hybrid dense + top-word engine)"


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

def signature_from_increments(increments, depth: int, *,
                              stream: bool = False, stream_stride: int = 1,
                              backward: str = "inverse",
                              backend: str = "auto", lengths=None,
                              transform=None,
                              precision: str = "fp32",
                              device=None) -> torch.Tensor:
    """Truncated signature from increments (B, M, d) -> (B, D_sig).

    ``backend`` other than ``"torch"`` routes through
    :func:`repro_torch.kernels.ops.signature`.  ``stream=True`` emits every
    ``stream_stride``-th prefix signature as (B, M_out, D_sig).  ``lengths``
    (B,) makes the batch ragged: increments at or past each example's length
    are zero-masked, and streamed emissions past each true-terminal slot are
    masked.  ``precision`` is ``"fp32"`` | ``"bf16_fp32"``.
    """
    dev = resolve_device(device)
    increments, squeeze = _as_batched(torch.as_tensor(increments, device=dev))
    if depth < 1:
        raise ValueError("depth must be >= 1")
    precision = canon_precision(precision)
    if transform is not None:
        raise not_ported("transform=", TRANSFORM_ITEM)
    if backend != "torch":
        from ..kernels import ops  # deferred: ops imports this module
        out = ops.signature(increments, depth, backend=backend,
                            backward=backward, stream=stream,
                            stream_stride=stream_stride, lengths=lengths,
                            precision=precision, device=dev)
        return out[0] if squeeze else out
    increments = quantise_increments(increments, precision)
    if lengths is not None:
        lengths = as_lengths(lengths, increments.shape[0], dev)
        increments = mask_increments(increments, lengths)
    if backward == "checkpoint":
        if stream:
            raise unsupported_stream_backward(backward)
        raise not_ported("backward='checkpoint'", CHECKPOINT_ITEM)
    if backward not in ("inverse", "autodiff"):
        raise ValueError(f"unknown backward mode {backward!r}")
    if stream:
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
    lengths are used unless overridden).  ``device=None`` means CUDA.
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
    out = signature_from_increments(incs, depth, stream=stream,
                                    stream_stride=stream_stride,
                                    backward=backward, backend=backend,
                                    lengths=lengths, transform=transform,
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
