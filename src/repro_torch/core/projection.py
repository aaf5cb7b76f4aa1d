"""Signature projections onto arbitrary word sets (paper §3.1, §7),
forward path.

Port of ``repro.core.projection``.  The engine updates the coefficients of
the prefix closure of a requested word set I with the per-word Horner rule
(paper Alg. 1), vectorised over (batch, closure rows); every index table
comes from :func:`repro_torch.core.words.make_plan`.  The state ``S`` is
(B, 1 + W): row 0 is the constant S[eps] = 1, rows 1..W the closure words
in level-major order.

Backends: ``"torch"`` is this word-table scan (runs anywhere,
differentiable by autograd); ``"cuda"`` and ``"auto"`` route through
:func:`repro_torch.kernels.ops.projected` to the Hopper ``sig_words``
kernel.  On the ``torch`` engine ``backward="inverse"`` and ``"autodiff"``
both differentiate by autograd through the scan: the §4.2
``projected_inverse_bwd_scan``, its streamed form and the checkpoint VJP
are not ported yet (:func:`repro_torch.core.signature.not_ported`).
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..kernels.cache import plan_cache
from . import tensor_ops as tops
from .signature import (CHECKPOINT_ITEM, TRANSFORM_ITEM, _as_batched,
                        _unpack_ragged, as_lengths, canon_precision,
                        mask_increments, not_ported, quantise_increments,
                        stream_emit_mask, stream_emit_steps,
                        unsupported_stream_backward)
from .words import WordPlan, make_plan


@plan_cache
def plan_tables(plan: WordPlan, device: torch.device, dtype: torch.dtype):
    """(prefix_idx, letters, inv, emit, out_rows) of a plan as tensors on
    ``device``: int64 indices, divisors and emit masks in ``dtype``."""
    def idx(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    def flt(a):
        return torch.as_tensor(a, device=device).to(dtype)

    return (idx(plan.prefix_idx), idx(plan.letters), flt(plan.inv),
            flt(plan.emit), idx(plan.out_rows))


def projected_step(S: torch.Tensor, dx: torch.Tensor, prefix_idx, letters,
                   inv, emit) -> torch.Tensor:
    """One Chen update of all closure coefficients (paper Alg. 1, batched):
    a per-row gather of the prefix coefficient and the letter's increment.
    S: (B, 1+W) with S[:, 0] == 1;  dx: (B, d)."""
    acc = S.new_zeros((S.shape[0], prefix_idx.shape[0]))
    h = acc
    for j in range(prefix_idx.shape[1]):   # Horner steps
        pfx = S[:, prefix_idx[:, j]]                  # S_old[w_{1:j}]
        dxl = dx[:, letters[:, j]]                    # ΔX^(i_{j+1})
        acc = (pfx + acc) * dxl * inv[:, j]           # /(n - j)
        h = h + acc * emit[:, j]                      # collect at j = n-1
    return torch.cat([S[:, :1], S[:, 1:] + h], dim=1)


def _closure_init(B: int, plan: WordPlan, dtype, device) -> torch.Tensor:
    S = torch.zeros((B, 1 + plan.closure_size), dtype=dtype, device=device)
    S[:, 0] = 1.0
    return S


def _scan_projected(increments: torch.Tensor, plan: WordPlan, stream: bool,
                    stream_stride: int = 1) -> torch.Tensor:
    """The word-table scan, a Python loop over time.  (B, M, d) ->
    (B, |I|), or (B, M_out, |I|) when streamed."""
    B, M, _ = increments.shape
    pidx, letters, inv, emit, out_rows = plan_tables(
        plan, increments.device, increments.dtype)
    S = _closure_init(B, plan, increments.dtype, increments.device)
    emitted = set(stream_emit_steps(M, stream_stride).tolist()) if stream \
        else ()
    ys = []
    for j in range(M):
        S = projected_step(S, increments[:, j], pidx, letters, inv, emit)
        if j in emitted:
            ys.append(S[:, out_rows])
    if not stream:
        return S[:, out_rows]
    if not ys:
        return increments.new_zeros((B, 0, len(plan.words)))
    return torch.stack(ys, 1)


def projected_signature_from_increments(increments, plan: WordPlan, *,
                                        stream: bool = False,
                                        stream_stride: int = 1,
                                        backward: str = "inverse",
                                        backend: str = "auto", lengths=None,
                                        transform=None,
                                        precision: str = "fp32",
                                        device=None) -> torch.Tensor:
    """π_I(S_{0,T}(X)) for the plan's word set I: (B, M, d) -> (B, |I|).

    ``backend`` other than ``"torch"`` routes through
    :func:`repro_torch.kernels.ops.projected`.  ``stream=True`` emits every
    ``stream_stride``-th per-step projection as (B, M_out, |I|).
    ``lengths`` (B,) makes the batch ragged (zero-masked padded tails,
    masked post-end emissions).  ``precision`` is ``"fp32"`` |
    ``"bf16_fp32"``.  ``device=None`` means CUDA.
    """
    dev = resolve_device(device)
    increments, squeeze = _as_batched(torch.as_tensor(increments, device=dev))
    precision = canon_precision(precision)
    if transform is not None:
        raise not_ported("transform=", TRANSFORM_ITEM)
    if backend != "torch":
        from ..kernels import ops  # deferred: ops imports this module
        out = ops.projected(increments, plan, backend=backend,
                            backward=backward, stream=stream,
                            stream_stride=stream_stride, lengths=lengths,
                            precision=precision, device=dev)
        return out[0] if squeeze else out
    if backward == "checkpoint":
        if stream:
            raise unsupported_stream_backward(backward)
        raise not_ported("backward='checkpoint'", CHECKPOINT_ITEM)
    if backward not in ("inverse", "autodiff"):
        raise ValueError(f"unknown backward mode {backward!r}")
    if lengths is not None:
        lengths = as_lengths(lengths, increments.shape[0], dev)
        increments = mask_increments(increments, lengths)
    increments = quantise_increments(increments, precision)
    if stream:
        if stream_stride < 1:
            raise ValueError(
                f"stream_stride must be >= 1, got {stream_stride}")
        M = increments.shape[1]
        out = _scan_projected(increments, plan, True, stream_stride)
        if lengths is not None and M:
            out = out * stream_emit_mask(M, stream_stride,
                                         lengths)[..., None].to(out.dtype)
    else:
        out = _scan_projected(increments, plan, False)
    return out[0] if squeeze else out


def projected_signature(path, words, d: int | None = None, *,
                        plan: WordPlan | None = None, stream: bool = False,
                        stream_stride: int = 1, backward: str = "inverse",
                        backend: str = "auto", lengths=None, transform=None,
                        precision: str = "fp32",
                        device=None) -> torch.Tensor:
    """Signature coefficients of an arbitrary word set (paper §7.1) of a
    path (B, M+1, d).

    ``words`` is an iterable of letter tuples (0-based), or pass a prebuilt
    ``plan``.  ``lengths`` (B,) makes the batch ragged; a
    :class:`repro_torch.ragged.RaggedPaths` may be passed as ``path``.
    ``device=None`` means CUDA.
    """
    dev = resolve_device(device)
    values, rl = _unpack_ragged(path)
    if rl is not None and lengths is None:
        lengths = rl
    path, squeeze = _as_batched(torch.as_tensor(values, device=dev))
    if transform is not None:
        raise not_ported("transform=", TRANSFORM_ITEM)
    if plan is None:
        plan = make_plan(tuple(tuple(w) for w in words),
                         path.shape[-1] if d is None else d)
    out = projected_signature_from_increments(
        tops.path_increments(path), plan, stream=stream,
        stream_stride=stream_stride, backward=backward, backend=backend,
        lengths=lengths, precision=precision, device=dev)
    return out[0] if squeeze else out
