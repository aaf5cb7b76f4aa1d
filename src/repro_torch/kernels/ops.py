"""The engine-dispatch layer for truncated signatures.

Port of the ``signature`` part of ``repro.kernels.ops``.  ``backend``:

- ``"torch"`` — the plain levelwise Horner scan in PyTorch (runs anywhere,
  differentiable by autograd).
- ``"cuda"``  — the hand-written Hopper ``sig_trunc`` kernel
  (:mod:`repro_torch.kernels.sig_trunc`); needs a CUDA device.
- ``"auto"``  — ``cuda`` on a CUDA device, ``torch`` on the CPU.

``device=None`` means the CUDA card (:mod:`repro_torch.device`).

Backend × backward × stream support matrix (✗ raises)
------------------------------------------------------

=========  ======  =============================  ============  ==========
engine     stream  backward="inverse"             "checkpoint"  "autodiff"
=========  ======  =============================  ============  ==========
torch      False   scan fwd, autograd bwd         not ported    scan AD
torch      True    streamed scan, autograd bwd    ✗             scan AD
cuda       False   kernel fwd, bwd raises         not ported    (torch)
cuda       True    streamed kernel, bwd raises    ✗             (torch)
=========  ======  =============================  ============  ==========

``(torch)`` cells route to the torch engine on the same device.  The §4.2
inverse backward, ``checkpoint`` and ``time_chunks`` land with the training
slice; ``transform=`` with the transforms slice (the errors name the
ROADMAP.md items).  ``backend="hybrid"`` applies to projected word sets only
and raises here, as in the reference.

``lengths`` (B,) works in every cell: padded-tail increments are zero-masked
before the engine runs (a zero increment is the identity Chen update), and
streamed outputs are masked after each example's true-terminal slot.
``precision="bf16_fp32"`` rounds the increments to bf16 once, here, before
any engine runs (straight-through gradient); the kernel then stores them in
bf16 and accumulates in fp32, and streamed emissions are rounded to bf16.
"""
from __future__ import annotations

import torch

from ..core.signature import (CHECKPOINT_ITEM, TRANSFORM_ITEM, as_lengths,
                              canon_precision, mask_increments, not_ported,
                              quantise_increments, signature_from_increments,
                              stream_emit_mask, unsupported_stream_backward)
from ..device import resolve_device
from .sig_trunc import sig_trunc

BACKENDS = ("torch", "cuda", "auto")
BACKWARDS = ("inverse", "checkpoint", "autodiff")


def resolve_backend(backend: str, device: torch.device) -> str:
    """backend string -> engine (``"torch"`` | ``"cuda"``) on ``device``."""
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if backend == "cuda":
        if device.type != "cuda":
            raise ValueError(f"backend='cuda' needs a CUDA device, got "
                             f"device={device}")
        return "cuda"
    if backend == "torch":
        return "torch"
    if backend == "hybrid":
        raise ValueError(
            "backend='hybrid' only applies to projected word sets (the "
            "truncated signature IS the dense engine); use backend='torch'")
    raise ValueError(f"unknown backend {backend!r}; expected one of "
                     f"{BACKENDS}")


def _check_backward(backward: str) -> None:
    if backward not in BACKWARDS:
        raise ValueError(
            f"unknown backward mode {backward!r}; expected one of {BACKWARDS}")


def _mask_stream_out(out: torch.Tensor, M: int, stride: int,
                     lengths) -> torch.Tensor:
    """Zero a streamed output (B, M_out, D) after each example's true-
    terminal slot.  No-op without lengths (or with no emissions)."""
    if lengths is None or out.shape[1] == 0:
        return out
    return out * stream_emit_mask(M, stride, lengths)[..., None].to(out.dtype)


def _signature_local(increments: torch.Tensor, lengths, *, depth: int,
                     engine: str, backward: str, split: int | None,
                     stream: bool, stream_stride: int,
                     precision: str) -> torch.Tensor:
    """Single-device dispatch, in the reference's order: mask, quantise,
    engine, then the streamed output mask."""
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
                            stream_stride=stream_stride, precision=precision)
        # bf16_fp32 stores the emissions in bf16 (the kernel rounds on
        # store); rounding here makes every engine agree on the values
        out = quantise_increments(out, precision)
        return _mask_stream_out(out, increments.shape[1], stream_stride,
                                lengths)
    if engine == "torch" or backward == "autodiff":
        return signature_from_increments(increments, depth, backward=backward,
                                         backend="torch",
                                         device=increments.device)
    return sig_trunc(increments, depth, split=split, precision=precision)


def signature(increments, depth: int, *, backend: str = "auto",
              backward: str = "inverse", split: int | None = None,
              time_chunks: int = 1, stream: bool = False,
              stream_stride: int = 1, lengths=None, transform=None,
              precision: str = "fp32", device=None) -> torch.Tensor:
    """Truncated signature (B, M, d) -> (B, D_sig) on ``device`` (default
    CUDA); see the support matrix in the module docstring.

    ``stream=True`` -> (B, M_out, D_sig) prefix signatures at every
    ``stream_stride``-th step (terminal always included).  ``lengths`` (B,)
    makes the batch ragged.  ``split`` forces the kernel's cone level.
    """
    dev = resolve_device(device)
    increments = torch.as_tensor(increments, device=dev)
    engine = resolve_backend(backend, dev)
    _check_backward(backward)
    precision = canon_precision(precision)
    if transform is not None:
        raise not_ported("transform=", TRANSFORM_ITEM)
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
    if backward == "checkpoint":
        raise not_ported("backward='checkpoint'", CHECKPOINT_ITEM)
    if time_chunks > 1:
        raise not_ported("time_chunks > 1", CHECKPOINT_ITEM)
    if depth < 1:
        raise ValueError("depth must be >= 1")
    return _signature_local(increments, lengths, depth=depth, engine=engine,
                            backward=backward, split=split, stream=stream,
                            stream_stride=stream_stride, precision=precision)
