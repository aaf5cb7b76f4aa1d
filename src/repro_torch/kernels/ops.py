"""The engine-dispatch layer for truncated and projected signatures and the
weighted signature Gram.

Port of the ``signature``, ``projected``, ``projected_forward_only`` and
``gram`` parts of ``repro.kernels.ops``.  ``backend``:

- ``"torch"`` — the plain PyTorch versions: levelwise Horner for truncated
  signatures, the word-table scan for projections, the word-blocked
  product for the Gram (runs anywhere, differentiable by autograd).
- ``"cuda"``  — the hand-written Hopper kernels: ``sig_trunc``
  (:mod:`repro_torch.kernels.sig_trunc`), ``sig_words``
  (:mod:`repro_torch.kernels.sig_words`) and ``sig_gram``
  (:mod:`repro_torch.kernels.sig_gram`); needs a CUDA device.
- ``"auto"``  — ``cuda`` on a CUDA device, ``torch`` on the CPU.

``device=None`` means the CUDA card (:mod:`repro_torch.device`).

Backend × backward × stream support matrix (✗ raises)
------------------------------------------------------

``signature``:

=========  ======  =============================  ============  ==========
engine     stream  backward="inverse"             "checkpoint"  "autodiff"
=========  ======  =============================  ============  ==========
torch      False   scan fwd, §4.2 plain sweep     not ported    scan AD
torch      True    streamed scan, plain sweep     ✗             scan AD
cuda       False   kernel fwd, ``sig_sweep``      not ported    (torch)
                   kernel bwd
cuda       True    streamed kernel, ``sig_sweep`` ✗             (torch)
                   kernel bwd
=========  ======  =============================  ============  ==========

``projected`` (``projected_forward_only`` runs the ``inverse`` column's
forward over the requested words' tiles instead of the closure's, and
keeps no closure state: its backward raises unless the word set is its
own prefix closure):

=========  ======  =============================  ============  ==========
engine     stream  backward="inverse"             "checkpoint"  "autodiff"
=========  ======  =============================  ============  ==========
torch      False   word-table scan, plain sweep   not ported    scan AD
torch      True    streamed scan, plain sweep     ✗             scan AD
cuda       False   kernel over the closure tiles, not ported    (torch)
                   then ``out_rows``;
                   ``sig_sweep`` kernel bwd
cuda       True    streamed kernel over the       ✗             (torch)
                   closure tiles; ``sig_sweep``
                   kernel bwd
hybrid     any     not ported                     not ported    not ported
=========  ======  =============================  ============  ==========

``gram`` (one row per engine; the product has no stream or backward mode):

=========  ============================================================
engine     forward, backward
=========  ============================================================
torch      word-blocked ``(sx * wb) @ sy.T`` loop, closed-form backward
cuda       ``sig_gram`` kernel, closed-form backward (``torch.matmul``)
hybrid     the torch row (the product has no dense/word split)
=========  ============================================================

``(torch)`` cells route to the torch engine on the same device.  The
``inverse`` backward saves only the increments and the terminal state
(the closure state for projections) and runs the §4.2 reverse sweep, one
``sig_sweep`` launch a call on the card
(:mod:`repro_torch.kernels.sig_sweep`).  ``checkpoint`` and
``time_chunks`` land with the training item; ``transform=`` with the
transforms item; ``backend="hybrid"`` with the hybrid-engine item (the
errors name the ROADMAP.md items).  For truncated signatures
``backend="hybrid"`` raises as in the reference: it applies to projected
word sets only.  ``max_rows`` bounds a tile's closure rows (a caller's
``TiledPlan`` keeps its tiles); the reference's TPU ``batch_tile`` knob has
no counterpart.

``lengths`` (B,) works in every cell: padded-tail increments are zero-masked
before the engine runs (a zero increment is the identity Chen update), and
streamed outputs are masked after each example's true-terminal slot.
``precision="bf16_fp32"`` rounds the increments to bf16 once, here, before
any engine runs (straight-through gradient); the kernels then store them in
bf16 and accumulate in fp32, and streamed emissions are rounded to bf16.
"""
from __future__ import annotations

import torch

from ..core.projection import plan_tables, projected_signature_from_increments
from ..core.signature import (CHECKPOINT_ITEM, HYBRID_ITEM, TRANSFORM_ITEM,
                              as_lengths, canon_precision, mask_increments,
                              not_ported, quantise_increments,
                              signature_from_increments, stream_emit_mask,
                              unsupported_stream_backward)
from ..core.words import TiledPlan, WordPlan, make_plan, make_tiled_plan
from ..device import resolve_device
from .cache import plan_cache
from .sig_gram import sig_gram, sig_gram_plain
from .sig_trunc import sig_trunc
from .sig_words import sig_words

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


def _closure_kernel(increments: torch.Tensor, wplan: WordPlan,
                    max_rows: int, stream: bool, stream_stride: int,
                    precision: str) -> torch.Tensor:
    """The ``sig_words`` kernel over the closure-tiled plan, read at the
    requested words.  The kernel's (B, W) closure coefficients (B, M_out,
    W when streamed) are the closure state the §4.2 backward reconstructs
    from, as in the reference's ``_pallas_proj_inverse``."""
    cw = sig_words(increments,
                   _closure_tiled_plan(wplan.words, wplan.d, max_rows),
                   stream=stream, stream_stride=stream_stride,
                   precision=precision,
                   closure=_plan_for_words(wplan.closure, wplan.d))
    # out_rows count the eps row as 0; the closure words start at 1
    out_rows = plan_tables(wplan, increments.device, torch.float32)[4]
    return cw[..., out_rows - 1]


def _projected_local(increments: torch.Tensor, lengths, *, wplan: WordPlan,
                     engine: str, backward: str, max_rows: int, stream: bool,
                     stream_stride: int, precision: str) -> torch.Tensor:
    """Single-device projected dispatch, in the reference's order: mask,
    quantise, engine, then the streamed output mask."""
    if lengths is not None:
        lengths = as_lengths(lengths, increments.shape[0], increments.device)
        increments = mask_increments(increments, lengths)
    increments = quantise_increments(increments, precision)
    M = increments.shape[1]
    if stream:
        if engine == "torch" or backward == "autodiff" or M == 0:
            out = projected_signature_from_increments(
                increments, wplan, stream=True, stream_stride=stream_stride,
                backward=backward, backend="torch", device=increments.device)
        else:
            out = _closure_kernel(increments, wplan, max_rows, True,
                                  stream_stride, precision)
        # same streamed-emission rounding as _signature_local
        out = quantise_increments(out, precision)
        return _mask_stream_out(out, M, stream_stride, lengths)
    if engine == "torch" or backward == "autodiff":
        return projected_signature_from_increments(
            increments, wplan, backward=backward, backend="torch",
            device=increments.device)
    return _closure_kernel(increments, wplan, max_rows, False, 1, precision)


def _projected_args(increments, plan, backend: str, backward: str,
                    transform, precision: str, device):
    """Validation shared by :func:`projected` and
    :func:`projected_forward_only`."""
    dev = resolve_device(device)
    increments = torch.as_tensor(increments, device=dev)
    if backend == "hybrid":
        raise not_ported("backend='hybrid'", HYBRID_ITEM)
    engine = resolve_backend(backend, dev)
    _check_backward(backward)
    precision = canon_precision(precision)
    if transform is not None:
        raise not_ported("transform=", TRANSFORM_ITEM)
    if increments.ndim != 3:
        raise ValueError(f"expected (B, M, d), got {tuple(increments.shape)}")
    wplan, tplan = _normalise_plans(plan, increments.shape[-1])
    if wplan.d != increments.shape[-1]:
        raise ValueError(f"the word plan is over d={wplan.d} letters, the "
                         f"increments have {increments.shape[-1]} channels")
    return increments, engine, precision, wplan, tplan


def projected(increments, plan, *, backend: str = "auto",
              backward: str = "inverse", max_rows: int = 256,
              stream: bool = False, stream_stride: int = 1, lengths=None,
              transform=None, precision: str = "fp32",
              device=None) -> torch.Tensor:
    """Projected signature over a word set (B, M, d) -> (B, |I|) on
    ``device`` (default CUDA); see the support matrix in the module
    docstring.  ``plan`` is a WordPlan, a TiledPlan or an iterable of letter
    tuples.

    ``stream=True`` -> (B, M_out, |I|) per-step projections at every
    ``stream_stride``-th step (terminal always included).  ``lengths`` (B,)
    makes the batch ragged.  ``max_rows`` bounds the closure tiles of the
    ``cuda`` engine (a TiledPlan's own largest tile sets it instead).
    """
    increments, engine, precision, wplan, tplan = _projected_args(
        increments, plan, backend, backward, transform, precision, device)
    if stream:
        if stream_stride < 1:
            raise ValueError(
                f"stream_stride must be >= 1, got {stream_stride}")
        if backward == "checkpoint":
            raise unsupported_stream_backward(backward)
    if backward == "checkpoint":
        raise not_ported("backward='checkpoint'", CHECKPOINT_ITEM)
    if tplan is not None:  # keep the caller's tile granularity
        max_rows = max(p.closure_size for p in tplan.tiles)
    return _projected_local(increments, lengths, wplan=wplan, engine=engine,
                            backward=backward, max_rows=max_rows,
                            stream=stream, stream_stride=stream_stride,
                            precision=precision)


def projected_forward_only(increments, plan, *, backend: str = "auto",
                           max_rows: int = 256, lengths=None, transform=None,
                           precision: str = "fp32",
                           device=None) -> torch.Tensor:
    """Inference-only projected signature: the ``cuda`` engine runs the
    kernel over the requested words' tiles (a caller's TiledPlan as it is)
    and skips the closure readout, so it keeps no closure state and its
    backward raises (unless the word set is its own prefix closure, whose
    tiles are those of :func:`projected`).  The ``torch`` engine is the
    word-table scan.  (B, M, d) -> (B, |I|)."""
    increments, engine, precision, wplan, tplan = _projected_args(
        increments, plan, backend, "inverse", transform, precision, device)
    if lengths is not None:
        lengths = as_lengths(lengths, increments.shape[0], increments.device)
        increments = mask_increments(increments, lengths)
    increments = quantise_increments(increments, precision)
    if engine == "torch":
        return projected_signature_from_increments(
            increments, wplan, backend="torch", device=increments.device)
    if tplan is None:
        tplan = _tiled_for_words(wplan.words, wplan.d, max_rows)
    return sig_words(increments, tplan, precision=precision)


# ---------------------------------------------------------------------------
# weighted Gram product: word-blocked routes + closed-form product backward
# ---------------------------------------------------------------------------

class GramFunction(torch.autograd.Function):
    """G = S_x diag(w) S_yᵀ with the reference's closed-form VJP
    (``_gram_vjp``): products of (B, D) matrices only, so the backward too
    never forms a (B_x, B_y, D) intermediate."""

    @staticmethod
    def forward(ctx, Sx, Sy, w, engine, block_words):
        ctx.save_for_backward(Sx, Sy, w)
        dt = torch.promote_types(Sx.dtype, torch.float32)
        if engine == "cuda":
            return sig_gram(Sx, Sy, w).to(dt)
        return sig_gram_plain(Sx, Sy, w, block_words)

    @staticmethod
    def backward(ctx, g):
        Sx, Sy, w = ctx.saved_tensors
        g = g.to(torch.promote_types(Sx.dtype, torch.float32))
        dSx = (g @ (Sy * w[None, :])).to(Sx.dtype)
        dSy = (g.T @ (Sx * w[None, :])).to(Sy.dtype)
        dw = ((g.T @ Sx) * Sy).sum(dim=0).to(w.dtype)
        return dSx, dSy, dw, None, None


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
    width from the shape and the pointers (``kernels/sig_gram.py``).
    """
    dev = resolve_device(device)
    Sx = torch.as_tensor(Sx, device=dev)
    Sy = torch.as_tensor(Sy, device=dev)
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
    Sx = quantise_increments(Sx, precision)
    Sy = quantise_increments(Sy, precision)
    return GramFunction.apply(Sx, Sy, weights, engine, block_words)
