"""The §4.2 reverse sweep over a prefix-closed word table: the backward of
both signature kernels.

The reference's backwards are ``lax.scan`` loops, not Pallas kernels:
``repro.core.signature.inverse_bwd_scan`` / ``stream_inverse_bwd_scan``
and ``repro.core.projection.projected_inverse_bwd_scan`` /
``projected_stream_inverse_bwd_scan``.  All four are one sweep over the
prefix closure of a word set (for the truncated signature, the closure
of W_{<=N}, whose level-major order is the flat signature order): from
the terminal closure state S_T and the cotangents, step j = M..1
reconstructs S_{j-1} = S_j ⊗ exp(-ΔX_j) (paper Prop. 4.6) and pulls the
cotangent back through the Horner step at (S_{j-1}, ΔX_j), keeping only
O(B·W) live state.  Streamed cotangents enter at their emitted steps
(:func:`repro_torch.core.signature.stream_emit_steps`), added onto their
rows just before that step's pull-back; the terminal cell is the stream
with only the last step emitted.

:func:`sig_sweep_plain` is the sweep as a Python loop in PyTorch, with
the Horner step's VJP written out per closure row; the ``torch`` engine's
inverse backwards call it.  :func:`sig_sweep` is the wrapper of the
hand-written CUDA kernel (``csrc/sig_sweep.cu``), one launch a backward
call, which ``SigTruncFunction`` and ``SigWordsFunction`` call: on a CPU
tensor it runs the plain version, on a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..core.signature import stream_emit_steps
from ..core.words import WordPlan
from . import _build
from .cache import plan_cache

# per-block dynamic shared memory the kernel may take on an H100 (the
# opt-in maximum, 232,448 bytes, less a margin)
SMEM_BUDGET = 232_448 - 1024
MAX_DEPTH = 16        # SS_MAX_DEPTH

# launch counter, bumped where the kernel is launched
launches = 0


@dataclasses.dataclass(frozen=True, eq=False)
class SweepTables:
    """The kernel's tables of a prefix-closed plan, rows level-major."""
    prefix: np.ndarray     # (W, depth) int32 state rows of the links, 0 = eps
    letters: np.ndarray    # (W, depth) int32
    inv: np.ndarray        # (W, depth) float32, 1/(len - k); 0 past len
    lengths: np.ndarray    # (W,) int32
    level_off: np.ndarray  # (depth + 1,) int32: first row of each length
    out_rows: np.ndarray   # (n_out,) int32 state rows of the plan's words


@plan_cache
def sweep_tables(plan: WordPlan) -> SweepTables:
    """The tables of ``plan``'s closure; raises unless its rows are
    level-major (as :func:`repro_torch.core.words.make_plan` lays them)."""
    lengths = np.asarray(plan.lengths, np.int32)
    if np.any(np.diff(lengths) < 0):
        raise ValueError("the sweep needs a level-major closure")
    level_off = np.searchsorted(lengths, np.arange(plan.depth + 1),
                                side="right").astype(np.int32)
    return SweepTables(
        prefix=np.ascontiguousarray(plan.prefix_idx, np.int32),
        letters=np.ascontiguousarray(plan.letters, np.int32),
        inv=np.ascontiguousarray(plan.inv, np.float32), lengths=lengths,
        level_off=level_off,
        out_rows=np.ascontiguousarray(plan.out_rows, np.int32))


@plan_cache
def _tables_on(plan: WordPlan, device: torch.device) -> list[torch.Tensor]:
    t = sweep_tables(plan)
    return [torch.as_tensor(a, device=device) for a in (
        t.prefix, t.letters, t.inv, t.lengths, t.level_off, t.out_rows)]


def sweep_geometry(W: int, d: int, depth: int) -> tuple[int, int, bool]:
    """(threads, shared-memory bytes, state in shared memory) of a launch
    over a closure of W rows: a thread a row up to the instance's most
    threads (1,024 to depth 8, 512 deeper), the state and both cotangent
    buffers in shared memory while they fit ``SMEM_BUDGET``, else in a
    per-example scratch in device memory."""
    if depth > MAX_DEPTH:
        raise ValueError(f"words of length {depth} exceed the kernel's "
                         f"MAX_DEPTH {MAX_DEPTH}")
    cap = 1024 if depth <= 8 else 512
    threads = min(cap, max(32, -(-W // 32) * 32))
    smem = 4 * (2 * d + 3 * (W + 1))
    if smem <= SMEM_BUDGET:
        return threads, smem, True
    return threads, 4 * 2 * d, False


@plan_cache
def emit_slot_table(M: int, stride: int) -> np.ndarray:
    """(M,) int32 the cotangent slot the kernel adds at each step, -1 where
    none: :func:`stream_emit_steps` (``stride`` 0 is the terminal cell,
    only step M - 1 emitted)."""
    steps = stream_emit_steps(M, stride) if stride else np.arange(M)[-1:]
    slots = np.full(M, -1, np.int32)
    slots[steps] = np.arange(len(steps), dtype=np.int32)
    return slots


@plan_cache
def _slots_on(M: int, stride: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(emit_slot_table(M, stride), device=device)


def _check(increments, plan, S_T, g, stream, stream_stride):
    if increments.ndim != 3:
        raise ValueError(f"expected (B, M, d), got {tuple(increments.shape)}")
    B, M, d = increments.shape
    if d != plan.d:
        raise ValueError(f"increments have d={d} channels, the plan is over "
                         f"{plan.d} letters")
    if tuple(S_T.shape) != (B, plan.closure_size):
        raise ValueError(f"S_T must be (B, W) = {(B, plan.closure_size)}, "
                         f"got {tuple(S_T.shape)}")
    if stream_stride < 1:
        raise ValueError(f"stream_stride must be >= 1, got {stream_stride}")
    n_out = len(plan.words)
    want = (B, -(-M // stream_stride), n_out) if stream else (B, n_out)
    if tuple(g.shape) != want:
        raise ValueError(f"the cotangent must be {want}, got "
                         f"{tuple(g.shape)}")


def sig_sweep_plain(increments: torch.Tensor, plan: WordPlan,
                    S_T: torch.Tensor, g: torch.Tensor, *,
                    stream: bool = False,
                    stream_stride: int = 1) -> torch.Tensor:
    """The sweep as a Python loop over time in PyTorch, in the increments'
    dtype.  ``plan`` is prefix-closed or not: the state is its closure;
    ``S_T`` (B, W) the terminal closure coefficients (the eps row is
    implicit); ``g`` the cotangent of ``plan.words``, (B, |I|), or
    (B, M_out, |I|) when streamed.  Returns the increments' gradient
    (B, M, d)."""
    _check(increments, plan, S_T, g, stream, stream_stride)
    from ..core.projection import plan_tables, projected_step
    B, M, d = increments.shape
    dt, dev = increments.dtype, increments.device
    pidx, letters, inv, emit, out_rows = plan_tables(plan, dev, dt)
    lengths = torch.as_tensor(plan.lengths, device=dev)
    S = torch.cat([torch.ones((B, 1), dtype=dt, device=dev), S_T.to(dt)], 1)
    G = torch.zeros_like(S)
    g = g.to(dt)
    slots = emit_slot_table(M, stream_stride if stream else 0)
    gdx = increments.new_zeros((B, M, d))
    for j in range(M - 1, -1, -1):
        if slots[j] >= 0:
            G = G.index_add(1, out_rows, g[:, slots[j]] if stream else g)
        dx = increments[:, j]
        S = projected_step(S, -dx, pidx, letters, inv, emit)   # S_{j-1}
        ps, cs, acc = [], [], None
        for k in range(pidx.shape[1]):   # the Horner chain at (S_{j-1}, dx)
            p = S[:, pidx[:, k]] + (0.0 if acc is None else acc)
            c = dx[:, letters[:, k]] * inv[:, k]
            acc = p * c
            ps.append(p)
            cs.append(c)
        G_new = G.clone()                # the identity term
        b = G[:, 1:]
        for k in range(pidx.shape[1] - 1, -1, -1):
            live = k < lengths           # rows whose chain has link k
            bk = torch.where(live, b, 0.0)
            gdx[:, j].index_add_(1, letters[:, k], bk * ps[k] * inv[:, k])
            pre = bk * cs[k]
            if k > 0:
                G_new.index_add_(1, pidx[:, k], pre)
            b = torch.where(live, pre, b)
        G = G_new
    return gdx


def _lib() -> ctypes.CDLL:
    lib = _build.library("sig_sweep")
    fn = lib.sig_sweep_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 12 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
    return lib


def _launch(increments: torch.Tensor, plan: WordPlan, S_T: torch.Tensor,
            g: torch.Tensor, stride: int) -> torch.Tensor:
    """Launch the kernel on CUDA tensors, B, M >= 1; ``stride`` 0 is the
    terminal cell.  Returns the fp32 (B, M, d) gradient."""
    global launches
    B, M, d = increments.shape
    W, depth = plan.closure_size, plan.depth
    threads, _, in_smem = sweep_geometry(W, d, depth)
    dev = increments.device
    x = increments.detach().float().contiguous()
    s = S_T.detach().float().contiguous()
    gg = g.detach().float().contiguous()
    tabs = _tables_on(plan, dev)
    slots = _slots_on(M, stride, dev)
    n_emit = -(-M // stride) if stride else 1
    scratch = None if in_smem else torch.empty(
        (B, 3, W + 1), dtype=torch.float32, device=dev)
    gx = torch.empty((B, M, d), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.sig_sweep_launch(
            x.data_ptr(), s.data_ptr(), gg.data_ptr(),
            *(t.data_ptr() for t in tabs), slots.data_ptr(),
            None if scratch is None else scratch.data_ptr(), gx.data_ptr(),
            B, M, d, W, depth, len(plan.words), n_emit, threads,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"sig_sweep kernel launch failed with cudaError "
                           f"{err} (B={B}, M={M}, d={d}, W={W}, depth="
                           f"{depth}, stride={stride}, threads={threads})")
    launches += 1
    return gx


def sig_sweep(increments: torch.Tensor, plan: WordPlan, S_T: torch.Tensor,
              g: torch.Tensor, *, stream: bool = False,
              stream_stride: int = 1) -> torch.Tensor:
    """The increments' gradient (B, M, d), in their dtype, by the reverse
    sweep (arguments as for :func:`sig_sweep_plain`).  A CPU tensor runs
    :func:`sig_sweep_plain`; a CUDA tensor launches the kernel, which sums
    in fp32."""
    _check(increments, plan, S_T, g, stream, stream_stride)
    if increments.device.type == "cpu":
        return sig_sweep_plain(increments, plan, S_T, g, stream=stream,
                               stream_stride=stream_stride)
    if increments.device.type != "cuda":
        raise ValueError(f"sig_sweep runs on cuda or cpu tensors, not "
                         f"{increments.device}")
    B, M, _ = increments.shape
    if B == 0 or M == 0:  # no steps: no gradient to sweep, no launch
        return torch.zeros_like(increments)
    gx = _launch(increments, plan, S_T, g, stream_stride if stream else 0)
    return gx.to(increments.dtype)
