"""Truncated signature by prefix cones: the Hopper kernel's host side.

Port of ``repro.kernels.sig_trunc``.  The word basis W_{<=N} is cut into
d^s prefix cones: cone ``c`` owns the level-``s`` prefix word
``u = digits_d(c)``, every descendant ``u∘v`` up to depth N, and a redundant
copy of u's ancestor path.  Per-cone state block, ``rows`` floats:

  [ path: levels 1..s-1 along u ] ++ [ cone levels s..N: d^0, ..., d^{N-s} ]

The CUDA kernel (``csrc/sig_trunc.cu``) writes these blocks;
:func:`_reassemble` gathers them into the flat level-major layout.
``stream=True`` emits every ``stream_stride``-th prefix signature and the
terminal one.  :func:`plan_launch` chooses the kernel's partition: the
split s, the threads an (example, cone) gets, where the top level lives
and how many examples share a block; :func:`kernel_smem` gives the shared
memory a block then takes.  :func:`state_footprint` and
:func:`choose_split` keep the reference's meaning: the bytes of the cone
state block and the smallest split whose block fits.

On a CPU tensor :func:`sig_trunc` runs :func:`sig_trunc_plain`, the
levelwise Horner scan; on a CUDA tensor it launches the kernel or raises.
:class:`SigTruncFunction` saves the increments and the terminal signature
(the last emission when streamed) and its backward is the §4.2 sweep
kernel over the truncation's word table
(:func:`repro_torch.kernels.sig_sweep.sig_sweep`), one launch a call.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core.signature import (_scan_forward, _subsample_stream,
                              canon_precision, truncation_closure)
from ..core.words import sig_dim
from . import _build
from .cache import plan_cache
from .sig_sweep import sig_sweep

# per-block dynamic shared memory the kernel may take on an H100: the opt-in
# maximum (232,448 bytes) less a margin for the kernel's static tables
SMEM_BUDGET = 232_448 - 1024
CHUNK = 32          # increments staged per shared-memory load (SIG_CHUNK)
MAX_DEPTH = 16      # SIG_MAX_DEPTH
MAX_THREADS = 1024
MAX_CELLS = 65_535  # the grid's y extent
SMS = 132           # streaming multiprocessors of an H100 SXM
# top-level words a thread keeps in registers (0: the top level stays in
# shared memory), and the threads a block may then have: the kernel's
# MaxBlock, 64, 128 or 255 registers a thread of the SM's 65,536
MAX_BLOCK = {0: 1024, 1: 1024, 2: 1024, 4: 512, 8: 512, 16: 256, 32: 256}
MAX_TOP = max(k * t for k, t in MAX_BLOCK.items())  # top words in registers
CONE_THREADS = 96   # threads the planner aims to give one (example, cone)
PLAN_TOP = 2048     # the planner's splits keep a cone's top level to this
MIN_BLOCK = 128     # below this, examples of one cone may share a block

# launch counters: one per kernel cell, bumped where the kernel is launched
launches = 0
stream_launches = 0


def cone_base_level(s: int) -> int:
    """Lowest global level stored in the cone (eps is never stored)."""
    return max(s, 1)


def cone_offsets(d: int, depth: int, s: int) -> np.ndarray:
    """Row offsets of cone global levels n = base..depth inside the block."""
    base = cone_base_level(s)
    sizes = [d ** (n - s) for n in range(base, depth + 1)]
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


def cone_rows(d: int, depth: int, s: int) -> int:
    return int(cone_offsets(d, depth, s)[-1])


def state_footprint(d: int, depth: int, s: int) -> int:
    """Dynamic shared-memory bytes of one block at split ``s``: the fp32
    state (ancestor path + cone rows) and CHUNK staged fp32 increments."""
    rows = max(0, s - 1) + cone_rows(d, depth, s)
    return 4 * (rows + CHUNK * d)


def choose_split(d: int, depth: int, smem_budget: int = SMEM_BUDGET) -> int:
    """Smallest split level s whose block state fits ``smem_budget``."""
    for s in range(0, depth):
        if state_footprint(d, depth, s) <= smem_budget:
            return s
    raise ValueError(f"no split of d={d}, depth={depth} fits "
                     f"{smem_budget} bytes of shared memory")


def level_counts(d: int, depth: int, s: int) -> list[int]:
    """Entries of global level j = 0..depth in one cone: one along the
    prefix u (j <= s), d^(j-s) below it."""
    return [1 if j <= s else d ** (j - s) for j in range(depth + 1)]


def level_rows(d: int, depth: int, s: int) -> list[int]:
    """Row of level j's first entry in the cone block, j = 0..depth (the
    path's levels 1..s-1 first, then the cone's; level 0 is not stored)."""
    base = cone_base_level(s)
    co = cone_offsets(d, depth, s)
    n_path = max(0, s - 1)
    return [0] + [j - 1 if j < s else n_path + int(co[j - base])
                  for j in range(1, depth + 1)]


def chain_offsets(d: int, depth: int, s: int) -> list[int]:
    """Offset of level j's chain buffer, j = 0..depth: level j leaves one
    value per entry for each target level above it, (depth - j)·cnt_j."""
    cnt = level_counts(d, depth, s)
    return [int(v) for v in np.cumsum(
        [0] + [(depth - j) * cnt[j] for j in range(depth)])]


def kernel_smem(d: int, depth: int, s: int, top_slots: int) -> int:
    """Dynamic shared-memory bytes the kernel takes for one example at
    split ``s``: the fp32 cone state block less its top level when that
    sits in registers (``top_slots`` > 0), the chain buffers, and CHUNK
    steps of increments scaled by 1/k for k = 1..depth.  The C entry point
    derives the same from the geometry."""
    rows = max(0, s - 1) + cone_rows(d, depth, s)
    if top_slots:
        rows -= d ** (depth - s)
    return 4 * (rows + chain_offsets(d, depth, s)[-1] + CHUNK * depth * d)


class LaunchPlan(NamedTuple):
    """One launch: split s; ``threads`` per (example, cone);
    ``top_slots`` top-level words a thread keeps in registers (0: the top
    level stays in shared memory); ``examples`` of one cone per block; the
    grid (blocks of examples, cones) and a block's dynamic shared memory."""
    split: int
    threads: int
    top_slots: int
    examples: int
    grid: tuple[int, int]
    smem: int

    @property
    def block(self) -> int:
        return self.threads * self.examples


def slot_threads(top: int, k: int) -> int:
    """Threads that hold ``top`` words at ``k`` a thread: a power of two
    below a warp (several examples then share a warp), whole warps
    above."""
    t = -(-top // k)
    return 1 << (t - 1).bit_length() if t < 32 else -(-t // 32) * 32


def cone_threads(d: int, depth: int, s: int) -> tuple[int, int]:
    """(threads, top slots) of one (example, cone) at split ``s``: the
    fewest slots that keep the threads within ``CONE_THREADS``, else 32
    slots; a top level wider than the registers hold (``MAX_TOP``) stays
    in shared memory (0 slots), a thread per word up to 1,024."""
    top = d ** (depth - s)
    if top > MAX_TOP:
        return min(MAX_THREADS, -(-top // 32) * 32), 0
    for k in (1, 2, 4, 8, 16, 32):
        if slot_threads(top, k) <= CONE_THREADS:
            return slot_threads(top, k), k
    return slot_threads(top, 32), 32


def check_split(d: int, depth: int, s: int) -> None:
    """Raise ValueError unless the kernel can run split ``s``: the cone
    state block fits a block's shared memory (as for ``choose_split``),
    the cones fit the grid, and the kernel's own shared memory fits."""
    if not 0 <= s < depth:
        raise ValueError(f"split {s} outside [0, {depth})")
    if depth > MAX_DEPTH:
        raise ValueError(f"depth {depth} above the kernel's {MAX_DEPTH}")
    foot = state_footprint(d, depth, s)
    if foot > SMEM_BUDGET:
        raise ValueError(f"split {s} has a {foot}-byte cone state, above "
                         f"the {SMEM_BUDGET} bytes a block may take")
    if d**s > MAX_CELLS:
        raise ValueError(f"split {s} gives {d**s} cones, above {MAX_CELLS}")
    smem = kernel_smem(d, depth, s, cone_threads(d, depth, s)[1])
    if smem > SMEM_BUDGET:
        raise ValueError(f"split {s} needs {smem} bytes of shared memory, "
                         f"above the {SMEM_BUDGET} a block may take")


@plan_cache
def plan_launch(B: int, d: int, depth: int, split: int | None = None,
                examples: int | None = None) -> LaunchPlan:
    """The kernel's partition for (B, ·, d) increments at ``depth``.

    The split: the smallest feasible one (never below
    :func:`choose_split`) whose cones keep the top level to ``PLAN_TOP``
    words and give B·d^s >= ``SMS`` blocks; if none gives that many, the
    deepest such split.  The threads and top slots: :func:`cone_threads`.
    Examples of one cone share a block while the block stays within
    ``MIN_BLOCK`` threads and the blocks still cover every SM.  ``split``
    and ``examples`` force the cone level and the examples a block."""
    if split is None:
        fits = feasible_splits(d, depth)
        if not fits:
            raise ValueError(f"no split of d={d}, depth={depth} fits the "
                             f"kernel ({SMEM_BUDGET} bytes of shared memory)")
        cands = [s for s in fits if d ** (depth - s) <= PLAN_TOP] or fits
        s = next((s for s in cands if B * d**s >= SMS), cands[-1])
    else:
        s = split
        check_split(d, depth, s)
    t, k = cone_threads(d, depth, s)
    smem = kernel_smem(d, depth, s, k)
    cells = d**s
    if examples is None:
        e = 1
        while (2 * e * t <= min(MIN_BLOCK, MAX_BLOCK[k]) and 2 * e <= B
               and 2 * e * smem <= SMEM_BUDGET
               and -(-B // (2 * e)) * cells >= SMS):
            e *= 2
    else:
        e = examples
        if e < 1 or e * t > MAX_BLOCK[k] or e * smem > SMEM_BUDGET:
            raise ValueError(f"{e} examples a block do not fit split {s} "
                             f"({t} threads and {smem} bytes each)")
    return LaunchPlan(s, t, k, e, (-(-B // e), cells), e * smem)


def feasible_splits(d: int, depth: int) -> list[int]:
    """Every split the kernel can run at (d, depth)."""
    out = []
    for s in range(min(depth, MAX_DEPTH)):
        try:
            check_split(d, depth, s)
        except ValueError:
            continue
        out.append(s)
    return out


def partition_variants(B: int, d: int, depth: int) -> list[LaunchPlan]:
    """Every partition the planner can choose for a (B, ·, d) batch: its
    own, and each feasible split with one example a block and with the
    most examples of one cone that may share a block.  For tests and
    chip_smoke.py."""
    plans = [plan_launch(B, d, depth)]
    for s in feasible_splits(d, depth):
        one = plan_launch(B, d, depth, split=s, examples=1)
        e = 1
        while (2 * e * one.threads <= min(MIN_BLOCK, MAX_BLOCK[one.top_slots])
               and 2 * e * one.smem <= SMEM_BUDGET):
            e *= 2
        plans += [one, plan_launch(B, d, depth, split=s, examples=e)]
    return list(dict.fromkeys(plans))


@plan_cache
def cone_gather_index(d: int, depth: int, s: int) -> np.ndarray:
    """(D_sig,) position of each flat signature coefficient in the
    flattened (d^s · rows) cone blocks.  Ancestor level ``lev`` is read from
    the cells ``arange(d^lev) · d^(s-lev)``, which own it."""
    n_cells = d**s
    n_path = max(0, s - 1)
    base = cone_base_level(s)
    co = cone_offsets(d, depth, s)
    pos = np.arange(n_cells * (n_path + int(co[-1]))).reshape(n_cells, -1)
    levels = [pos[np.arange(d**lev) * d ** (s - lev), lev - 1]
              for lev in range(1, s)]
    for n in range(base, depth + 1):
        k = n - base
        levels.append(pos[:, n_path + int(co[k]):n_path + int(co[k + 1])]
                      .reshape(-1))
    return np.concatenate(levels)


@plan_cache
def _gather_index_on(d: int, depth: int, s: int,
                     device: torch.device) -> torch.Tensor:
    return torch.as_tensor(cone_gather_index(d, depth, s), device=device)


def _reassemble(out: torch.Tensor, d: int, depth: int,
                s: int) -> torch.Tensor:
    """(..., d^s, rows) cone blocks -> (..., D_sig) flat signatures.  The
    leading axes are (B,) or (B, M_out), so one gather serves both the
    reference's ``_reassemble`` and ``_reassemble_stream``."""
    return out.flatten(-2)[..., _gather_index_on(d, depth, s, out.device)]


def _storage_dtype(precision: str) -> torch.dtype:
    """Increment (and streamed emission) storage: bf16 under bf16_fp32."""
    if canon_precision(precision) == "bf16_fp32":
        return torch.bfloat16
    return torch.float32


def _lib() -> ctypes.CDLL:
    lib = _build.library("sig_trunc")
    fn = lib.sig_trunc_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p] + [i] * 11 + [p]
        fn.restype = ctypes.c_int
    return lib


def _launch(incs: torch.Tensor, depth: int, split: int | None, stream: bool,
            stride: int, precision: str,
            plan: LaunchPlan | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA increments (B, M, d), B, M >= 1.  Returns
    fp32 (B, D_sig), or (B, M_out, D_sig) in the storage dtype.  ``plan``
    (from :func:`plan_launch`) replaces the planner's, for tests and
    measurements."""
    global launches, stream_launches
    B, M, d = incs.shape
    if plan is None:
        plan = plan_launch(B, d, depth, split)
    s = plan.split
    rows = max(0, s - 1) + cone_rows(d, depth, s)
    storage = _storage_dtype(precision)
    x = incs.detach().to(storage).contiguous()
    cells = plan.grid[1]
    if stream:
        out = torch.empty((B, -(-M // stride), cells, rows), dtype=storage,
                          device=x.device)
    else:
        out = torch.empty((B, cells, rows), dtype=torch.float32,
                          device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.sig_trunc_launch(
            x.data_ptr(), out.data_ptr(), B, M, d, depth, s,
            stride if stream else 0, int(storage == torch.bfloat16),
            int(stream and storage == torch.bfloat16), plan.threads,
            plan.examples, plan.top_slots,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"sig_trunc kernel launch failed with cudaError "
                           f"{err} (B={B}, M={M}, d={d}, depth={depth}, "
                           f"{plan})")
    if stream:
        stream_launches += 1
    else:
        launches += 1
    return _reassemble(out, d, depth, s)


class SigTruncFunction(torch.autograd.Function):
    """The CUDA cell as an autograd node: the kernel forward, saving the
    increments and the terminal signature (a copy of the streamed cell's
    last emission, as the reference's ``_pallas_sig_stream`` does), and the
    §4.2 reverse sweep kernel as its backward."""

    @staticmethod
    def forward(ctx, increments, depth, split, stream, stride, precision):
        out = _launch(increments, depth, split, stream, stride, precision)
        ctx.save_for_backward(increments,
                              out[:, -1].clone() if stream else out)
        ctx.depth, ctx.stream, ctx.stride = depth, stream, stride
        return out

    @staticmethod
    def backward(ctx, g):
        increments, terminal = ctx.saved_tensors
        plan = truncation_closure(increments.shape[-1], ctx.depth)
        gx = sig_sweep(increments, plan, terminal, g, stream=ctx.stream,
                       stream_stride=ctx.stride)
        return gx, None, None, None, None, None


def sig_trunc_plain(increments: torch.Tensor, depth: int, *,
                    stream: bool = False,
                    stream_stride: int = 1) -> torch.Tensor:
    """The kernel's plain PyTorch version: the levelwise Horner scan, a
    Python loop over time (:func:`repro_torch.core.tensor_ops.horner_step`).
    (B, M, d) -> (B, D_sig), or (B, M_out, D_sig) when streamed."""
    if not stream:
        return _scan_forward(increments, depth, False)
    return _subsample_stream(_scan_forward(increments, depth, True),
                             increments.shape[1], stream_stride)


def sig_trunc(increments: torch.Tensor, depth: int, *,
              split: int | None = None, stream: bool = False,
              stream_stride: int = 1,
              precision: str = "fp32") -> torch.Tensor:
    """Truncated signature through the cone kernel.  (B, M, d) ->
    (B, D_sig), or with ``stream=True`` (B, M_out, D_sig), M_out =
    ceil(M / stream_stride), in the input dtype.

    Increments are stored in the precision's dtype (bf16 under
    ``"bf16_fp32"``) and accumulated in fp32; float64 inputs run in fp32 and
    are cast back.  ``split`` forces the cone level (default: the
    planner's, :func:`plan_launch`).  A CPU tensor runs :func:`sig_trunc_plain` on
    the same rounded values; a CUDA tensor launches the kernel.
    """
    if increments.ndim != 3:
        raise ValueError(f"expected (B, M, d), got {tuple(increments.shape)}")
    B, M, d = increments.shape
    if depth < 1:
        raise ValueError("depth must be >= 1")
    if stream_stride < 1:
        raise ValueError(f"stream_stride must be >= 1, got {stream_stride}")
    storage = _storage_dtype(precision)
    if split is not None:
        check_split(d, depth, split)
    if increments.device.type == "cpu":
        x = increments.to(storage).to(torch.float32)
        out = sig_trunc_plain(x, depth, stream=stream,
                              stream_stride=stream_stride)
        return out.to(storage if stream else torch.float32).to(
            increments.dtype)
    if increments.device.type != "cuda":
        raise ValueError(f"sig_trunc runs on cuda or cpu tensors, not "
                         f"{increments.device}")
    if B == 0 or M == 0:  # no steps: zeros, no launch
        shape = (B, -(-M // stream_stride), sig_dim(d, depth)) if stream \
            else (B, sig_dim(d, depth))
        return increments.new_zeros(shape)
    out = SigTruncFunction.apply(increments, depth, split, stream,
                                 stream_stride, precision)
    return out.to(increments.dtype)
