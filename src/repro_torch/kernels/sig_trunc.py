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
levelwise Horner scan; on a CUDA tensor it launches the kernel, the
registered operator ``pathsig::sig_trunc``
(:mod:`repro_torch.kernels.library`), or raises; on a meta tensor the
operator's Meta implementation gives the output's shape, with nothing
built or launched, so ``obs.record_cost`` counts the kernel route's work.
:class:`SigTruncFunction` saves the increments and the terminal signature
(the last emission when streamed) and its backward is the §4.2 sweep
kernel over the truncation's word table
(:func:`repro_torch.kernels.sig_sweep.sig_sweep`), one launch a call.

``transform=`` (a basepoint-free
:class:`repro_torch.core.transforms.Transform`) and ``taux=`` fuse
lead_lag / time_augment into the kernel: it reads the raw (B, M, d_raw)
increments and builds each augmented increment as it stages a chunk, so
the partition and the state are those of d_aug letters
(:func:`repro_torch.core.transforms.transform_dim`) and ``CHUNK`` counts
augmented steps.  The autograd node then saves the raw increments and
``taux``, never the augmented tensor; its backward builds that tensor
transiently (``fused_augment``), runs the same sweep kernel over its
M_aug steps and applies ``fused_adjoint``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core.signature import (_fused_scan_forward, _scan_forward,
                              _subsample_stream, canon_precision,
                              truncation_closure)
from ..core.transforms import fused_adjoint, fused_augment, transform_dim
from ..core.words import sig_dim
from ..obs.compile import count_new_shape
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

# launch counters: one per kernel cell, bumped where the kernel is launched;
# fused_launches also counts the launches of either cell with a transform
launches = 0
stream_launches = 0
fused_launches = 0
# every launch shape met so far (the wrapper's counterpart of a jit cache)
launch_shapes: set = set()


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
        fn.argtypes = [p, p, p] + [i] * 14 + [p]
        fn.restype = ctypes.c_int
    return lib


def fuse_flags(transform) -> tuple[bool, bool]:
    """(lead_lag, time) of a kernel-level transform; raises on a basepoint,
    which the dispatch prepends as an increment before the kernel."""
    if transform is None:
        return False, False
    if transform.basepoint:
        raise ValueError("kernel-level transform must not include basepoint "
                         "(dispatch prepends the x0 increment first)")
    return transform.lead_lag, transform.time


def _launch(incs: torch.Tensor, depth: int, split: int | None, stream: bool,
            stride: int, precision: str, plan: LaunchPlan | None = None,
            transform=None, taux: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA (or meta) increments (B, M, d_raw), B, M
    >= 1, through ``pathsig::sig_trunc``.  Returns fp32 (B, D_sig), or
    (B, M_out, D_sig) in the storage dtype, over the d =
    transform_dim(transform, d_raw) augmented letters and M_aug augmented
    steps.  ``plan`` (from :func:`plan_launch` at d) replaces the
    planner's (a forced partition, or the autotuner's)."""
    B, _, d_raw = incs.shape
    ll, time = fuse_flags(transform)
    d = transform_dim(transform, d_raw)
    if plan is None:
        plan = plan_launch(B, d, depth, split)
    x = incs.detach().to(_storage_dtype(precision)).contiguous()
    ta = taux.detach().to(device=x.device, dtype=torch.float32).contiguous() \
        if time else None
    out = torch.ops.pathsig.sig_trunc(
        x, ta, depth, int(ll), int(time), plan.split,
        stride if stream else 0, plan.threads, plan.examples,
        plan.top_slots)
    return _reassemble(out, d, depth, plan.split)


def _output(x: torch.Tensor, taux: torch.Tensor | None, depth: int,
            lead_lag: int, time: int, split: int, stride: int, *partition
            ) -> torch.Tensor:
    """The cone blocks ``pathsig::sig_trunc`` writes, on ``x``'s device
    (its Meta implementation): fp32 (B, d^s, rows), or streamed (B,
    M_out, d^s, rows) in the increments' storage dtype."""
    B, M, d_raw = x.shape
    d = d_raw * (2 if lead_lag else 1) + time
    rows = max(0, split - 1) + cone_rows(d, depth, split)
    if stride:
        M_aug = 2 * M if lead_lag else M
        return torch.empty((B, -(-M_aug // stride), d**split, rows),
                           dtype=x.dtype, device=x.device)
    return torch.empty((B, d**split, rows), dtype=torch.float32,
                       device=x.device)


def _kernel(x: torch.Tensor, taux: torch.Tensor | None, depth: int,
            lead_lag: int, time: int, split: int, stride: int, threads: int,
            examples: int, top_slots: int) -> torch.Tensor:
    """``pathsig::sig_trunc`` on the card: the kernel over contiguous
    increments in the storage dtype (fp32 or bf16) and fp32 time rows;
    ``stride`` 0 is the terminal cell.  Returns the cone blocks."""
    global launches, stream_launches, fused_launches
    B, M, d_raw = x.shape
    d = d_raw * (2 if lead_lag else 1) + time
    bf16 = x.dtype == torch.bfloat16
    out = _output(x, taux, depth, lead_lag, time, split, stride)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.sig_trunc_launch(
            x.data_ptr(), None if taux is None else taux.data_ptr(),
            out.data_ptr(), B, M, d_raw, d, lead_lag, time, depth, split,
            stride, int(bf16), int(bool(stride) and bf16), threads,
            examples, top_slots,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"sig_trunc kernel launch failed with cudaError "
                           f"{err} (B={B}, M={M}, d={d}, depth={depth}, "
                           f"lead_lag={lead_lag}, time={time}, split={split},"
                           f" threads={threads}, examples={examples}, "
                           f"top_slots={top_slots})")
    if stride:
        stream_launches += 1
    else:
        launches += 1
    if lead_lag or time:
        fused_launches += 1
    return out


class SigTruncFunction(torch.autograd.Function):
    """The CUDA cell as an autograd node: the kernel forward, saving the
    increments, ``taux`` and the terminal signature (a copy of the
    streamed cell's last emission, as the reference's
    ``_pallas_sig_stream`` does), and the §4.2 reverse sweep kernel as its
    backward.  With a ``transform`` the saved increments are the raw ones;
    the backward builds the augmented increments for the sweep and pulls
    its gradient back through the transform's adjoint (``taux`` gets
    none)."""

    @staticmethod
    def forward(ctx, increments, depth, split, stream, stride, precision,
                transform=None, taux=None, examples=None):
        plan = None if examples is None else plan_launch(
            increments.shape[0], transform_dim(transform,
                                               increments.shape[-1]),
            depth, split, examples)
        out = _launch(increments, depth, split, stream, stride, precision,
                      plan, transform, taux)
        ctx.save_for_backward(increments, taux,
                              out[:, -1].clone() if stream else out)
        ctx.depth, ctx.stream, ctx.stride = depth, stream, stride
        ctx.transform = transform
        return out

    @staticmethod
    def backward(ctx, g):
        increments, taux, terminal = ctx.saved_tensors
        e = increments if ctx.transform is None else fused_augment(
            increments, taux, ctx.transform)
        plan = truncation_closure(e.shape[-1], ctx.depth)
        gx = sig_sweep(e, plan, terminal, g, stream=ctx.stream,
                       stream_stride=ctx.stride)
        if ctx.transform is not None:
            gx = fused_adjoint(gx, ctx.transform, increments.shape[-1])
        return gx, None, None, None, None, None, None, None, None


def sig_trunc_plain(increments: torch.Tensor, depth: int, *,
                    stream: bool = False, stream_stride: int = 1,
                    transform=None,
                    taux: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's plain PyTorch version: the levelwise Horner scan, a
    Python loop over time (:func:`repro_torch.core.tensor_ops.horner_step`);
    with a ``transform``, the fused scan over the augmented sub-steps
    (:func:`repro_torch.core.signature._fused_scan_forward`).
    (B, M, d) -> (B, D_sig), or (B, M_out, D_sig) when streamed."""
    if transform is None:
        full = _scan_forward(increments, depth, stream)
    else:
        full = _fused_scan_forward(increments, taux, transform, depth, stream)
    if not stream:
        return full
    return _subsample_stream(full, full.shape[1], stream_stride)


def sig_trunc(increments: torch.Tensor, depth: int, *,
              split: int | None = None, stream: bool = False,
              stream_stride: int = 1, precision: str = "fp32",
              transform=None, taux: torch.Tensor | None = None,
              examples: int | None = None) -> torch.Tensor:
    """Truncated signature through the cone kernel.  (B, M, d) ->
    (B, D_sig), or with ``stream=True`` (B, M_out, D_sig), M_out =
    ceil(M / stream_stride), in the input dtype.

    Increments are stored in the precision's dtype (bf16 under
    ``"bf16_fp32"``) and accumulated in fp32; float64 inputs run in fp32 and
    are cast back.  ``split`` forces the cone level (default: the
    planner's, :func:`plan_launch`) and ``examples`` the examples of one
    cone a block.  ``transform`` (basepoint-free) and
    ``taux`` (the (B, 2) ``transform_time_aux`` rows, needed iff it has a
    time channel) fuse lead_lag / time_augment into the kernel: the
    increments stay raw (B, M, d_raw), the output is over d_aug letters
    and M_out = ceil(M_aug / stream_stride); the time channel stays fp32.
    A CPU tensor runs :func:`sig_trunc_plain` on the same rounded values; a
    CUDA tensor launches the kernel; a meta tensor runs the operator's Meta
    implementation.
    """
    if increments.ndim != 3:
        raise ValueError(f"expected (B, M, d), got {tuple(increments.shape)}")
    B, M, d_raw = increments.shape
    if depth < 1:
        raise ValueError("depth must be >= 1")
    if stream_stride < 1:
        raise ValueError(f"stream_stride must be >= 1, got {stream_stride}")
    ll, time = fuse_flags(transform)
    if time and taux is None:
        raise ValueError("transform with a time channel needs taux= "
                         "(see repro_torch.core.transforms."
                         "transform_time_aux)")
    d = transform_dim(transform, d_raw)
    storage = _storage_dtype(precision)
    if split is not None:
        check_split(d, depth, split)
    count_new_shape("sig_trunc", launch_shapes,
                    (tuple(increments.shape), increments.dtype, depth, split,
                     examples, stream, stream_stride, precision, transform,
                     increments.is_meta),
                    increments, depth=depth, split=split, examples=examples,
                    stream=stream, stride=stream_stride, precision=precision,
                    transform=str(transform) if transform else None)
    if increments.device.type == "cpu":
        x = increments.to(storage).to(torch.float32)
        ta = None if taux is None else taux.to(torch.float32)
        out = sig_trunc_plain(x, depth, stream=stream,
                              stream_stride=stream_stride,
                              transform=transform, taux=ta)
        return out.to(storage if stream else torch.float32).to(
            increments.dtype)
    if increments.device.type not in ("cuda", "meta"):
        raise ValueError(f"sig_trunc runs on cuda, meta or cpu tensors, not "
                         f"{increments.device}")
    if B == 0 or M == 0:  # no steps: zeros, no launch
        M_aug = 2 * M if ll else M
        shape = (B, -(-M_aug // stream_stride), sig_dim(d, depth)) \
            if stream else (B, sig_dim(d, depth))
        return increments.new_zeros(shape)
    out = SigTruncFunction.apply(increments, depth, split, stream,
                                 stream_stride, precision, transform, taux,
                                 examples)
    return out.to(increments.dtype)
