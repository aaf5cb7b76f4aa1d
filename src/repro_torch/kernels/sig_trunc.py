"""Truncated signature by prefix cones: the Hopper kernel's host side.

Port of ``repro.kernels.sig_trunc``.  The word basis W_{<=N} is cut into
d^s prefix cones: cone ``c`` owns the level-``s`` prefix word
``u = digits_d(c)``, every descendant ``u∘v`` up to depth N, and a redundant
copy of u's ancestor path.  Per-cone state block, ``rows`` floats:

  [ path: levels 1..s-1 along u ] ++ [ cone levels s..N: d^0, ..., d^{N-s} ]

The CUDA kernel (``csrc/sig_trunc.cu``, one thread block per example and
cone, the state in shared memory) writes these blocks; :func:`_reassemble`
gathers them into the flat level-major layout.  ``stream=True`` emits every
``stream_stride``-th prefix signature and the terminal one.

On a CPU tensor :func:`sig_trunc` runs :func:`sig_trunc_plain`, the
levelwise Horner scan; on a CUDA tensor it launches the kernel or raises.
The kernel is forward-only: :class:`SigTruncFunction` raises on backward.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.signature import (_scan_forward, _subsample_stream,
                              canon_precision, CHECKPOINT_ITEM)
from ..core.words import sig_dim
from . import _build
from .cache import plan_cache

# per-block dynamic shared memory the kernel may take on an H100: the opt-in
# maximum (232,448 bytes) less a margin for the kernel's static tables
SMEM_BUDGET = 232_448 - 1024
CHUNK = 32          # increments staged per shared-memory load (SIG_CHUNK)
MAX_DEPTH = 16      # SIG_MAX_DEPTH
MAX_THREADS = 1024
MAX_CELLS = 65_535  # the grid's y extent

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
        fn.argtypes = [p, p, i, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def launch_geometry(d: int, depth: int, s: int) -> tuple[int, int, int]:
    """(cells, threads, shared-memory bytes) of one launch at split s."""
    if not 0 <= s < depth:
        raise ValueError(f"split {s} outside [0, {depth})")
    if depth > MAX_DEPTH:
        raise ValueError(f"depth {depth} above the kernel's {MAX_DEPTH}")
    smem = state_footprint(d, depth, s)
    if smem > SMEM_BUDGET:
        raise ValueError(f"split {s} needs {smem} bytes of shared memory, "
                         f"above the {SMEM_BUDGET} a block may take")
    if d**s > MAX_CELLS:
        raise ValueError(f"split {s} gives {d**s} cones, above {MAX_CELLS}")
    widest = d ** (depth - s)
    threads = min(MAX_THREADS, max(32, -(-widest // 32) * 32))
    return d**s, threads, smem


def _launch(incs: torch.Tensor, depth: int, split: int | None, stream: bool,
            stride: int, precision: str) -> torch.Tensor:
    """Launch the kernel on CUDA increments (B, M, d), B, M >= 1.  Returns
    fp32 (B, D_sig), or (B, M_out, D_sig) in the storage dtype."""
    global launches, stream_launches
    B, M, d = incs.shape
    s = choose_split(d, depth) if split is None else split
    n_cells, threads, smem = launch_geometry(d, depth, s)
    rows = max(0, s - 1) + cone_rows(d, depth, s)
    storage = _storage_dtype(precision)
    x = incs.detach().to(storage).contiguous()
    if stream:
        out = torch.empty((B, -(-M // stride), n_cells, rows), dtype=storage,
                          device=x.device)
    else:
        out = torch.empty((B, n_cells, rows), dtype=torch.float32,
                          device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.sig_trunc_launch(
            x.data_ptr(), out.data_ptr(), B, M, d, depth, s,
            stride if stream else 0, int(storage == torch.bfloat16),
            int(stream and storage == torch.bfloat16), threads, smem,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"sig_trunc kernel launch failed with cudaError "
                           f"{err} (B={B}, M={M}, d={d}, depth={depth}, "
                           f"split={s}, threads={threads}, smem={smem})")
    if stream:
        stream_launches += 1
    else:
        launches += 1
    return _reassemble(out, d, depth, s)


class SigTruncFunction(torch.autograd.Function):
    """The CUDA cell as an autograd node.  Forward-only in this slice: the
    backward raises rather than letting gradients vanish silently."""

    @staticmethod
    def forward(ctx, increments, depth, split, stream, stride, precision):
        return _launch(increments, depth, split, stream, stride, precision)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the CUDA sig_trunc kernel is forward-only: the §4.2 inverse "
            f"backward lands with ROADMAP.md {CHECKPOINT_ITEM}; use "
            "backend='torch' or backward='autodiff' to differentiate")


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
    are cast back.  ``split`` forces the cone level (default: the smallest
    that fits shared memory).  A CPU tensor runs :func:`sig_trunc_plain` on
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
        launch_geometry(d, depth, split)
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
