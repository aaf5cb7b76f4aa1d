"""Projected signatures over word-set tiles: the Hopper kernel's host side.

Port of ``repro.kernels.sig_words``.  A word set I is cut host-side into
prefix-closed tiles (:func:`repro_torch.core.words.make_tiled_plan`); each
tile is updated independently, the tile-level form of the paper's
thread-per-word CUDA assignment with its redundant shared-ancestor rows.
Per tile the state is (1 + W_pad) rows: row 0 is S[eps] = 1, rows 1..W the
tile's closure words, the rest padding that stays 0.  Per time step, every
row r of length n runs the Horner chain

    acc = 0;  acc = (S_old[prefix_j(r)] + acc) · dx[letter_j(r)] / (n - j),
    j = 0..n-1  (prefix_0 = eps);   S[r] += acc

gathering its prefix row and letter directly by ``prefix_idx``/``letters``
(the TPU kernel's one-hot ``P_j @ S`` products were a workaround for
sublane gathers and are not carried over).

The CUDA kernel (``csrc/sig_words.cu``, one thread block per example and
tile, the state and the tile's tables in shared memory) writes (B, T,
1 + W_pad) fp32 states, or (B, M_out, T, 1 + W_pad) emissions in the
storage dtype; one precomputed flat index (:func:`gather_index`, equal to
the reference's ``tile_idx``/``row_idx`` pair) reads the requested words
out.  On a CPU tensor :func:`sig_words` runs :func:`sig_words_plain`, the
same padded tiles as a word-table scan in PyTorch; on a CUDA tensor it
launches the kernel or raises.  The kernel is forward-only:
:class:`SigWordsFunction` raises on backward.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..core.signature import CHECKPOINT_ITEM, stream_emit_steps
from ..core.words import TiledPlan
from . import _build
from .cache import plan_cache
from .sig_trunc import _storage_dtype

# per-block dynamic shared memory the kernel may take on an H100 (the
# opt-in maximum, 232,448 bytes, less a margin)
SMEM_BUDGET = 232_448 - 1024
CHUNK = 32            # increments staged per shared-memory load (SW_CHUNK)
MAX_DEPTH = 16        # SW_MAX_DEPTH: longest word the kernel takes
ROWS_PER_THREAD = 4   # SW_ROWS_PER_THREAD: chain values a thread holds
MAX_THREADS = 1024
MAX_TILES = 65_535    # the grid's y extent

# launch counters: one per kernel cell, bumped where the kernel is launched
launches = 0
stream_launches = 0


@dataclasses.dataclass(frozen=True, eq=False)
class TileTables:
    """The padded per-tile tables of a :class:`TiledPlan`, laid out
    (T, depth, W_pad) so that neighbouring rows are neighbouring words.
    Rows past a tile's closure and steps j >= len(r) hold 0."""
    w_pad: int                # rows of the largest tile's closure
    depth: int                # longest word of any tile
    prefix_idx: np.ndarray    # (T, depth, W_pad) int32 state rows, 0 = eps
    letters: np.ndarray       # (T, depth, W_pad) int32
    inv: np.ndarray           # (T, depth, W_pad) float32, 1/(len - j)
    lengths: np.ndarray       # (T, W_pad) int32, 0 on padding rows
    gather: np.ndarray        # (|I|,) int64 into the flat (T, 1 + W_pad)

    @property
    def n_tiles(self) -> int:
        return self.lengths.shape[0]


def gather_index(tplan: TiledPlan, w_pad: int) -> np.ndarray:
    """Flat position in (T, 1 + W_pad) of each requested word: the
    reference's ``tile_idx · (1 + W_pad) + row_idx``."""
    tiles = tplan.tiles
    return np.asarray([t * (1 + w_pad) + int(tiles[t].out_rows[k])
                       for t, k in tplan.gather], dtype=np.int64)


@plan_cache
def tile_tables(tplan: TiledPlan) -> TileTables:
    tiles = tplan.tiles
    T = len(tiles)
    w_pad = max(p.closure_size for p in tiles)
    depth = max(p.depth for p in tiles)
    pidx = np.zeros((T, depth, w_pad), np.int32)
    letters = np.zeros((T, depth, w_pad), np.int32)
    inv = np.zeros((T, depth, w_pad), np.float32)
    lengths = np.zeros((T, w_pad), np.int32)
    for t, p in enumerate(tiles):
        W = p.closure_size
        pidx[t, :p.depth, :W] = p.prefix_idx.T
        letters[t, :p.depth, :W] = p.letters.T
        inv[t, :p.depth, :W] = p.inv.T
        lengths[t, :W] = p.lengths
    return TileTables(w_pad=w_pad, depth=depth, prefix_idx=pidx,
                      letters=letters, inv=inv, lengths=lengths,
                      gather=gather_index(tplan, w_pad))


@plan_cache
def _tables_on(tplan: TiledPlan, device: torch.device) -> dict:
    tt = tile_tables(tplan)
    return {k: torch.as_tensor(getattr(tt, k), device=device)
            for k in ("prefix_idx", "letters", "inv", "lengths", "gather")}


def launch_geometry(tt: TileTables, d: int) -> tuple[int, int]:
    """(threads, shared-memory bytes) of one launch; raises on a plan the
    kernel does not take."""
    if tt.depth > MAX_DEPTH:
        raise ValueError(f"words of length {tt.depth} exceed the kernel's "
                         f"MAX_DEPTH {MAX_DEPTH}")
    if tt.n_tiles > MAX_TILES:
        raise ValueError(f"{tt.n_tiles} tiles exceed the grid's {MAX_TILES};"
                         " tile with a larger max_rows")
    threads = min(MAX_THREADS, max(32, -(-tt.w_pad // 32) * 32))
    if tt.w_pad > threads * ROWS_PER_THREAD:
        raise ValueError(f"a tile of {tt.w_pad} rows exceeds the kernel's "
                         f"{threads * ROWS_PER_THREAD}; tile with a smaller "
                         "max_rows")
    # state, then inv, staged increments, prefix_idx, letters, lengths
    smem = 4 * ((1 + tt.w_pad) + 3 * tt.depth * tt.w_pad + tt.w_pad
                + CHUNK * d)
    if smem > SMEM_BUDGET:
        raise ValueError(f"a tile needs {smem} bytes of shared memory, above "
                         f"the {SMEM_BUDGET} a block may take; tile with a "
                         "smaller max_rows")
    return threads, smem


def _lib() -> ctypes.CDLL:
    lib = _build.library("sig_words")
    fn = lib.sig_words_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i] * 11 + [p]
        fn.restype = ctypes.c_int
    return lib


def _launch(incs: torch.Tensor, tplan: TiledPlan, stream: bool, stride: int,
            precision: str) -> torch.Tensor:
    """Launch the kernel on CUDA increments (B, M, d), B, M >= 1.  Returns
    fp32 (B, |I|), or (B, M_out, |I|) in the storage dtype."""
    global launches, stream_launches
    B, M, d = incs.shape
    tt = tile_tables(tplan)
    threads, smem = launch_geometry(tt, d)
    tabs = _tables_on(tplan, incs.device)
    storage = _storage_dtype(precision)
    x = incs.detach().to(storage).contiguous()
    T, W1 = tt.n_tiles, 1 + tt.w_pad
    if stream:
        out = torch.empty((B, -(-M // stride), T, W1), dtype=storage,
                          device=x.device)
    else:
        out = torch.empty((B, T, W1), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.sig_words_launch(
            x.data_ptr(), tabs["prefix_idx"].data_ptr(),
            tabs["letters"].data_ptr(), tabs["inv"].data_ptr(),
            tabs["lengths"].data_ptr(), out.data_ptr(), B, M, d, T,
            tt.w_pad, tt.depth, stride if stream else 0,
            int(storage == torch.bfloat16),
            int(stream and storage == torch.bfloat16), threads, smem,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"sig_words kernel launch failed with cudaError "
                           f"{err} (B={B}, M={M}, d={d}, tiles={T}, "
                           f"W_pad={tt.w_pad}, depth={tt.depth}, "
                           f"threads={threads}, smem={smem})")
    if stream:
        stream_launches += 1
    else:
        launches += 1
    return out.flatten(-2)[..., tabs["gather"]]


class SigWordsFunction(torch.autograd.Function):
    """The CUDA cell as an autograd node.  Forward-only in this slice: the
    backward raises rather than letting gradients vanish silently."""

    @staticmethod
    def forward(ctx, increments, tplan, stream, stride, precision):
        return _launch(increments, tplan, stream, stride, precision)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the CUDA sig_words kernel is forward-only: the §4.2 inverse "
            f"backward lands with ROADMAP.md {CHECKPOINT_ITEM}; use "
            "backend='torch' or backward='autodiff' to differentiate")


def sig_words_plain(increments: torch.Tensor, tplan: TiledPlan, *,
                    stream: bool = False,
                    stream_stride: int = 1) -> torch.Tensor:
    """The kernel's plain PyTorch version on the same padded tiles: the
    per-tile word-table scan, a Python loop over time, in the increments'
    dtype, then the same gather.  (B, M, d) -> (B, |I|), or
    (B, M_out, |I|) when streamed."""
    B, M, _ = increments.shape
    tt = tile_tables(tplan)
    tabs = _tables_on(tplan, increments.device)
    dtype = increments.dtype
    T, W, depth = tt.n_tiles, tt.w_pad, tt.depth
    pidx = tabs["prefix_idx"].long()
    letters = tabs["letters"].long()
    n = tabs["lengths"].to(dtype)[:, None, :]                 # (T, 1, W)
    j = torch.arange(depth, dtype=dtype, device=increments.device)
    j = j[None, :, None]
    inv = torch.where(j < n, 1.0 / (n - j).clamp_min(1.0), 0.0)
    emit = (j == n - 1).to(dtype)
    gather = tabs["gather"]
    S = torch.zeros((B, T, 1 + W), dtype=dtype, device=increments.device)
    S[..., 0] = 1.0
    emitted = set(stream_emit_steps(M, stream_stride).tolist()) if stream \
        else ()
    ys = []
    for step in range(M):
        dx = increments[:, step]
        acc = S.new_zeros((B, T, W))
        h = acc
        for jj in range(depth):
            pfx = torch.gather(S, 2, pidx[:, jj][None].expand(B, T, W))
            acc = (pfx + acc) * dx[:, letters[:, jj]] * inv[:, jj]
            h = h + acc * emit[:, jj]
        S = torch.cat([S[..., :1], S[..., 1:] + h], dim=-1)
        if step in emitted:
            ys.append(S.flatten(-2)[:, gather])
    if not stream:
        return S.flatten(-2)[:, gather]
    if not ys:
        return increments.new_zeros((B, 0, len(gather)))
    return torch.stack(ys, 1)


def sig_words(increments: torch.Tensor, tplan: TiledPlan, *,
              stream: bool = False, stream_stride: int = 1,
              precision: str = "fp32") -> torch.Tensor:
    """Projected signature through the tile kernel.  (B, M, d) -> (B, |I|)
    in ``tplan.words`` order, or with ``stream=True`` (B, M_out, |I|),
    M_out = ceil(M / stream_stride), in the input dtype.

    Increments are stored in the precision's dtype (bf16 under
    ``"bf16_fp32"``) and accumulated in fp32; float64 inputs run in fp32
    and are cast back.  A CPU tensor runs :func:`sig_words_plain` on the
    same rounded values; a CUDA tensor launches the kernel.
    """
    if increments.ndim != 3:
        raise ValueError(f"expected (B, M, d), got {tuple(increments.shape)}")
    B, M, d = increments.shape
    if d != tplan.d:
        raise ValueError(f"increments have d={d} channels, the plan is over "
                         f"{tplan.d} letters")
    if stream_stride < 1:
        raise ValueError(f"stream_stride must be >= 1, got {stream_stride}")
    storage = _storage_dtype(precision)
    if increments.device.type == "cpu":
        x = increments.to(storage).to(torch.float32)
        out = sig_words_plain(x, tplan, stream=stream,
                              stream_stride=stream_stride)
        return out.to(storage if stream else torch.float32).to(
            increments.dtype)
    if increments.device.type != "cuda":
        raise ValueError(f"sig_words runs on cuda or cpu tensors, not "
                         f"{increments.device}")
    if B == 0 or M == 0:  # no steps: zeros, no launch
        n = len(tplan.words)
        shape = (B, -(-M // stream_stride), n) if stream else (B, n)
        return increments.new_zeros(shape)
    out = SigWordsFunction.apply(increments, tplan, stream, stream_stride,
                                 precision)
    return out.to(increments.dtype)
