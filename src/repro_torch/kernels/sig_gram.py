"""Weighted signature Gram tiles: the Hopper kernel's host side.

Port of ``repro.kernels.sig_gram``.  The truncated signature kernel is a
weighted inner product over word coordinates,

    k_ω(x, y) = Σ_w ω_w ⟨S(x), w⟩⟨S(y), w⟩ = (S_x diag(ω) S_yᵀ)_{xy},

so the (B_x, B_y) Gram is one product blocked over the word axis with ω
fused into the left operand; the (B_x, B_y, D) elementwise intermediate of
the textbook formula never exists.

The CUDA kernel (``csrc/sig_gram.cu``) writes the fp32 Gram: one thread
block per output tile of 128 (or 64) × 128 and word slice, words brought
into a ring of shared-memory stages by asynchronous copies, ω multiplied
into S_x's elements as they are read, each element split into two TF32
halves for three tensor-core products (3xTF32) whose partial joins a
rounded fp32 sum every 32 words, edges masked in the kernel, and the
slices' partials summed in order by a second kernel.  This module
chooses the tile (:func:`tile_rows`), the word slices
(:func:`word_slices`) and the copy width (:func:`copy_width`) from the
shape and the pointers.  On a CPU tensor :func:`sig_gram` runs
:func:`sig_gram_plain`, the word-blocked loop of the reference's
``ops._gram_blocked_jax``; on a CUDA tensor it launches the kernel, the
registered operator ``pathsig::sig_gram``
(:mod:`repro_torch.kernels.library`), or raises; on a meta tensor the
operator's Meta implementation runs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..obs.compile import count_new_shape
from . import _build

MAX_ROW_TILES = 65_535   # the grid's y extent, in row tiles of S_x
TILE_N = 128             # GG_BN: rows of S_y per block
KBLOCK = 512             # GG_KBLOCK: slices are whole blocks of words
SMS = 132                # streaming multiprocessors of an H100 SXM
# blocks of each row tile an SM holds at once (registers, shared memory)
BLOCKS_PER_SM = {64: 2, 128: 1}

# launch counter, bumped where the kernel is launched
launches = 0
# every launch shape met so far (the wrapper's counterpart of a jit cache)
launch_shapes: set = set()


def _check_shapes(Sx: torch.Tensor, Sy: torch.Tensor,
                  weights: torch.Tensor) -> None:
    """The reference's shape checks (``sig_gram_tiles``)."""
    if Sx.ndim != 2 or Sy.ndim != 2 or Sy.shape[1] != Sx.shape[1] \
            or tuple(weights.shape) != (Sx.shape[1],):
        raise ValueError(f"shape mismatch: Sx {tuple(Sx.shape)}, Sy "
                         f"{tuple(Sy.shape)}, weights {tuple(weights.shape)}")


def _tiles(Bx: int, By: int, rows: int) -> int:
    return -(-Bx // rows) * -(-By // TILE_N)


def tile_rows(Bx: int, By: int, sms: int = SMS) -> int:
    """Rows of S_x per block: 128, or 64 when B_x fits one 64-row tile or
    128-row tiles are too few to fill the card (a 64-row tile wastes no
    half-empty rows at a 64-row cross-Gram, and gives twice the blocks)."""
    return 64 if Bx <= 64 or _tiles(Bx, By, 128) < sms else 128


def word_slices(Bx: int, By: int, D: int,
                sms: int = SMS) -> list[tuple[int, int]]:
    """Cut the word axis [0, D) into the split-K slices of one Gram.

    Every slice but the last covers a whole number of ``KBLOCK``-word
    blocks, so each slice's partial is a sum of whole two-level blocks.
    One slice when the output tiles alone fill the card; otherwise the
    fewest slices that give at least one full wave of blocks (``sms``
    times the blocks an SM holds), or one block a slice when even that
    falls short.
    """
    rows = tile_rows(Bx, By, sms)
    tiles = _tiles(Bx, By, rows)
    nblk = max(1, -(-D // KBLOCK))
    per = nblk
    if tiles < sms:
        per, wave = 1, sms * BLOCKS_PER_SM[rows]
        for b in range(nblk, 0, -1):   # the widest slices that fill a wave
            if tiles * -(-nblk // b) >= wave:
                per = b
                break
    step = per * KBLOCK
    return [(k, min(D, k + step)) for k in range(0, D, step)]


def copy_width(D: int, *ptrs: int) -> int:
    """Floats per asynchronous copy: 4 (16 bytes) when D and every pointer
    allow it, else 2, else 1.  Rows of D = 9,330 words are 8-byte aligned
    only, and a view at an odd storage offset 4-byte aligned only."""
    for vec in (4, 2):
        if D % vec == 0 and all(p % (4 * vec) == 0 for p in ptrs):
            return vec
    return 1


def _lib() -> ctypes.CDLL:
    lib = _build.library("sig_gram")
    fn = lib.sig_gram_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 5 + [i] * 6 + [p]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _plan(Bx: int, By: int, D: int, sms: int) -> tuple[int, int]:
    """(tile rows, words a slice) of one Gram shape."""
    lo, hi = word_slices(Bx, By, D, sms)[0]
    return tile_rows(Bx, By, sms), -(-(hi - lo) // KBLOCK) * KBLOCK


def _launch(Sx: torch.Tensor, Sy: torch.Tensor, weights: torch.Tensor,
            rows: int | None = None, slice_words: int | None = None,
            vec: int | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA (or meta) operands with B_x, B_y, D >= 1,
    through ``pathsig::sig_gram``.  ``rows`` (64 or 128), ``slice_words``
    (a multiple of ``KBLOCK``) and ``vec`` (floats per copy, at most
    :func:`copy_width`) override the planner's choices, for tests and
    measurements."""
    x = Sx.detach().to(torch.float32).contiguous()
    y = Sy.detach().to(torch.float32).contiguous()
    w = weights.detach().to(device=x.device, dtype=torch.float32).contiguous()
    return torch.ops.pathsig.sig_gram(x, y, w, rows or 0, slice_words or 0,
                                      vec or 0)


def _output(x: torch.Tensor, y: torch.Tensor, *args) -> torch.Tensor:
    """The fp32 (B_x, B_y) Gram ``pathsig::sig_gram`` writes, on ``x``'s
    device (its Meta implementation)."""
    return torch.empty((x.shape[0], y.shape[0]), dtype=torch.float32,
                       device=x.device)


def _kernel(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, rows: int,
            slice_words: int, vec: int) -> torch.Tensor:
    """``pathsig::sig_gram`` on the card: the kernel over contiguous fp32
    operands; ``rows``, ``slice_words`` and ``vec`` 0 are the planner's."""
    global launches
    Bx, D = x.shape
    By = y.shape[0]
    plan_rows, plan_words = _plan(Bx, By, D, _sms(x.device))
    rows = rows or plan_rows
    slice_words = slice_words or plan_words
    if -(-Bx // rows) > MAX_ROW_TILES:
        raise ValueError(f"B_x = {Bx} exceeds the kernel's "
                         f"{MAX_ROW_TILES * rows} rows; split the batch")
    out = _output(x, y)
    vec = vec or copy_width(D, x.data_ptr(), y.data_ptr())
    n_slices = -(-D // slice_words)
    ws = (torch.empty((n_slices, Bx, By), dtype=torch.float32,
                      device=x.device) if n_slices > 1 else None)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.sig_gram_launch(
            x.data_ptr(), y.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), Bx, By, D, rows,
            slice_words, vec, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"sig_gram kernel launch failed with cudaError "
                           f"{err} (B_x={Bx}, B_y={By}, D={D})")
    launches += 1
    return out


def sig_gram_plain(Sx: torch.Tensor, Sy: torch.Tensor, weights: torch.Tensor,
                   block_words: int = 512) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``(sx * wb) @ sy.T`` summed over
    ``block_words``-wide slabs of the word axis, in the operands' dtype
    promoted to at least float32 (the reference's ``_gram_blocked_jax``)."""
    Bx, D = Sx.shape
    dt = torch.promote_types(Sx.dtype, torch.float32)
    blk = max(1, min(block_words, D))
    x, y, w = Sx.to(dt), Sy.to(dt), weights.to(device=Sx.device, dtype=dt)
    G = x.new_zeros((Bx, Sy.shape[0]))
    for k in range(0, D, blk):
        G = G + (x[:, k:k + blk] * w[k:k + blk]) @ y[:, k:k + blk].T
    return G


def sig_gram(Sx: torch.Tensor, Sy: torch.Tensor, weights: torch.Tensor,
             *, rows: int | None = None,
             slice_words: int | None = None) -> torch.Tensor:
    """Weighted Gram G[i, j] = Σ_k Sx[i, k] · weights[k] · Sy[j, k].

    Sx (B_x, D), Sy (B_y, D), weights (D,) -> (B_x, B_y) float32, with the
    operands cast to float32 as the reference kernel casts them.  A CPU
    tensor runs :func:`sig_gram_plain`; a CUDA tensor launches the kernel;
    a meta tensor runs the operator's Meta implementation.
    ``rows`` (64 or 128 rows of S_x a tile) and ``slice_words`` (a
    multiple of ``KBLOCK``) override the planner's partition (the
    autotuner's ``gram`` record).
    """
    _check_shapes(Sx, Sy, weights)
    if Sx.device != Sy.device:
        raise ValueError(f"Sx on {Sx.device}, Sy on {Sy.device}")
    if rows not in (None, 64, 128):
        raise ValueError(f"rows must be 64 or 128, got {rows}")
    if slice_words is not None and (slice_words < KBLOCK
                                    or slice_words % KBLOCK):
        raise ValueError(f"slice_words must be a positive multiple of "
                         f"{KBLOCK}, got {slice_words}")
    count_new_shape("sig_gram_tiles", launch_shapes,
                    (tuple(Sx.shape), tuple(Sy.shape), Sx.dtype, rows,
                     slice_words, Sx.is_meta),
                    Sx, Sy, rows=rows, slice_words=slice_words)
    if Sx.device.type == "cpu":
        return sig_gram_plain(Sx.float(), Sy.float(), weights.float())
    if Sx.device.type not in ("cuda", "meta"):
        raise ValueError(f"sig_gram runs on cuda, meta or cpu tensors, not "
                         f"{Sx.device}")
    if 0 in (Sx.shape[0], Sy.shape[0], Sx.shape[1]):  # empty: no launch
        return torch.zeros((Sx.shape[0], Sy.shape[0]), dtype=torch.float32,
                           device=Sx.device)
    return _launch(Sx, Sy, weights, rows, slice_words)
