"""Weighted signature Gram tiles: the Hopper kernel's host side.

Port of ``repro.kernels.sig_gram``.  The truncated signature kernel is a
weighted inner product over word coordinates,

    k_ω(x, y) = Σ_w ω_w ⟨S(x), w⟩⟨S(y), w⟩ = (S_x diag(ω) S_yᵀ)_{xy},

so the (B_x, B_y) Gram is one product blocked over the word axis with ω
fused into the left operand; the (B_x, B_y, D) elementwise intermediate of
the textbook formula never exists.

The CUDA kernel (``csrc/sig_gram.cu``: one thread block per 64 × 64 output
tile, slabs of words staged in shared memory, ω multiplied in as S_x is
loaded, FP32 FMAs summed in 512-word blocks, edges masked in the kernel)
writes the fp32 Gram.  On a CPU tensor :func:`sig_gram` runs
:func:`sig_gram_plain`, the word-blocked loop of the reference's
``ops._gram_blocked_jax``; on a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_ROW_TILES = 65_535   # the grid's y extent, in 64-row tiles of S_x
TILE = 64                # GG_BM = GG_BN of the kernel

# launch counter, bumped where the kernel is launched
launches = 0


def _check_shapes(Sx: torch.Tensor, Sy: torch.Tensor,
                  weights: torch.Tensor) -> None:
    """The reference's shape checks (``sig_gram_tiles``)."""
    if Sx.ndim != 2 or Sy.ndim != 2 or Sy.shape[1] != Sx.shape[1] \
            or tuple(weights.shape) != (Sx.shape[1],):
        raise ValueError(f"shape mismatch: Sx {tuple(Sx.shape)}, Sy "
                         f"{tuple(Sy.shape)}, weights {tuple(weights.shape)}")


def _lib() -> ctypes.CDLL:
    lib = _build.library("sig_gram")
    fn = lib.sig_gram_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 4 + [i] * 3 + [p]
        fn.restype = ctypes.c_int
    return lib


def _launch(Sx: torch.Tensor, Sy: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA operands with B_x, B_y, D >= 1."""
    global launches
    Bx, D = Sx.shape
    By = Sy.shape[0]
    if -(-Bx // TILE) > MAX_ROW_TILES:
        raise ValueError(f"B_x = {Bx} exceeds the kernel's "
                         f"{MAX_ROW_TILES * TILE} rows; split the batch")
    x = Sx.detach().to(torch.float32).contiguous()
    y = Sy.detach().to(torch.float32).contiguous()
    w = weights.detach().to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty((Bx, By), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.sig_gram_launch(
            x.data_ptr(), y.data_ptr(), w.data_ptr(), out.data_ptr(), Bx, By,
            D, torch.cuda.current_stream(x.device).cuda_stream)
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


def sig_gram(Sx: torch.Tensor, Sy: torch.Tensor,
             weights: torch.Tensor) -> torch.Tensor:
    """Weighted Gram G[i, j] = Σ_k Sx[i, k] · weights[k] · Sy[j, k].

    Sx (B_x, D), Sy (B_y, D), weights (D,) -> (B_x, B_y) float32, with the
    operands cast to float32 as the reference kernel casts them.  A CPU
    tensor runs :func:`sig_gram_plain`; a CUDA tensor launches the kernel.
    """
    _check_shapes(Sx, Sy, weights)
    if Sx.device != Sy.device:
        raise ValueError(f"Sx on {Sx.device}, Sy on {Sy.device}")
    if Sx.device.type == "cpu":
        return sig_gram_plain(Sx.float(), Sy.float(), weights.float())
    if Sx.device.type != "cuda":
        raise ValueError(f"sig_gram runs on cuda or cpu tensors, not "
                         f"{Sx.device}")
    if 0 in (Sx.shape[0], Sy.shape[0], Sx.shape[1]):  # empty: no launch
        return torch.zeros((Sx.shape[0], Sy.shape[0]), dtype=torch.float32,
                           device=Sx.device)
    return _launch(Sx, Sy, weights)
