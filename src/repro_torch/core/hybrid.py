"""Hybrid dense + word-table signature engine.

Port of ``repro.core.hybrid``.  Computes every coefficient of W_{<=N-1}
with the dense levelwise-Horner step (:func:`tensor_ops.horner_step`: outer
products, no gathers) and only a prescribed set of level-N words through
per-word Horner chains whose prefixes are read out of the dense buffer.
That is the shape of the paper's §3.3 projected log-signature (all low
levels plus Lyndon_N), where the word-table engine gathers on every
closure row although most of the closure is simply "all words below N".

The memory law is the paper's §4.2: ``backward="inverse"`` saves only the
increments and the output, and its backward rebuilds each earlier state
by the group inverse, S_{j-1} = S_j ⊗ exp(-ΔX_j) (Prop. 4.6), and the top
words by T_{j-1} = T_j − h(S_{j-1}, ΔX_j).

This is plain PyTorch on any device: the reference's hybrid is jnp code
outside any Pallas kernel.  On the card it is launch-bound (a few small
launches a step, and a Python loop over the steps).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.cache import plan_cache
from . import tensor_ops as tops
from .words import Word, encode, level_offsets, sig_dim


@plan_cache
def _top_tables(d: int, depth: int,
                top_words: tuple[Word, ...]) -> tuple[np.ndarray, np.ndarray]:
    """letters (K, depth) and the dense flat index of each prefix
    w_{1:j}, j = 1..depth-1, (K, depth-1)."""
    K = len(top_words)
    offs = level_offsets(d, depth)
    letters = np.zeros((K, depth), np.int64)
    pidx = np.zeros((K, max(depth - 1, 1)), np.int64)
    for r, w in enumerate(top_words):
        if len(w) != depth:
            raise ValueError(f"top word {w} is not of length {depth}")
        letters[r] = w
        for j in range(1, depth):
            pidx[r, j - 1] = offs[j] + encode(w[:j], d)
    return letters, pidx


@plan_cache
def _tables_on(d: int, depth: int, top_words: tuple[Word, ...],
               device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_top_tables` as index tensors on ``device``."""
    letters, pidx = _top_tables(d, depth, top_words)
    return (torch.from_numpy(letters).to(device),
            torch.from_numpy(pidx).to(device))


def _top_increment(flat_prev: torch.Tensor, dx: torch.Tensor,
                   letters: torch.Tensor, pidx: torch.Tensor,
                   depth: int) -> torch.Tensor:
    """Horner chain h of each top word (paper Alg. 1), its prefixes read
    from the dense flat buffer of the previous step.  flat_prev
    (B, D_{N-1}), dx (B, d) -> (B, K)."""
    acc = dx[:, letters[:, 0]] / float(depth)
    for j in range(2, depth + 1):
        pfx = flat_prev[:, pidx[:, j - 2]]
        acc = (pfx + acc) * dx[:, letters[:, j - 1]] / float(depth - j + 1)
    return acc


def _step(levels: list[torch.Tensor], top: torch.Tensor, dx: torch.Tensor,
          letters: torch.Tensor, pidx: torch.Tensor, depth: int):
    top = top + _top_increment(tops.levels_to_flat(levels), dx, letters,
                               pidx, depth)
    return tops.horner_step(levels, dx), top


def _scan(increments: torch.Tensor, top_words: tuple, depth: int,
          tables) -> torch.Tensor:
    """The forward scan: (B, M, d) -> (B, D_{N-1} + K)."""
    B, M, d = increments.shape
    levels = tops.zero_levels((B,), d, depth - 1, increments.dtype,
                              increments.device)
    top = increments.new_zeros((B, len(top_words)))
    for j in range(M):
        levels, top = _step(levels, top, increments[:, j], *tables, depth)
    return torch.cat([tops.levels_to_flat(levels), top], dim=1)


class HybridInverseFunction(torch.autograd.Function):
    """The ``inverse`` cell: saves the increments and the output only; the
    backward walks the steps in reverse, rebuilding (S_{j-1}, T_{j-1})
    from (S_j, T_j) and pulling the cotangent through one :func:`_step`
    (the reference's custom VJP)."""

    @staticmethod
    def forward(ctx, increments, top_words, depth):
        tables = _tables_on(increments.shape[-1], depth, top_words,
                            increments.device)
        out = _scan(increments, top_words, depth, tables)
        ctx.save_for_backward(increments, out)
        ctx.top_words, ctx.depth = top_words, depth
        return out

    @staticmethod
    def backward(ctx, g):
        increments, out = ctx.saved_tensors
        depth = ctx.depth
        d = increments.shape[-1]
        letters, pidx = _tables_on(d, depth, ctx.top_words,
                                   increments.device)
        lown = sig_dim(d, depth - 1)
        S = tops.flat_to_levels(out[:, :lown], d, depth - 1)
        T = out[:, lown:]
        G = tops.flat_to_levels(g[:, :lown], d, depth - 1)
        Gt = g[:, lown:]
        g_x = torch.zeros_like(increments)
        for j in range(increments.shape[1] - 1, -1, -1):
            dx = increments[:, j]
            S_prev = tops.horner_step(S, -dx)                  # Prop. 4.6
            T_prev = T - _top_increment(tops.levels_to_flat(S_prev), dx,
                                        letters, pidx, depth)
            with torch.enable_grad():
                args = [t.detach().requires_grad_() for t in
                        (*S_prev, T_prev, dx)]
                lv, tp = _step(args[:-2], args[-2], args[-1], letters, pidx,
                               depth)
                grads = torch.autograd.grad((*lv, tp), args, (*G, Gt),
                                            allow_unused=True)
            grads = [torch.zeros_like(a) if gr is None else gr
                     for a, gr in zip(args, grads)]
            G, Gt, g_x[:, j] = grads[:-2], grads[-2], grads[-1]
            S, T = S_prev, T_prev
        return g_x, None, None


def hybrid_low_plus_top(increments: torch.Tensor, top_words, depth: int,
                        *, backward: str = "inverse") -> torch.Tensor:
    """(B, M, d) -> (B, D_{N-1} + K): the full W_{<=N-1} coefficient block
    (level-major flat order) followed by the level-N ``top_words``.

    ``backward="inverse"`` is the O(B·D) reconstruction backward;
    ``"autodiff"`` runs autograd through the scan (O(M·B·D), the
    baseline)."""
    if depth < 2:
        raise ValueError("hybrid engine needs depth >= 2 (no dense part "
                         "below depth 1)")
    top_words = tuple(tuple(int(c) for c in w) for w in top_words)
    if backward == "autodiff":
        tables = _tables_on(increments.shape[-1], depth, top_words,
                            increments.device)
        return _scan(increments, top_words, depth, tables)
    return HybridInverseFunction.apply(increments, top_words, depth)
