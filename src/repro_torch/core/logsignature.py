"""Log-signatures in the Lyndon (expanded) basis (paper §3.3).

Port of ``repro.core.logsignature``.  Two routes:

- :func:`logsignature`: dense — full truncated signature, truncated tensor
  log, then the Lyndon-word coordinates.  The oracle route.
- :func:`logsignature_projected`: the paper's projection trick — the
  signature is computed over W_{<=N-1} ∪ Lyndon_N only, and the level-N log
  coefficients are assembled from word factorisations:

      log(S)[w] = sum_{k=1..n} (-1)^{k+1}/k  sum_{w = u_1∘…∘u_k, u_i≠eps}
                  prod_i S[u_i]

  Every proper factor of w has length <= N-1 and is therefore available.

On the ``cuda`` engine the projected route calls
:func:`repro_torch.kernels.ops.projected` and so runs the Hopper
``sig_words`` kernel over that word set.  On the ``torch`` engine at depth
>= 2 it runs the hybrid dense + top-word engine
(:mod:`repro_torch.core.hybrid`), as the reference's ``jax`` branch does;
at depth 1 the word-table scan runs over the same plan.
"""
from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np
import torch

from ..device import resolve_device
from . import tensor_ops as tops
from .projection import projected_signature_from_increments
from .signature import signature_from_increments
from .words import (Word, all_words, encode, level_offsets, lyndon_words,
                    make_plan, sig_dim)


@lru_cache(maxsize=None)
def _lyndon_flat_indices(d: int, depth: int) -> np.ndarray:
    offs = level_offsets(d, depth)
    idx = [int(offs[len(w)] + encode(w, d)) for w in lyndon_words(d, depth)]
    return np.asarray(idx, dtype=np.int64)


def _as_path(path, device):
    dev = resolve_device(device)
    path = torch.as_tensor(path, device=dev)
    if path.ndim == 2:
        return path[None], True
    return path, False


def logsignature(path, depth: int, *, basepoint: bool = False,
                 backward: str = "inverse", backend: str = "auto",
                 device=None) -> torch.Tensor:
    """Dense route: log of the full truncated signature at the Lyndon
    words.  (B, M+1, d) -> (B, logsig_dim).  The signature rides the
    engine dispatch; the tensor log is plain PyTorch algebra."""
    path, squeeze = _as_path(path, device)
    if basepoint:
        path = torch.cat([torch.zeros_like(path[:, :1]), path], dim=1)
    d = path.shape[-1]
    flat = signature_from_increments(tops.path_increments(path), depth,
                                     backward=backward, backend=backend,
                                     device=path.device)
    logs = tops.levels_to_flat(tops.tensor_log(
        tops.flat_to_levels(flat, d, depth)))
    out = logs[:, torch.as_tensor(_lyndon_flat_indices(d, depth),
                                  device=path.device)]
    return out[0] if squeeze else out


# ---------------------------------------------------------------------------
# projected route (paper §3.3 trick)
# ---------------------------------------------------------------------------

def _compositions(word: Word, k: int):
    """All ways to split ``word`` into k non-empty contiguous factors."""
    n = len(word)
    for cuts in itertools.combinations(range(1, n), k - 1):
        bounds = (0,) + cuts + (n,)
        yield tuple(word[bounds[i]:bounds[i + 1]] for i in range(k))


@lru_cache(maxsize=None)
def _projected_tables(d: int, depth: int):
    """Plan + factorisation index tables of the projected log-signature.

    Word set: all words to depth-1, then the Lyndon words at depth.  Every
    composition of a depth-N Lyndon word into k >= 2 factors is a row of
    output-coefficient indices (into the plan's output), padded with -1
    (a factor of 1).
    """
    lw = lyndon_words(d, depth)
    top = [w for w in lw if len(w) == depth]
    words = all_words(d, depth - 1) + top if depth > 1 else top
    plan = make_plan(words, d)
    pos = {w: i for i, w in enumerate(plan.words)}

    rows, coefs, tgt = [], [], []
    for wi, w in enumerate(top):
        for k in range(2, depth + 1):
            for parts in _compositions(w, k):
                rows.append([pos[p] for p in parts] + [-1] * (depth - k))
                coefs.append(((-1) ** (k + 1)) / k)
                tgt.append(wi)
    comp_idx = np.asarray(rows, dtype=np.int64) if rows else \
        np.zeros((0, depth), np.int64)
    comp_coef = np.asarray(coefs, dtype=np.float32)
    comp_tgt = np.asarray(tgt, dtype=np.int64)
    top_rows = np.asarray([pos[w] for w in top], dtype=np.int64)
    lown = sig_dim(d, depth - 1) if depth > 1 else 0
    return plan, comp_idx, comp_coef, comp_tgt, top_rows, lown


def logsignature_projected(path, depth: int, *, basepoint: bool = False,
                           backward: str = "inverse", backend: str = "auto",
                           device=None) -> torch.Tensor:
    """Paper route: never materialises the non-Lyndon level-N coefficients.
    (B, M+1, d) -> (B, logsig_dim), equal to :func:`logsignature`.

    On the ``cuda`` engine the word kernel runs over W_{<=N-1} ∪ Lyndon_N
    through :func:`repro_torch.kernels.ops.projected` (its backward is the
    §4.2 ``sig_sweep`` kernel), as does ``backend="hybrid"``.  On
    ``torch`` at depth >= 2 the hybrid engine computes the set
    (:func:`repro_torch.core.hybrid.hybrid_low_plus_top`: the plan's words
    are W_{<=N-1} ++ Lyndon_N in exactly its output order); at depth 1 the
    word-table scan runs over the plan.
    """
    from ..kernels import ops  # deferred: ops imports this package
    path, squeeze = _as_path(path, device)
    if basepoint:
        path = torch.cat([torch.zeros_like(path[:, :1]), path], dim=1)
    d = path.shape[-1]
    plan, comp_idx, comp_coef, comp_tgt, top_rows, lown = \
        _projected_tables(d, depth)
    incs = tops.path_increments(path)
    dev = path.device
    engine = "hybrid" if backend == "hybrid" else ops.resolve_backend(
        backend, dev)
    if engine != "torch":
        coeffs = ops.projected(incs, plan, backend=backend,
                               backward=backward, device=dev)
    elif depth >= 2:
        from .hybrid import hybrid_low_plus_top
        coeffs = hybrid_low_plus_top(incs, plan.words[lown:], depth,
                                     backward=backward)
    else:
        coeffs = projected_signature_from_increments(
            incs, plan, backward=backward, backend="torch", device=dev)

    outs = []
    if depth > 1:
        # levels < N: dense truncated log of the low part, which is ordered
        # level-major exactly as a depth-(N-1) signature
        low = tops.levels_to_flat(tops.tensor_log(
            tops.flat_to_levels(coeffs[:, :lown], d, depth - 1)))
        outs.append(low[:, torch.as_tensor(
            _lyndon_flat_indices(d, depth - 1), device=dev)])
    # level N at Lyndon words: the k = 1 term + composition sums
    top = coeffs[:, torch.as_tensor(top_rows, device=dev)]
    if comp_idx.shape[0]:
        padded = torch.cat([coeffs, coeffs.new_ones((coeffs.shape[0], 1))],
                           dim=1)
        idx = torch.as_tensor(np.where(comp_idx < 0, coeffs.shape[1],
                                       comp_idx), device=dev)
        prods = padded[:, idx].prod(dim=2) * torch.as_tensor(
            comp_coef, device=dev).to(coeffs.dtype)
        top = top.index_add(1, torch.as_tensor(comp_tgt, device=dev), prods)
    outs.append(top)
    out = torch.cat(outs, dim=1)
    return out[0] if squeeze else out


def logsig_dim(d: int, depth: int) -> int:
    return len(lyndon_words(d, depth))
