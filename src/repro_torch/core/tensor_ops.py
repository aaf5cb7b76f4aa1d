"""Levelwise truncated tensor-algebra operations (paper §2.1-2.2).

Port of ``repro.core.tensor_ops``.  A truncated element of T_{<=N}(R^d) with
scalar part 1 is a ``levels`` list ``[a_1, ..., a_N]`` with ``a_n`` of shape
``(..., d**n)``; the flat form concatenates the levels along the last axis
into ``(..., D_sig)`` (level-major, lexicographic within a level).
"""
from __future__ import annotations

import torch

from .words import sig_dim


def levels_to_flat(levels: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat(levels, dim=-1)


def flat_to_levels(flat: torch.Tensor, d: int,
                   depth: int) -> list[torch.Tensor]:
    out, off = [], 0
    for n in range(1, depth + 1):
        out.append(flat[..., off:off + d**n])
        off += d**n
    if off != flat.shape[-1]:
        raise ValueError(f"flat width {flat.shape[-1]} is not D_sig={off} "
                         f"for d={d}, depth={depth}")
    return out


def zero_levels(batch_shape: tuple[int, ...], d: int, depth: int,
                dtype=torch.float32, device=None) -> list[torch.Tensor]:
    return [torch.zeros((*batch_shape, d**n), dtype=dtype, device=device)
            for n in range(1, depth + 1)]


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Concatenation product of word-basis blocks: (..., d^k) x (..., d^m)
    -> (..., d^(k+m)) with out[..., u∘v] = a[..., u] * b[..., v]
    (Prop. A.3: index = u*d^m + v)."""
    return (a[..., :, None] * b[..., None, :]).reshape(
        *a.shape[:-1], a.shape[-1] * b.shape[-1])


def chen_mul(a: list[torch.Tensor], b: list[torch.Tensor], *, a0: float = 1.0,
             b0: float = 1.0, min_level_a: int = 0,
             min_level_b: int = 0) -> list[torch.Tensor]:
    """Truncated tensor product (A ⊗ B)_n = sum_k A_k ⊗ B_{n-k}.

    ``a0``/``b0`` are the scalar (level-0) parts; ``min_level_*`` declares
    that levels below it are zero (skips work, e.g. powers of A).
    """
    depth = len(a)
    if len(b) != depth:
        raise ValueError(f"depth mismatch: {depth} vs {len(b)}")
    out: list[torch.Tensor] = []
    for n in range(1, depth + 1):
        acc = None
        for k in range(0, n + 1):
            if 0 < k < min_level_a or 0 < n - k < min_level_b:
                continue
            if k == 0:
                term = a0 * b[n - 1] if a0 != 0.0 else None
            elif k == n:
                term = b0 * a[n - 1] if b0 != 0.0 else None
            else:
                term = _outer(a[k - 1], b[n - k - 1])
            if term is not None:
                acc = term if acc is None else acc + term
        out.append(torch.zeros_like(a[n - 1]) if acc is None else acc)
    return out


def tensor_exp(dx: torch.Tensor, depth: int) -> list[torch.Tensor]:
    """exp(dx) levels: dx^{⊗n} / n! for n = 1..depth (Prop. 3.1)."""
    out = [dx]
    for n in range(2, depth + 1):
        out.append(_outer(out[-1], dx) / n)
    return out


def tensor_log(s: list[torch.Tensor]) -> list[torch.Tensor]:
    """log(1 + A) = sum_{k>=1} (-1)^{k+1} A^{⊗k} / k, truncated (paper
    §3.3)."""
    depth = len(s)
    power = list(s)                   # A^1, min level 1
    out = list(s)                     # k = 1 term
    for k in range(2, depth + 1):
        power = chen_mul(power, s, a0=0.0, b0=0.0, min_level_a=k - 1,
                         min_level_b=1)
        coef = ((-1) ** (k + 1)) / k
        out = [o + coef * p for o, p in zip(out, power)]
    return out


def tensor_inverse(s: list[torch.Tensor]) -> list[torch.Tensor]:
    """(1 + A)^{-1} = sum_{k>=0} (-A)^{⊗k}, truncated; for group-like
    elements the signature of the time-reversed path (Lemma 4.5)."""
    depth = len(s)
    neg = [-lvl for lvl in s]
    power = list(neg)
    out = list(neg)
    for k in range(2, depth + 1):
        power = chen_mul(power, neg, a0=0.0, b0=0.0, min_level_a=k - 1,
                         min_level_b=1)
        out = [o + p for o, p in zip(out, power)]
    return out


def path_increments(path: torch.Tensor) -> torch.Tensor:
    """(B, M+1, d) sampled path -> (B, M, d) increments ΔX_j."""
    return path[..., 1:, :] - path[..., :-1, :]


def horner_step(levels: list[torch.Tensor],
                dx: torch.Tensor) -> list[torch.Tensor]:
    """One Chen update S <- S ⊗ exp(dx) in Horner form (paper Alg. 1),
    never materialising exp(dx).  For each target level n:

        acc_1 = dx / n
        acc_j = (S^{(j-1)} + acc_{j-1}) ⊗ dx / (n-j+1),   j = 2..n
        S_new^{(n)} = S^{(n)} + acc_n
    """
    depth = len(levels)
    new = []
    for n in range(1, depth + 1):
        acc = dx / n
        for j in range(2, n + 1):
            acc = _outer(levels[j - 2] + acc, dx) / (n - j + 1)
        new.append(levels[n - 1] + acc)
    return new


def signature_exp_chen(increments: torch.Tensor, depth: int) -> torch.Tensor:
    """Naive oracle: materialise exp(ΔX_j) and Chen-multiply along the path
    (paper eq. (2)).  (B, M, d) -> flat (B, D_sig)."""
    B, M, d = increments.shape
    levels = zero_levels((B,), d, depth, increments.dtype, increments.device)
    for j in range(M):
        levels = chen_mul(levels, tensor_exp(increments[:, j], depth))
    return levels_to_flat(levels)


def signature_cumulative(increments: torch.Tensor,
                         depth: int) -> torch.Tensor:
    """Every prefix signature S_{0,t_j}: (M, B, D_sig), memory O(B·M·D_sig)
    (the baseline scaling of the paper's Table 2)."""
    B, M, d = increments.shape
    levels = zero_levels((B,), d, depth, increments.dtype, increments.device)
    ys = []
    for j in range(M):
        levels = chen_mul(levels, tensor_exp(increments[:, j], depth))
        ys.append(levels_to_flat(levels))
    if not ys:
        return increments.new_zeros((0, B, sig_dim(d, depth)))
    return torch.stack(ys, 0)
