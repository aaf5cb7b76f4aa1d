"""Path transforms the §8 projection workload feeds to the signature
engines.

Port of the materialising part of ``repro.core.transforms``:
:func:`freeze_tail`, :func:`lead_lag` and :func:`sparse_leadlag_generators`.
With ``lengths=`` (B,) a transform freezes each example's padded tail at
its true endpoint (so the transformed tail has zero increments) and returns
``(path, new_lengths)``.  The ``Transform`` spec and the fused kernel cells
are not ported yet (``transform=`` raises, naming the ROADMAP.md item).
"""
from __future__ import annotations

import torch

from .signature import as_lengths


def freeze_tail(path: torch.Tensor, lengths) -> torch.Tensor:
    """(B, M+1, d) padded batch -> the same batch with every point past each
    example's true end replaced by its true endpoint X_{L_b}."""
    B, M1, d = path.shape
    lengths = as_lengths(lengths, B, path.device)
    idx = torch.minimum(
        torch.arange(M1, dtype=torch.int64, device=path.device)[None, :],
        lengths[:, None].to(torch.int64))
    return torch.gather(path, 1, idx[..., None].expand(B, M1, d))


def lead_lag(path: torch.Tensor, lengths=None):
    """Lead-lag transform (paper Def. 8.1): (B, M+1, d) -> (B, 2M+1, 2d).

    Channel order: [lag_1..lag_d, lead_1..lead_d], i.e. hat{X}_{2k} =
    (X_k, X_k), hat{X}_{2k+1} = (X_k, X_{k+1}).  With ``lengths`` the tail
    is frozen first and the return is ``(path, 2·lengths)``.
    """
    if path.ndim == 2:
        if lengths is not None:
            out, nl = lead_lag(path[None], lengths)
            return out[0], nl
        return lead_lag(path[None])[0]
    if lengths is not None:
        lengths = as_lengths(lengths, path.shape[0], path.device)
        path = freeze_tail(path, lengths)
    B, M1, d = path.shape
    M = M1 - 1
    even = torch.cat([path[:, :-1], path[:, :-1]], dim=-1)   # (B, M, 2d)
    odd = torch.cat([path[:, :-1], path[:, 1:]], dim=-1)
    inter = torch.stack([even, odd], dim=2).reshape(B, 2 * M, 2 * d)
    last = torch.cat([path[:, -1:], path[:, -1:]], dim=-1)
    out = torch.cat([inter, last], dim=1)
    if lengths is not None:
        return out, 2 * lengths
    return out


def sparse_leadlag_generators(d: int) -> list[tuple[int, ...]]:
    """Generator set G of paper §8 for independent components.  Channels
    0..d-1 are lag (ell_i), d..2d-1 lead (L_i);
    G = {(L_i)} ∪ {(ell_i, L_i), (L_i, ell_i)}."""
    gens: list[tuple[int, ...]] = [(d + i,) for i in range(d)]
    for i in range(d):
        gens.append((i, d + i))
        gens.append((d + i, i))
    return gens
