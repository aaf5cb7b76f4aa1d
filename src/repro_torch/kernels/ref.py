"""Oracles for the kernels (port of ``repro.kernels.ref``).

The naive levelwise Chen engine with materialised tensor exponentials
(paper eq. (2)) and the untiled word-table scan; every kernel test holds
the kernel against them.
"""
from __future__ import annotations

import torch

from ..core import tensor_ops as tops
from ..core.projection import _scan_projected
from ..core.words import WordPlan, make_plan


def sig_trunc_ref(increments: torch.Tensor, depth: int) -> torch.Tensor:
    """(B, M, d) -> (B, D_sig): naive exp/Chen oracle."""
    return tops.signature_exp_chen(increments, depth)


def sig_words_ref(increments: torch.Tensor, words, d: int | None = None,
                  plan: WordPlan | None = None) -> torch.Tensor:
    """(B, M, d) -> (B, |I|): word-table scan oracle (no kernel, no
    tiles)."""
    if plan is None:
        plan = make_plan(tuple(tuple(w) for w in words),
                         d or increments.shape[-1])
    return _scan_projected(increments, plan, stream=False)
