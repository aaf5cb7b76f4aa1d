"""Oracles for the kernels (port of ``repro.kernels.ref``).

The naive levelwise Chen engine with materialised tensor exponentials
(paper eq. (2)); every kernel test holds the kernel against it.
"""
from __future__ import annotations

import torch

from ..core import tensor_ops as tops


def sig_trunc_ref(increments: torch.Tensor, depth: int) -> torch.Tensor:
    """(B, M, d) -> (B, D_sig): naive exp/Chen oracle."""
    return tops.signature_exp_chen(increments, depth)
