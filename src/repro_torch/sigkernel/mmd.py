"""Signature maximum mean discrepancy (two-sample statistic and loss).

Port of ``repro.sigkernel.mmd``.  MMD²_ω(P, Q) = E k_ω(x, x') +
E k_ω(y, y') − 2 E k_ω(x, y) with the weighted signature kernel of
:mod:`repro_torch.sigkernel.gram`.  The unbiased estimator drops the
diagonal of the within-sample Grams (Gretton et al.'s U-statistic), so it
can be slightly negative under H0.

Differentiable with respect to the signatures and to explicit ``weights``
on every engine (the Gram's closed-form backward); with respect to the
paths on ``backend="torch"`` only, until the training slice brings the
kernels' backward.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .gram import (gram_from_signatures, resolve_weights, signature_features,
                   unpack_ragged)


def mmd_from_signatures(Sx, Sy, weights, *, unbiased: bool = True,
                        route: str = "auto", backend: str = "auto",
                        block_words: int = 512,
                        device=None) -> torch.Tensor:
    """MMD² from signature coordinate matrices (B_x, D), (B_y, D)."""
    m, n = Sx.shape[0], Sy.shape[0]
    kw = dict(route=route, backend=backend, block_words=block_words,
              device=device)
    Kxx = gram_from_signatures(Sx, Sx, weights, **kw)
    Kyy = gram_from_signatures(Sy, Sy, weights, **kw)
    Kxy = gram_from_signatures(Sx, Sy, weights, **kw)
    if unbiased:
        if m < 2 or n < 2:
            raise ValueError(
                f"the unbiased MMD needs >= 2 samples per side, got {m}, {n}")
        sxx = (Kxx.sum() - torch.trace(Kxx)) / (m * (m - 1))
        syy = (Kyy.sum() - torch.trace(Kyy)) / (n * (n - 1))
    else:
        sxx = Kxx.mean()
        syy = Kyy.mean()
    return sxx + syy - 2.0 * Kxy.mean()


def sig_mmd(x, y, depth: int | None = None, *, words=None, weights=None,
            level_weights=None, gamma=None, unbiased: bool = True,
            route: str = "auto", backend: str = "auto",
            backward: str = "inverse", block_words: int = 512,
            x_lengths=None, y_lengths=None, device=None) -> torch.Tensor:
    """Signature-MMD² between path samples x (B_x, M+1, d) and
    y (B_y, M'+1, d); a scalar.  The kernel is configured as in
    :func:`repro_torch.sigkernel.sig_gram`; ``x_lengths`` / ``y_lengths``
    (or :class:`repro_torch.ragged.RaggedPaths` samples) make either side
    ragged."""
    x, x_lengths = unpack_ragged(x, x_lengths)
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    plan, w = resolve_weights(x.shape[-1], depth, words, weights,
                              level_weights, gamma, device=dev)
    kw = dict(words=plan, backend=backend, backward=backward, device=dev)
    Sx = signature_features(x, depth, lengths=x_lengths, **kw)
    Sy = signature_features(y, depth, lengths=y_lengths, **kw)
    return mmd_from_signatures(Sx, Sy, w, unbiased=unbiased, route=route,
                               backend=backend, block_words=block_words,
                               device=dev)
