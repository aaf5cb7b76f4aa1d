"""Signature maximum mean discrepancy (two-sample statistic and loss).

Port of ``repro.sigkernel.mmd``.  MMD²_ω(P, Q) = E k_ω(x, x') +
E k_ω(y, y') − 2 E k_ω(x, y) with the weighted signature kernel of
:mod:`repro_torch.sigkernel.gram`.  The unbiased estimator drops the
diagonal of the within-sample Grams (Gretton et al.'s U-statistic), so it
can be slightly negative under H0.

Differentiable with respect to the signatures, to explicit ``weights``
and to the paths on every engine: the Gram's closed-form backward, then
the legs' §4.2 inverse sweep (the ``sig_sweep`` kernel on the card).
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..distributed import batch as DB
from ..distributed import collectives as C
from ..kernels import ops
from .gram import (gram_from_signatures, resolve_weights, signature_features,
                   unpack_ragged)


def _sum_and_trace(K) -> torch.Tensor:
    """[Σ K, tr K] of a row-sharded DTensor Gram: each rank sums its block
    and its part of the diagonal, and the differentiable all-reduce adds
    the ranks' parts, so every rank holds both."""
    loc, mesh = K.to_local(), K.device_mesh
    start = DB.rows_of(K.shape[0], mesh.size(), mesh.get_local_rank())[0]
    part = torch.stack([loc.sum(), torch.diagonal(loc, offset=start).sum()])
    return C.reduce_sum(part, mesh.get_group(), tag="sig_mmd")


def mmd_from_signatures(Sx, Sy, weights, *, unbiased: bool = True,
                        route: str = "auto", backend: str = "auto",
                        block_words: int = 512,
                        device=None) -> torch.Tensor:
    """MMD² from signature coordinate matrices (B_x, D), (B_y, D).  Under
    a sharding context the Grams are row-sharded DTensors and their sums
    are added over the ranks: every rank returns the same scalar."""
    m, n = Sx.shape[0], Sy.shape[0]
    kw = dict(route=route, backend=backend, block_words=block_words,
              device=device)
    Kxx = gram_from_signatures(Sx, Sx, weights, **kw)
    Kyy = gram_from_signatures(Sy, Sy, weights, **kw)
    Kxy = gram_from_signatures(Sx, Sy, weights, **kw)
    if unbiased and (m < 2 or n < 2):
        raise ValueError(
            f"the unbiased MMD needs >= 2 samples per side, got {m}, {n}")
    if DB.is_dtensor(Kxx):
        (sum_xx, tr_xx), (sum_yy, tr_yy) = (_sum_and_trace(Kxx),
                                            _sum_and_trace(Kyy))
        sum_xy = _sum_and_trace(Kxy)[0]
        if not unbiased:
            tr_xx = tr_yy = 0.0
        sxx = (sum_xx - tr_xx) / (m * (m - 1) if unbiased else m * m)
        syy = (sum_yy - tr_yy) / (n * (n - 1) if unbiased else n * n)
        return sxx + syy - 2.0 * (sum_xy / (m * n))
    if unbiased:
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
    x = ops._as_batch(x, dev)
    plan, w = resolve_weights(x.shape[-1], depth, words, weights,
                              level_weights, gamma, device=dev)
    kw = dict(words=plan, backend=backend, backward=backward, device=dev)
    Sx = signature_features(x, depth, lengths=x_lengths, **kw)
    Sy = signature_features(y, depth, lengths=y_lengths, **kw)
    return mmd_from_signatures(Sx, Sy, w, unbiased=unbiased, route=route,
                               backend=backend, block_words=block_words,
                               device=dev)
