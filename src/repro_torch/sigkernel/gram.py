"""Weighted / projected signature Gram matrices (kernel-method front end).

Port of ``repro.sigkernel.gram`` (single device).  pathsig computes
signatures in the word basis, so the truncated signature kernel is a
weighted inner product over word coordinates:

    k_ω(x, y) = Σ_{w ∈ I} ω_w ⟨S(x), w⟩ ⟨S(y), w⟩  =  (S_x diag(ω) S_yᵀ)_{xy}

which makes projected word sets I (paper §7.1) and anisotropic level
weights (paper §7.2) kernel hyperparameters.  This module builds the weight
vectors, computes the signature legs through the engine dispatch, and
routes the Gram product through the naive oracle ``S_x @ diag(ω) @ S_yᵀ``
or the word-blocked route :func:`repro_torch.kernels.ops.gram` (on a CUDA
device the ``sig_gram`` kernel).  Every entry point takes ``device=None``,
which means the CUDA card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import tensor_ops as tops
from ..core.signature import _unpack_ragged
from ..core.words import WordPlan, all_words, make_plan, sig_dim
from ..device import resolve_device
from ..distributed import batch as DB
from ..kernels import ops

ROUTES = ("auto", "oracle", "tiled")


def word_weights(d: int | None = None, depth: int | None = None, *,
                 words=None, level_weights=None, gamma=None,
                 dtype=np.float32) -> np.ndarray:
    """The coordinate weight vector ω over a word basis (host-side numpy).

    - ``words=None``: ω over the full truncation W_{<=N} in level-major
      order (the flat signature layout); needs ``d`` and ``depth``.
    - ``level_weights``: (λ_1, ..., λ_N); ω_w *= λ_{|w|}.
    - ``gamma``: per-channel weights (γ_0, ..., γ_{d-1}), strictly
      positive; ω_w *= Π_j γ_{w_j}, the anisotropic kernel of paper §7.2.
    """
    if words is None:
        if d is None or depth is None:
            raise ValueError("word_weights needs either words= or (d, depth)")
        words = all_words(d, depth)
    words = [tuple(w) for w in words]
    if any(len(word) == 0 for word in words):
        raise ValueError("the empty word is implicit (its coordinate is the "
                         "constant 1); remove it from the word set")
    w = np.ones(len(words), dtype)
    if level_weights is not None:
        lw = np.asarray(level_weights, dtype)
        top = max((len(word) for word in words), default=0)
        if lw.ndim != 1 or len(lw) < top:
            raise ValueError(f"level_weights needs one entry per level "
                             f"1..{top}, got shape {lw.shape}")
        w *= lw[np.array([len(word) - 1 for word in words], dtype=np.intp)]
    if gamma is not None:
        g = np.asarray(gamma, dtype)
        if (g <= 0).any():
            raise ValueError("anisotropic weights must be strictly positive")
        for i, word in enumerate(words):
            w[i] *= np.prod(g[list(word)])
    return w


def _as_plan(words, d: int) -> WordPlan:
    if isinstance(words, WordPlan):
        return words
    return make_plan(tuple(tuple(w) for w in words), d)


def unpack_ragged(paths, lengths=None):
    """(RaggedPaths | tensor, lengths-or-None) -> (values, lengths-or-None);
    explicit ``lengths`` wins over the container's."""
    values, rl = _unpack_ragged(paths)
    if rl is not None:
        return values, (rl if lengths is None else lengths)
    return values, lengths


def signature_features(paths, depth: int | None = None, *, words=None,
                       backend: str = "auto", backward: str = "inverse",
                       lengths=None, device=None) -> torch.Tensor:
    """The Gram legs: (B, M+1, d) paths -> (B, |I|) signature coordinates.

    ``words=None`` gives the full truncation (needs ``depth``), otherwise
    the projected coordinates of the word set or plan, through the engine
    dispatch.  ``lengths`` (B,) makes the batch ragged (a
    :class:`repro_torch.ragged.RaggedPaths` may be passed as ``paths``).
    """
    paths, lengths = unpack_ragged(paths, lengths)
    dev = resolve_device(device)
    paths = ops._as_batch(paths, dev)
    if paths.ndim != 3:
        raise ValueError(f"expected batched paths (B, M+1, d), "
                         f"got {tuple(paths.shape)}")
    # a batch DTensor (under a sharding context) differences its own rows
    incs = DB.rows_like(tops.path_increments(DB.to_local(paths)), paths)
    if words is not None:
        plan = _as_plan(words, paths.shape[-1])
        return ops.projected(incs, plan, backend=backend, backward=backward,
                             lengths=lengths, device=dev)
    if depth is None:
        raise ValueError("signature_features needs depth= or words=")
    return ops.signature(incs, depth, backend=backend, backward=backward,
                         lengths=lengths, device=dev)


def resolve_weights(paths_d: int, depth: int | None, words, weights,
                    level_weights, gamma,
                    device=None) -> tuple[WordPlan | None, torch.Tensor]:
    """-> (plan-or-None, ω on ``device``) shared by gram / mmd / features /
    krr."""
    dev = resolve_device(device)
    plan = _as_plan(words, paths_d) if words is not None else None
    if plan is None and depth is None:
        raise ValueError("need depth= (full truncation) or words=")
    if weights is not None:
        w = torch.as_tensor(weights, device=dev)
        if level_weights is not None or gamma is not None:
            raise ValueError("pass either explicit weights= or "
                             "level_weights=/gamma=, not both")
        n = len(plan.words) if plan is not None else sig_dim(paths_d, depth)
        if tuple(w.shape) != (n,):
            raise ValueError(f"weights shape {tuple(w.shape)} != ({n},): one "
                             "weight per word coordinate")
        return plan, w
    wv = word_weights(paths_d, depth,
                      words=plan.words if plan is not None else None,
                      level_weights=level_weights, gamma=gamma)
    return plan, torch.as_tensor(wv, device=dev)


def gram_from_signatures(Sx, Sy, weights, *, route: str = "auto",
                         backend: str = "auto", block_words: int = 512,
                         device=None) -> torch.Tensor:
    """(B_x, D), (B_y, D), (D,) -> (B_x, B_y) weighted Gram, routed."""
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; expected one of {ROUTES}")
    if route == "oracle":
        # the naive reference: S_x @ diag(ω) @ S_yᵀ in one product
        dev = resolve_device(device)
        Sx, Sy, weights = (torch.as_tensor(a, device=dev)
                           for a in (Sx, Sy, weights))
        return (Sx * weights[None, :]) @ Sy.T
    return ops.gram(Sx, Sy, weights, backend=backend,
                    block_words=block_words, device=device)


def sig_gram(x, y=None, depth: int | None = None, *, words=None,
             weights=None, level_weights=None, gamma=None,
             route: str = "auto", backend: str = "auto",
             backward: str = "inverse", block_words: int = 512,
             x_lengths=None, y_lengths=None, device=None) -> torch.Tensor:
    """Batched signature Gram matrix K[i, j] = k_ω(x_i, y_j).

    x: (B_x, M+1, d) paths; y: (B_y, M'+1, d) paths or None (the symmetric
    Gram of x, signatures computed once).  The kernel is configured by
    ``depth`` (full truncation) or ``words`` (projected set), plus
    ``weights`` / ``level_weights`` / ``gamma`` (see :func:`word_weights`).
    ``route="oracle"`` is the naive product; ``"tiled"`` (= ``"auto"``) is
    :func:`repro_torch.kernels.ops.gram`.  ``x_lengths`` / ``y_lengths``
    (or :class:`repro_torch.ragged.RaggedPaths` inputs) make either batch
    ragged.  Differentiable: the legs by the engine's backward, the product
    by its closed-form backward.
    """
    x, x_lengths = unpack_ragged(x, x_lengths)
    dev = resolve_device(device)
    x = ops._as_batch(x, dev)
    plan, w = resolve_weights(x.shape[-1], depth, words, weights,
                              level_weights, gamma, device=dev)
    kw = dict(words=plan, backend=backend, backward=backward, device=dev)
    Sx = signature_features(x, depth, lengths=x_lengths, **kw)
    Sy = Sx if y is None else signature_features(y, depth, lengths=y_lengths,
                                                 **kw)
    return gram_from_signatures(Sx, Sy, w, route=route, backend=backend,
                                block_words=block_words, device=dev)


def gram_diag(S: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(B, D) -> (B,) the Gram diagonal k_ω(x, x) = Σ_k ω_k S_k², without
    forming the full matrix: the normaliser of RKHS cosine scores."""
    return ((S * S) * weights[None, :]).sum(dim=-1)
