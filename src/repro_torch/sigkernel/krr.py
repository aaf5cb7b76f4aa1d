"""Kernel ridge regression and reference scoring on signature Grams.

Port of ``repro.sigkernel.krr``.  Fit once against a reference set (solve
the regularised Gram system), then score or predict incoming paths with
one (B, R) cross-Gram per batch: what
:class:`repro_torch.serve.engine.SigScoreEngine` and
``DynamicBatcher.scoring_service`` serve.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.words import WordPlan
from ..device import resolve_device
from .gram import (gram_diag, gram_from_signatures, resolve_weights,
                   signature_features)


def krr_fit(K: torch.Tensor, targets, reg: float = 1e-3) -> torch.Tensor:
    """Solve (K + reg·I) α = y on an (m, m) Gram.  targets: (m,) or (m, p)."""
    m = K.shape[0]
    if tuple(K.shape) != (m, m):
        raise ValueError(f"K must be square, got {tuple(K.shape)}")
    targets = torch.as_tensor(targets, device=K.device).to(K.dtype)
    if targets.shape[0] != m:
        raise ValueError(f"targets rows {targets.shape[0]} != Gram size {m}")
    eye = torch.eye(m, dtype=K.dtype, device=K.device)
    return torch.linalg.solve(K + reg * eye, targets)


def krr_predict(K_query_ref: torch.Tensor,
                alpha: torch.Tensor) -> torch.Tensor:
    """(B, m) cross-Gram × (m[, p]) dual coefficients -> (B[, p])."""
    return K_query_ref @ alpha


def reference_scores(S_query, S_ref, weights, *, normalize: bool = True,
                     backend: str = "auto", block_words: int = 512,
                     eps: float = 1e-12, device=None) -> torch.Tensor:
    """(B, D) query signatures vs (R, D) references -> (B, R) kernel scores;
    ``normalize=True`` gives the RKHS cosine k(x, r) / sqrt(k(x, x) k(r, r))."""
    K = gram_from_signatures(S_query, S_ref, weights, backend=backend,
                             block_words=block_words, device=device)
    if not normalize:
        return K
    S_query, S_ref, weights = (torch.as_tensor(a, device=K.device)
                               for a in (S_query, S_ref, weights))
    qn = torch.sqrt(torch.clamp_min(gram_diag(S_query, weights), eps))
    rn = torch.sqrt(torch.clamp_min(gram_diag(S_ref, weights), eps))
    return K / (qn[:, None] * rn[None, :])


@dataclasses.dataclass(frozen=True)
class SigKRR:
    """A fitted signature kernel ridge regressor (reference signatures and
    duals); it runs on the device its tensors lie on."""
    ref_sigs: torch.Tensor     # (m, D_I)
    alpha: torch.Tensor        # (m,) or (m, p)
    weights: torch.Tensor      # (D_I,)
    depth: int | None
    plan: WordPlan | None
    reg: float
    backend: str = "auto"
    backward: str = "inverse"
    block_words: int = 512

    def _features(self, paths) -> torch.Tensor:
        return signature_features(paths, self.depth, words=self.plan,
                                  backend=self.backend,
                                  backward=self.backward,
                                  device=self.ref_sigs.device)

    def predict(self, paths) -> torch.Tensor:
        """(B, M+1, d) paths -> (B[, p]) predictions."""
        K = gram_from_signatures(self._features(paths), self.ref_sigs,
                                 self.weights, backend=self.backend,
                                 block_words=self.block_words,
                                 device=self.ref_sigs.device)
        return krr_predict(K, self.alpha)

    def scores(self, paths, *, normalize: bool = True) -> torch.Tensor:
        """(B, M+1, d) paths -> (B, m) kernel scores against the references."""
        return reference_scores(self._features(paths), self.ref_sigs,
                                self.weights, normalize=normalize,
                                backend=self.backend,
                                block_words=self.block_words,
                                device=self.ref_sigs.device)


def fit_sig_krr(paths, targets, depth: int | None = None, *, words=None,
                weights=None, level_weights=None, gamma=None,
                reg: float = 1e-3, backend: str = "auto",
                backward: str = "inverse", block_words: int = 512,
                device=None) -> SigKRR:
    """Fit KRR on reference paths (m, M+1, d) with targets (m,) or (m, p)."""
    dev = resolve_device(device)
    paths = torch.as_tensor(paths, device=dev)
    plan, w = resolve_weights(paths.shape[-1], depth, words, weights,
                              level_weights, gamma, device=dev)
    S = signature_features(paths, depth, words=plan, backend=backend,
                           backward=backward, device=dev)
    K = gram_from_signatures(S, S, w, backend=backend,
                             block_words=block_words, device=dev)
    alpha = krr_fit(K, targets, reg)
    return SigKRR(ref_sigs=S, alpha=alpha, weights=w, depth=depth, plan=plan,
                  reg=reg, backend=backend, backward=backward,
                  block_words=block_words)
