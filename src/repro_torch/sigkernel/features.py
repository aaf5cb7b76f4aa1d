"""Low-rank feature maps for the signature kernel: kernel methods at O(B).

Port of ``repro.sigkernel.features``.  Both maps give explicit features φ
with φ(x)·φ(y) ≈ k_ω(x, y):

- :func:`random_word_features`: sample n word coordinates of W_{<=N}
  (numpy-seeded, as the reference samples them) and run the projected
  signature engine; an unbiased Monte-Carlo estimate of the weighted inner
  product, exact when every word is kept.
- :func:`nystrom_features`: Nyström landmarks, φ(x) = K_xm (K_mm)^{-½},
  exact on the span of the landmark signatures.

Each map runs on the device its tensors lie on.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import tensor_ops as tops
from ..core.words import WordPlan, all_words, make_plan
from ..device import resolve_device
from ..kernels import ops
from .gram import (gram_from_signatures, resolve_weights, signature_features,
                   word_weights)


@dataclasses.dataclass(frozen=True)
class WordSubsetFeatures:
    """Feature map φ(x)_k = scale_k · ⟨S(x), w_k⟩ over a sampled word set."""
    plan: WordPlan
    scale: torch.Tensor        # (n_features,)
    backend: str = "auto"
    backward: str = "inverse"

    @property
    def n_features(self) -> int:
        return len(self.plan.words)

    def __call__(self, paths) -> torch.Tensor:
        dev = self.scale.device
        paths = torch.as_tensor(paths, device=dev)
        coords = ops.projected(tops.path_increments(paths), self.plan,
                               backend=self.backend, backward=self.backward,
                               device=dev)
        return coords * self.scale[None, :]


def random_word_features(d: int, depth: int, n_features: int, *,
                         seed: int = 0, level_weights=None, gamma=None,
                         backend: str = "auto", backward: str = "inverse",
                         device=None) -> WordSubsetFeatures:
    """Uniform word-subset projection features for k_ω on W_{<=N}.

    Samples ``n_features`` words without replacement
    (``np.random.default_rng(seed)``) and scales coordinate k by
    sqrt(ω_k · D/n) so that E[φ(x)·φ(y)] = k_ω(x, y); ``n_features >=
    D_sig`` keeps every word and the map is exact.
    """
    vocab = all_words(d, depth)
    D = len(vocab)
    w = word_weights(words=vocab, level_weights=level_weights, gamma=gamma)
    if n_features < 1:
        raise ValueError(f"n_features must be >= 1, got {n_features}")
    if n_features >= D:
        idx = np.arange(D)
    else:
        idx = np.sort(np.random.default_rng(seed).choice(
            D, size=n_features, replace=False))
    words = tuple(vocab[i] for i in idx)
    scale = np.sqrt(w[idx] * (D / len(idx))).astype(np.float32)
    return WordSubsetFeatures(
        plan=make_plan(words, d),
        scale=torch.as_tensor(scale, device=resolve_device(device)),
        backend=backend, backward=backward)


@dataclasses.dataclass(frozen=True)
class NystromFeatures:
    """φ(x) = k_ω(x, landmarks) · (K_mm)^{-½}: rank-m kernel features."""
    landmark_sigs: torch.Tensor   # (m, D_I) signature coordinates
    transform: torch.Tensor       # (m, m) = U diag(s^{-½})
    weights: torch.Tensor         # (D_I,)
    depth: int | None
    plan: WordPlan | None
    backend: str = "auto"
    backward: str = "inverse"
    block_words: int = 512

    @property
    def n_features(self) -> int:
        return self.transform.shape[1]

    def __call__(self, paths) -> torch.Tensor:
        dev = self.landmark_sigs.device
        S = signature_features(paths, self.depth, words=self.plan,
                               backend=self.backend, backward=self.backward,
                               device=dev)
        Kxm = gram_from_signatures(S, self.landmark_sigs, self.weights,
                                   backend=self.backend,
                                   block_words=self.block_words, device=dev)
        return Kxm @ self.transform


def nystrom_features(landmarks, depth: int | None = None, *, words=None,
                     weights=None, level_weights=None, gamma=None,
                     rel_tol: float = 1e-10, backend: str = "auto",
                     backward: str = "inverse", block_words: int = 512,
                     device=None) -> NystromFeatures:
    """Fit a Nyström feature map from landmark paths (m, M+1, d).

    Eigendecomposes the (m, m) landmark Gram; eigendirections below
    ``rel_tol`` · λ_max are zeroed (pseudo-inverse), keeping shapes static.
    φ(x)·φ(y) = K_xm (K_mm)⁺ K_my, exact whenever x, y are landmarks.
    """
    dev = resolve_device(device)
    landmarks = torch.as_tensor(landmarks, device=dev)
    plan, w = resolve_weights(landmarks.shape[-1], depth, words, weights,
                              level_weights, gamma, device=dev)
    S_m = signature_features(landmarks, depth, words=plan, backend=backend,
                             backward=backward, device=dev)
    K = gram_from_signatures(S_m, S_m, w, backend=backend,
                             block_words=block_words, device=dev)
    s, U = torch.linalg.eigh(K)                    # ascending eigenvalues
    good = s > torch.clamp_min(s[-1], 0.0) * rel_tol
    inv_sqrt = torch.where(good, 1.0 / torch.sqrt(torch.where(good, s, 1.0)),
                           0.0)
    return NystromFeatures(landmark_sigs=S_m, transform=U * inv_sqrt[None, :],
                           weights=w, depth=depth, plan=plan, backend=backend,
                           backward=backward, block_words=block_words)
