"""Fractional Brownian motion for the paper's §8 Hurst experiment.

Port of ``fbm_paths`` and ``hurst_dataset`` from ``repro.data.pipeline``:
numpy only, and the same arrays as the reference for the same seed.
"""
from __future__ import annotations

import numpy as np


def fbm_paths(rng: np.random.Generator, n_paths: int, n_steps: int,
              hurst: np.ndarray | float, d: int = 1,
              T: float = 1.0) -> np.ndarray:
    """Exact fBM via the Cholesky factor of the fBM covariance, one per
    Hurst exponent.

    hurst: scalar or (n_paths,) array (H ~ U(0.25, 0.75) in the paper).
    Returns (n_paths, n_steps+1, d) float32, X_0 = 0, components
    independent.
    """
    H = np.broadcast_to(np.asarray(hurst, np.float64), (n_paths,))
    t = np.linspace(T / n_steps, T, n_steps)
    out = np.zeros((n_paths, n_steps + 1, d), np.float32)
    # paths of one H share a Cholesky factor
    uniq, inv = np.unique(np.round(H, 6), return_inverse=True)
    for u_i, h in enumerate(uniq):
        idx = np.nonzero(inv == u_i)[0]
        tt = t[:, None]
        ss = t[None, :]
        cov = 0.5 * (tt ** (2 * h) + ss ** (2 * h) - np.abs(tt - ss) ** (2 * h))
        L = np.linalg.cholesky(cov + 1e-12 * np.eye(n_steps))
        z = rng.standard_normal((len(idx), n_steps, d))
        out[idx, 1:, :] = np.einsum("ts,psd->ptd", L, z).astype(np.float32)
    return out


def hurst_dataset(seed: int, n_paths: int, n_steps: int, d: int,
                  h_range=(0.25, 0.75)) -> tuple[np.ndarray, np.ndarray]:
    """(paths (N, M+1, d), H (N,)): the paper's §8 Hurst-estimation data."""
    rng = np.random.default_rng(seed)
    H = rng.uniform(*h_range, size=n_paths)
    X = fbm_paths(rng, n_paths, n_steps, H, d)
    return X, H.astype(np.float32)
