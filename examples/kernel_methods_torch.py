"""Kernel methods on path signatures on the PyTorch/CUDA port: the
repro_torch.sigkernel subsystem end to end.

The port of ``examples/kernel_methods.py``: the same four demos, sizes and
draws.  On the card (the default) every signature runs the ``sig_trunc``
kernel and every Gram the ``sig_gram`` kernel, and demo 1 holds the tiled
Gram against the oracle product ``S_x·diag(ω)·S_yᵀ`` on the same
signatures (within 1e-5·max|oracle|) and exits non-zero on a miss;
``--device cpu`` runs the plain PyTorch engine.

1. Weighted/projected Gram matrices — the truncated signature kernel with
   anisotropic channel weights, blocked so the (B_x, B_y, D_sig)
   intermediate never exists.
2. Two-sample testing — the unbiased signature-MMD with a permutation test
   separating drifted from driftless random walks.
3. Kernel ridge regression — predict a path functional from the Gram, plus
   the low-rank Nyström features that scale it linearly in batch.
4. Streaming retrieval — SigScoreEngine scoring live streams against a
   cached reference Gram from SignatureStream terminal states.

Run:  PYTHONPATH=src python examples/kernel_methods_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import tensor_ops as tops
from repro_torch.device import resolve_device
from repro_torch.serve import SigScoreEngine
from repro_torch.sigkernel import (fit_sig_krr, nystrom_features, sig_gram,
                                   sig_mmd)

DEPTH = 3
GRAM_TOL = 1e-5     # |K − K_oracle| <= GRAM_TOL · max|K_oracle|


def walks(n, M, d, device, drift=0.0, scale=0.25, seed=0):
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(n, M, d)) * scale + drift
    path = np.concatenate([np.zeros((n, 1, d)), np.cumsum(steps, axis=1)],
                          axis=1)
    return torch.as_tensor(path.astype(np.float32), device=device)


def demo_gram(dev):
    print("\n# 1. weighted signature Gram (anisotropic channels)")
    x, y = walks(6, 32, 3, dev, seed=0), walks(4, 32, 3, dev, seed=1)
    K = sig_gram(x, y, DEPTH, gamma=(0.5, 1.0, 2.0), device=dev)
    K_oracle = sig_gram(x, y, DEPTH, gamma=(0.5, 1.0, 2.0), route="oracle",
                        device=dev)
    err = float(torch.max(torch.abs(K - K_oracle)))
    print(f"  K shape {tuple(K.shape)}, tiled-vs-oracle max err {err:.2e}")
    bound = GRAM_TOL * float(torch.max(torch.abs(K_oracle)))
    if err > bound:
        raise SystemExit(f"the tiled Gram parts from the oracle product by "
                         f"{err:.2e} > {bound:.2e}")
    return dict(kernel="sig_gram", what="tiled-vs-oracle Gram",
                max_abs_err=err, ok=True)


def demo_mmd(dev):
    print("\n# 2. two-sample test: signature MMD + permutation null")
    x = walks(24, 32, 2, dev, drift=+0.06, seed=2)
    y = walks(24, 32, 2, dev, drift=-0.06, seed=3)
    stat = float(sig_mmd(x, y, DEPTH, device=dev))
    pooled = torch.cat([x, y], dim=0)
    rng = np.random.default_rng(0)
    null = []
    for _ in range(30):
        perm = torch.as_tensor(rng.permutation(pooled.shape[0]), device=dev)
        null.append(float(sig_mmd(pooled[perm[:24]], pooled[perm[24:]],
                                  DEPTH, device=dev)))
    p = (1 + sum(n >= stat for n in null)) / (1 + len(null))
    print(f"  MMD^2 = {stat:.4f}, permutation p ~ {p:.3f} "
          f"(null 95% ~ {np.quantile(null, 0.95):.4f})")


def demo_krr(dev):
    print("\n# 3. kernel ridge regression + Nystrom features")
    train, test = walks(48, 24, 2, dev, seed=4), walks(12, 24, 2, dev, seed=5)

    def target(paths):  # a nonlinear path functional: signed area-ish
        inc = tops.path_increments(paths).cpu().numpy()
        x1, x2 = np.cumsum(inc[..., 0], -1), inc[..., 1]
        return torch.as_tensor((x1[:, :-1] * x2[:, 1:]).sum(-1).astype(
            np.float32), device=dev)

    model = fit_sig_krr(train, target(train), DEPTH, reg=1e-4, device=dev)
    pred = model.predict(test)
    rmse = float(torch.sqrt(torch.mean((pred - target(test)) ** 2)))
    base = float(torch.std(target(test), correction=0))
    print(f"  KRR rmse {rmse:.4f} vs target std {base:.4f}")
    ny = nystrom_features(train[:16], DEPTH, device=dev)
    phi_tr, phi_te = ny(train), ny(test)
    # least squares by the pseudo-inverse, at the reference's
    # lstsq(rcond=None) cutoff eps·max(m, n)
    w = torch.linalg.pinv(phi_tr) @ target(train)
    rmse_ny = float(torch.sqrt(torch.mean((phi_te @ w - target(test)) ** 2)))
    print(f"  Nystrom({ny.n_features} features) linear rmse {rmse_ny:.4f}")


def demo_streaming(dev):
    print("\n# 4. streaming retrieval against a cached reference Gram")
    refs = walks(6, 40, 2, dev, seed=6)
    eng = SigScoreEngine(d=2, depth=DEPTH, batch=6, references=refs,
                         device=dev)
    incs = tops.path_increments(refs)   # stream the references themselves
    for chunk in torch.chunk(incs, 4, dim=1):
        scores = eng.push(chunk)
    hits = int((eng.nearest() == torch.arange(6, device=dev)).sum())
    print(f"  after 4 chunks: {hits}/6 streams retrieve their own "
          f"reference; scores diag ~ {float(torch.diag(scores).mean()):.3f}")


def main(argv=None) -> dict:
    """Run the four demos; returns demo 1's kernel-vs-plain record as
    ``{"plain_checks": [record]}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    gram = demo_gram(dev)
    demo_mmd(dev)
    demo_krr(dev)
    demo_streaming(dev)
    return {"plain_checks": [gram]}


if __name__ == "__main__":
    main()
