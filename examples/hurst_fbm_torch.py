"""Paper §8 on the PyTorch/CUDA port: Hurst-parameter estimation on
multivariate fBM with a sparse lead-lag signature projection.

The port of ``examples/hurst_fbm.py``.  Deep-signature model (cf. Bonnier
et al. [19]): a learnable per-channel scaling of the lead-lag path, a
signature feature map, a signed log, frozen whitening and a small MLP
head with GELU.  Three feature maps, as in the paper's Figure 4:

- ``fnn``       : flattened raw path -> MLP (no signature),
- ``truncated`` : the full truncated lead-lag signature W_{<=N}
                  (``sig_trunc`` on the card),
- ``sparse``    : the paper's sparse lead-lag word projection
                  W^sparse_{<=N} = {u_1∘…∘u_p : u_j in G}
                  (``sig_words`` on the card).

Training backpropagates through the signature by the §4.2 inverse sweep
(the ``sig_sweep`` kernel on the card): one forward kernel and one sweep
a step.

Run:  PYTHONPATH=src python examples/hurst_fbm_torch.py [--full]
      [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import tensor_ops as tops
from repro_torch.core.projection import projected_signature_from_increments
from repro_torch.core.signature import signature_from_increments
from repro_torch.core.transforms import lead_lag, sparse_leadlag_generators
from repro_torch.core.words import generated_words, make_plan, sig_dim
from repro_torch.data.pipeline import hurst_dataset
from repro_torch.device import resolve_device


class Dense(nn.Module):
    """x @ w + b, with w (in, out) as in the reference's MLP."""

    def __init__(self, a: int, b: int, gen: torch.Generator,
                 bias: float = 0.0):
        super().__init__()
        self.w = nn.Parameter(torch.randn(a, b, generator=gen)
                              * math.sqrt(2.0 / a))
        self.b = nn.Parameter(torch.full((b,), bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class HurstModel(nn.Module):
    """The §8 deep-signature model.  ``backend`` and ``backward`` select
    the signature engine as in the port's signature functions.

    Signature coefficients at different levels live on very different
    scales, so features are whitened with statistics taken on a reference
    batch (:meth:`whiten`, frozen thereafter).  ``mu`` and ``sd`` are not
    part of the state dict, as in the reference, where they live in the
    ``apply`` closure."""

    def __init__(self, kind: str, d: int, depth: int, M: int, *,
                 seed: int = 0, backend: str = "auto",
                 backward: str = "inverse", device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.kind, self.depth = kind, depth
        self.backend, self.backward = backend, backward
        self.plan = None
        if kind == "fnn":
            feat_dim = (M + 1) * d
            sizes = [feat_dim, 256, 64, 1]
        elif kind in ("truncated", "sparse"):
            if kind == "sparse":
                words = generated_words(sparse_leadlag_generators(d), depth)
                self.plan = make_plan(words, 2 * d)
                feat_dim = len(words)
            else:
                feat_dim = sig_dim(2 * d, depth)
            self.scale = nn.Parameter(torch.ones(d))   # per-channel scale
            sizes = [feat_dim, 128, 64, 1]
        else:
            raise ValueError(f"unknown model kind {kind!r}")
        # the last bias starts at the prior mean of H ~ U(0.25, 0.75)
        self.mlp = nn.ModuleList(
            Dense(a, b, gen, 0.5 if i == len(sizes) - 2 else 0.0)
            for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])))
        self.register_buffer("mu", torch.zeros(feat_dim), persistent=False)
        self.register_buffer("sd", torch.ones(feat_dim), persistent=False)
        self.feat_dim = feat_dim
        self.to(device=resolve_device(device), dtype=dtype)

    def features(self, paths: torch.Tensor) -> torch.Tensor:
        """(B, M+1, d) paths -> (B, feat_dim) raw features."""
        if self.kind == "fnn":
            return paths.reshape(paths.shape[0], -1)
        x = paths * self.scale[None, None, :]
        incs = tops.path_increments(lead_lag(x))   # (B, 2M, 2d)
        kw = dict(backend=self.backend, backward=self.backward,
                  device=incs.device)
        if self.plan is not None:
            f = projected_signature_from_increments(incs, self.plan, **kw)
        else:
            f = signature_from_increments(incs, self.depth, **kw)
        # level-n terms scale like |X|^n: the signed log makes them
        # MLP-friendly
        return torch.sign(f) * torch.log1p(torch.abs(f))

    @torch.no_grad()
    def whiten(self, sample: torch.Tensor) -> None:
        """Freeze the feature statistics of a reference batch."""
        f0 = self.features(sample)
        self.mu.copy_(f0.mean(0))
        self.sd.copy_(f0.std(0, correction=0) + 1e-6)

    def forward(self, paths: torch.Tensor) -> torch.Tensor:
        x = (self.features(paths) - self.mu) / self.sd
        for i, layer in enumerate(self.mlp):
            x = layer(x)
            if i < len(self.mlp) - 1:
                x = F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
        return x[..., 0]


def make_model(kind: str, d: int, depth: int, M: int, sample: torch.Tensor,
               *, seed: int = 0, **kw) -> HurstModel:
    """A model with its whitening taken on ``sample``."""
    model = HurstModel(kind, d, depth, M, seed=seed, device=sample.device,
                       **kw)
    model.whiten(sample)
    return model


def mse(model: HurstModel, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((model(x) - y) ** 2)


def adam(model: HurstModel, lr: float) -> torch.optim.Adam:
    """The reference's Adam: β 0.9 / 0.999, eps 1e-8 outside the square
    root, bias-corrected."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def train(kind, Xtr, Htr, Xva, Hva, *, depth, epochs, batch, lr, seed=0,
          **kw):
    d, M = Xtr.shape[-1], Xtr.shape[1] - 1
    model = make_model(kind, d, depth, M, Xtr[:256], seed=seed, **kw)
    opt = adam(model, lr)
    n = Xtr.shape[0]
    rng = np.random.default_rng(seed)
    curve, t0 = [], time.time()
    for _ in range(epochs):
        perm = torch.as_tensor(rng.permutation(n), device=Xtr.device)
        for i in range(0, n - batch + 1, batch):
            idx = perm[i:i + batch]
            opt.zero_grad(set_to_none=True)
            mse(model, Xtr[idx], Htr[idx]).backward()
            opt.step()
        with torch.no_grad():
            curve.append(float(mse(model, Xva, Hva)))
    return {"kind": kind, "feat_dim": model.feat_dim, "curve": curve,
            "val_mse": curve[-1], "train_s": time.time() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale: 8000 paths of length 250")
    ap.add_argument("--epochs", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.full:
        n_tr, n_va, M, epochs = 8000, 2000, 250, 30
    else:
        n_tr, n_va, M, epochs = 1500, 400, 80, 25
    epochs = args.epochs or epochs
    d, depth, batch, lr = 5, 3, 128, 1e-2
    dev = resolve_device(args.device)

    print(f"generating {n_tr + n_va} fBM paths (d={d}, M={M}, "
          f"H ~ U(0.25, 0.75)) ...")
    X, H = hurst_dataset(seed=0, n_paths=n_tr + n_va, n_steps=M, d=d)
    X = torch.as_tensor(X, device=dev)
    H = torch.as_tensor(H, device=dev)
    Xtr, Htr, Xva, Hva = X[:n_tr], H[:n_tr], X[n_tr:], H[n_tr:]
    var_H = float(torch.var(Hva, correction=0))
    print(f"predict-the-mean MSE (floor reference): {var_H:.5f}\n")

    results = [train(k, Xtr, Htr, Xva, Hva, depth=depth, epochs=epochs,
                     batch=batch, lr=lr) for k in ("fnn", "truncated",
                                                   "sparse")]
    print(f"{'model':<12} {'features':>9} {'val MSE':>10} {'train s':>9}")
    for r in results:
        print(f"{r['kind']:<12} {r['feat_dim']:>9} {r['val_mse']:>10.5f} "
              f"{r['train_s']:>9.1f}")
    tr = next(r for r in results if r["kind"] == "truncated")
    sp = next(r for r in results if r["kind"] == "sparse")
    print(f"\nsparse vs truncated: {tr['feat_dim'] / sp['feat_dim']:.2f}x "
          f"fewer features, {tr['train_s'] / sp['train_s']:.2f}x faster "
          f"training, val MSE {sp['val_mse']:.5f} vs {tr['val_mse']:.5f}")
    print("validation curves (per epoch):")
    for r in results:
        print(f"  {r['kind']:<10}", " ".join(f"{x:.4f}" for x in r["curve"]))


if __name__ == "__main__":
    main()
