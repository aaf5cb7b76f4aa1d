"""pathsig on the PyTorch/CUDA port: the paper's API surface in five minutes.

The port of ``examples/quickstart.py``: the same sections, sizes and draws.
On the card (the default) every signature runs the hand-written Hopper
kernels (``sig_trunc``, ``sig_words``, and the ``sig_sweep`` backward);
``--device cpu`` runs the plain PyTorch engine.

On the card, section 9 holds ``sig_trunc``, ``sig_words`` and the
section 2 ``sig_sweep`` gradient against their plain versions (the
gradient against the torch engine's plain sweep) and exits non-zero on a
miss; ``main`` returns those checks for ``chip_smoke.py`` to read.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (anisotropic_words, dag_words, flat_index,
                              lead_lag, logsignature_projected, lyndon_words,
                              make_tiled_plan, projected_signature, sig_dim,
                              signature_combine, sliding_windows,
                              windowed_signature)
from repro_torch.core import tensor_ops as tops
from repro_torch.core.logsignature import logsignature
from repro_torch.core.signature import signature
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as K
from repro_torch.kernels.sig_trunc import sig_trunc_plain
from repro_torch.kernels.sig_words import sig_words_plain

# the kernels against their plain versions (tests/test_kernels.py's bar)
RTOL, ATOL = 2e-4, 2e-5


def section(title):
    print(f"\n--- {title} " + "-" * max(0, 60 - len(title)))


def amax(x: torch.Tensor) -> float:
    return float(torch.max(torch.abs(x)))


def plain_check(kernel: str, what: str, got: torch.Tensor,
                want: torch.Tensor, rtol: float = RTOL,
                atol: float = ATOL) -> dict:
    """A kernel's result held against its plain version on the same
    inputs: printed, and returned as a record."""
    err = amax(got - want)
    print(f"{what} max|err| = {err:.2e}")
    return dict(kernel=kernel, what=what, max_abs_err=err,
                ok=bool(torch.allclose(got, want, rtol=rtol, atol=atol)))


def main(argv=None) -> dict:
    """Run the nine sections; returns the card's kernel-vs-plain checks
    (none on the CPU) as ``{"plain_checks": [record, ...]}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    # 1. Truncated signatures ---------------------------------------------
    section("1. truncated signature")
    B, M, d, N = 4, 50, 3, 4
    path = torch.as_tensor(np.cumsum(rng.standard_normal((B, M + 1, d)),
                                     axis=1), dtype=torch.float32,
                           device=dev) * 0.1
    sig = signature(path, depth=N, device=dev)        # (B, D_sig)
    print(f"path (B={B}, M+1={M+1}, d={d})  ->  signature "
          f"{tuple(sig.shape)}  (D_sig = {sig_dim(d, N)})")

    # Chen's relation: sig(path) == sig(first half) ⊗ sig(second half)
    h = M // 2
    s1 = signature(path[:, :h + 1], N, device=dev)
    s2 = signature(path[:, h:], N, device=dev)
    chen = signature_combine(s1, s2, d, N)
    print(f"Chen identity max|err| = {amax(chen - sig):.2e}")

    # 2. Gradients flow through (O(B*D_sig) memory, paper §4) --------------
    section("2. backprop through the signature")
    p = path.clone().requires_grad_(True)
    grad, = torch.autograd.grad(torch.sum(signature(p, N, device=dev) ** 2),
                                p)
    print(f"d(loss)/d(path): {tuple(grad.shape)}, finite: "
          f"{bool(torch.all(torch.isfinite(grad)))}")
    if dev.type == "cuda":  # held against the plain sweep in section 9
        grad_plain, = torch.autograd.grad(torch.sum(signature(
            p, N, backend="torch", device=dev) ** 2), p)

    # 3. Word projections (paper §7.1) ------------------------------------
    section("3. projected signatures: arbitrary word sets")
    words = [(0,), (1,), (0, 1), (1, 0), (0, 1, 2)]   # pick any coefficients
    proj = projected_signature(path, words, d, device=dev)
    print(f"pi_I(S) for I={words}: {tuple(proj.shape)}")
    full = signature(path, 3, device=dev)
    idx = [flat_index(w, d) for w in words]
    print(f"matches truncated coefficients: "
          f"{amax(proj - full[:, idx]):.2e}")

    # 4. Anisotropic truncation (paper §7.2) -------------------------------
    section("4. anisotropic signature")
    gamma = (1.0, 1.0, 2.0)   # channel 2 is 'rougher': fewer high-order terms
    aw = anisotropic_words(gamma, r=3.0)
    print(f"|W^gamma_(<=3)| = {len(aw)} vs |W_(<=3)| = {sig_dim(d, 3)}")
    aniso = projected_signature(path, aw, d, device=dev)
    print(f"anisotropic signature: {tuple(aniso.shape)}")

    # 5. DAG-constrained word sets (paper §7.1) ----------------------------
    section("5. DAG word sets")
    edges = [(0, 1), (1, 2), (2, 2)]              # channel interaction graph
    dw = dag_words(edges, d, 3)
    print(f"W_(<=3)(G) for chain graph: {len(dw)} words -> "
          f"{tuple(projected_signature(path, dw, d, device=dev).shape)}")

    # 6. Log-signatures in the Lyndon basis (paper §3.3) -------------------
    section("6. log-signature (Lyndon basis)")
    ls = logsignature(path, N, device=dev)
    lsp = logsignature_projected(path, N, device=dev)  # no full level N
    print(f"logsig dim = {ls.shape[-1]} (= #Lyndon words = "
          f"{len(lyndon_words(d, N))}); dense vs projected max|err| = "
          f"{amax(ls - lsp):.2e}")

    # 7. Windowed signatures in one call (paper §5) ------------------------
    section("7. windowed signatures")
    wins = sliding_windows(M, length=10, stride=5)
    ws = windowed_signature(path, wins, depth=3, device=dev)
    print(f"{wins.shape[0]} windows in one call -> {tuple(ws.shape)}")

    # 8. Lead-lag + quadratic variation (paper §8) -------------------------
    section("8. lead-lag transform")
    ll = lead_lag(path)                           # (B, 2M+1, 2d)
    signature(ll, 2, device=dev)
    print(f"lead-lag path: {tuple(ll.shape)}; level-2 signature encodes "
          f"the discrete quadratic variation")

    # 9. The Hopper kernels against their plain versions -------------------
    section("9. Hopper kernels against their plain versions")
    if dev.type != "cuda":
        print("needs the card: skipped, the caller asked for the CPU")
        print("\nquickstart OK")
        return {"plain_checks": []}
    incs = tops.path_increments(path)
    k_out = K.signature(incs, N, backend="cuda", device=dev)    # sig_trunc
    kp = K.projected(incs, words, backend="cuda", device=dev)   # sig_words
    print(f"cone kernel vs oracle max|err| = {amax(k_out - sig):.2e}; "
          f"word-tile kernel vs oracle max|err| = {amax(kp - proj):.2e}")
    checks = [
        plain_check("sig_trunc", "cone kernel vs sig_trunc_plain", k_out,
                    sig_trunc_plain(incs, N)),
        plain_check("sig_words", "word-tile kernel vs sig_words_plain", kp,
                    sig_words_plain(incs, make_tiled_plan(words, d))),
        # the gradient's atol scaled by its largest entry
        plain_check("sig_sweep", "section 2 gradient (sig_sweep) vs the "
                    "torch engine's plain sweep", grad, grad_plain,
                    atol=ATOL * amax(grad_plain))]
    misses = [c["what"] for c in checks if not c["ok"]]
    if misses:
        raise SystemExit(f"kernels disagree with their plain versions: "
                         f"{misses} (rtol {RTOL}, atol {ATOL})")
    print("\nquickstart OK")
    return {"plain_checks": checks}


if __name__ == "__main__":
    main()
