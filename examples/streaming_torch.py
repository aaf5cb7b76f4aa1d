"""Streaming signatures end to end on the PyTorch/CUDA port: per-step
outputs, window routes, and the online SignatureStream / SigStreamEngine
state.

The port of ``examples/streaming.py``: the same sections, sizes and draws.
On the card (the default) section 2 runs the streamed ``sig_trunc`` kernel
and one ``sig_sweep`` backward, holds each against its plain version on the
same inputs (``sig_trunc_plain``'s stream, the torch engine's plain sweep)
and exits non-zero on a miss; ``--device cpu`` runs the plain PyTorch
engine, where the same lines compare the engine with the plain versions.

Run:  PYTHONPATH=src python examples/streaming_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (select_route, signature_from_increments,
                              signature_stream_init, sliding_windows,
                              stream_emit_steps, windowed_signature)
from repro_torch.core import tensor_ops as tops
from repro_torch.core.signature import signature
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as K
from repro_torch.kernels.sig_trunc import sig_trunc_plain
from repro_torch.serve import SigStreamEngine

B, M, d, N = 4, 64, 3, 3
RTOL, ATOL = 2e-4, 2e-5    # the kernels against their plain versions


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


def make_path(device) -> torch.Tensor:
    """The reference's draw: 4 random walks of 64 steps in 3 channels."""
    rng = np.random.default_rng(0)
    return torch.as_tensor(np.cumsum(rng.standard_normal((B, M + 1, d)),
                                     axis=1), dtype=torch.float32,
                           device=device) * 0.1


def main(argv=None) -> dict:
    """Run the five sections; returns their tensors by name, and section
    2's kernel-vs-plain records under ``"plain_checks"``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    path = make_path(dev)
    incs = tops.path_increments(path)

    # 1. Streamed forward: all prefix signatures in one pass ---------------
    section("1. streamed signatures (stream=True)")
    stream = signature(path, N, stream=True, device=dev)     # (B, M, D_sig)
    strided = signature(path, N, stream=True, stream_stride=8, device=dev)
    print(f"full stream {tuple(stream.shape)}; stride 8 -> "
          f"{tuple(strided.shape)} (steps "
          f"{[int(s) for s in stream_emit_steps(M, 8)][:4]}..., "
          f"terminal always kept)")
    print(f"last step == terminal signature: "
          f"{amax(stream[:, -1] - signature(path, N, device=dev)):.2e}")

    # 2. The same axis on the kernels (sig_trunc, sig_sweep on the card) ---
    section("2. streamed kernel + streamed backward")
    k_stream = K.signature(incs, N, stream=True, stream_stride=8,
                           device=dev)
    checks = [plain_check("sig_trunc_stream", "kernel stream vs torch scan",
                          k_stream, sig_trunc_plain(incs, N, stream=True,
                                                    stream_stride=8))]
    z = incs.clone().requires_grad_(True)
    g, = torch.autograd.grad(torch.sum(K.signature(
        z, N, stream=True, device=dev) ** 2), z)
    print(f"grad through streamed kernel (one generalised §4.2 reverse "
          f"scan): {tuple(g.shape)}, "
          f"finite={bool(torch.all(torch.isfinite(g)))}")
    g_plain, = torch.autograd.grad(torch.sum(K.signature(
        z, N, stream=True, backend="torch", device=dev) ** 2), z)
    # the gradient's atol scaled by its largest entry
    checks.append(plain_check("sig_sweep", "grad vs the torch engine's plain "
                              "sweep", g, g_plain,
                              atol=ATOL * amax(g_plain)))
    misses = [c["what"] for c in checks if not c["ok"]]
    if misses:
        raise SystemExit(f"kernels disagree with their plain versions: "
                         f"{misses} (rtol {RTOL}, atol {ATOL})")

    # 3. Window routes: fold vs chen over the streamed forward -------------
    section("3. windowed signatures: route='auto'")
    wins = sliding_windows(M, length=32, stride=2)           # heavy overlap
    print(f"{wins.shape[0]} overlapping windows; cost model picks "
          f"route={select_route('auto', wins, M)!r}")
    a = windowed_signature(path, wins, N, route="fold", device=dev)
    b = windowed_signature(path, wins, N, route="chen", device=dev)
    print(f"fold vs chen max|err| = {amax(a - b):.2e}")

    # 4. Online updates: SignatureStream -----------------------------------
    section("4. SignatureStream: extend + rolling_drop")
    st = signature_stream_init(B, d, N, capacity=32, device=dev)
    st = st.extend(incs[:, :20]).extend(incs[:, 20:32])
    st = st.rolling_drop(8)                                  # slide left edge
    fresh = signature_from_increments(incs[:, 8:32], N, device=dev)
    print(f"extend+drop vs fresh window max|err| = "
          f"{amax(st.sig - fresh):.2e} (window length {st.length})")

    # 5. Batched serving: SigStreamEngine ----------------------------------
    section("5. SigStreamEngine: hopping-window features")
    eng = SigStreamEngine(d=d, depth=N, batch=B, window=24, device=dev)
    for k in range(8):                                       # chunks of 8
        feats = eng.push(incs[:, 8 * k:8 * (k + 1)])
    print(f"per-chunk features {tuple(feats.shape)}; window signature "
          f"{tuple(eng.features.shape)} over the last "
          f"{eng.state.length} steps")

    print("\nstreaming example OK")
    return {"stream": stream, "strided": strided, "k_stream": k_stream,
            "grad": g, "fold": a, "chen": b, "extend_drop": st.sig,
            "fresh": fresh, "feats": feats, "window_sig": eng.features,
            "plain_checks": checks}


if __name__ == "__main__":
    main()
