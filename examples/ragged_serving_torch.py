"""Ragged serving demo on the PyTorch/CUDA port: variable-length paths end
to end.

The port of ``examples/ragged_serving.py``: the same traffic, ladders and
printed lines.  On the card (the default) every signature is a
``sig_trunc`` launch and every scoring micro-batch adds a ``sig_gram``
launch; ``--device cpu`` runs the plain PyTorch engine.

Shows the three layers of `repro_torch.ragged`:

1. exact variable-length signatures from one padded batch (`RaggedPaths` +
   `lengths=` through the engine dispatch — zero-masked padding is the
   identity, so on the CPU the answers match per-example unpadded calls to
   the bit);
2. micro-batched serving with `repro_torch.serve.DynamicBatcher`:
   mixed-length requests packed into a bounded ladder of launch shapes;
3. kernel scoring of ragged traffic against cached references
   (`DynamicBatcher.scoring_service` over a `SigScoreEngine`).

On the card the ``sig_trunc`` planner picks its cone split from the batch
size, and another split rounds differently: the padded batch of 48 and the
unpadded call of 1 may part by a few ulps.  So the unpadded call (batch 1,
as the reference makes it) is held to the bit on the CPU and to the
kernels' tolerance (rtol 2e-4, atol 2e-5) on the card, where one more line
makes the unpadded call at the batch's size, the same split, and holds it
to the bit.  The batcher's micro-batches are other sizes again: they are
held to the kernels' tolerance on either device.  The run fails on a miss.
Wall-clock figures are printed as measured.

Run:  PYTHONPATH=src python examples/ragged_serving_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.signature import signature
from repro_torch.data import geometric_lengths
from repro_torch.device import resolve_device
from repro_torch.ragged import RaggedPaths
from repro_torch.serve import DynamicBatcher, SigScoreEngine

D, DEPTH, MAX_LEN = 3, 4, 256
RTOL, ATOL = 2e-4, 2e-5    # the kernels against their plain versions


def make_requests(n: int, seed: int = 0) -> list[np.ndarray]:
    lengths = geometric_lengths(seed, n, MAX_LEN, min_steps=2)
    rng = np.random.default_rng(seed)
    out = []
    for L in lengths:
        steps = rng.standard_normal((int(L), D)).astype(np.float32)
        steps /= np.sqrt(max(int(L), 1))
        out.append(np.concatenate([np.zeros((1, D), np.float32),
                                   np.cumsum(steps, axis=0)], axis=0))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    reqs = make_requests(48)
    print(f"{len(reqs)} requests, lengths "
          f"{sorted(p.shape[0] - 1 for p in reqs)[:6]} ... "
          f"{max(p.shape[0] - 1 for p in reqs)}")

    # 1) one padded batch == per-example unpadded signatures, exactly
    rp = RaggedPaths.from_list(reqs, device=dev)
    sig = signature(rp, DEPTH, device=dev)           # (B, D_sig)
    ref = signature(torch.as_tensor(reqs[0], device=dev)[None], DEPTH,
                    device=dev)[0]
    err_unpadded = float(torch.max(torch.abs(sig[0] - ref)))
    print(f"ragged batch: {tuple(sig.shape)}; max |err| vs unpadded call: "
          f"{err_unpadded:.1e}")
    exact = [err_unpadded] if dev.type != "cuda" else []
    close = [torch.allclose(sig[0], ref, rtol=RTOL, atol=ATOL)]
    if dev.type == "cuda":  # at the batch's size only padding differs
        same = signature(torch.as_tensor(reqs[0], device=dev).expand(
            len(reqs), -1, -1), DEPTH, device=dev)[0]
        exact.append(float(torch.max(torch.abs(sig[0] - same))))
        print(f"   max |err| vs unpadded call at the batch's size: "
              f"{exact[-1]:.1e}")

    # 2) dynamic batching: a bounded set of launch shapes serves any mix
    db = DynamicBatcher.signature_service(D, DEPTH, max_len=MAX_LEN,
                                          min_bucket=32, device=dev)
    t0 = time.perf_counter()
    tickets = [db.submit(p) for p in reqs]
    res = db.flush()
    dt = time.perf_counter() - t0
    st = db.stats()
    print(f"DynamicBatcher: {len(res)} requests in {dt*1e3:.0f} ms "
          f"(cold, incl. compiles) using {st['compiled_shapes']} compiled "
          f"shapes (ladder {st['ladder']}), padding overhead "
          f"{st['padding_overhead']:.2f}x")
    err_batcher = max(float(torch.max(torch.abs(res[t] - sig[i])))
                      for i, t in enumerate(tickets))
    print(f"   max |err| vs the ragged batch: {err_batcher:.1e}")
    # the micro-batches are other sizes than the ragged batch: on the card
    # they may run at another cone split, held to the kernels' tolerance
    close += [torch.allclose(res[t], sig[i], rtol=RTOL, atol=ATOL)
              for i, t in enumerate(tickets)]

    # 3) kernel scoring of ragged traffic against cached references
    refs = np.cumsum(np.random.default_rng(7).standard_normal(
        (8, 33, D)).astype(np.float32) * 0.18, axis=1)
    engine = SigScoreEngine(d=D, depth=DEPTH, batch=4,
                            references=torch.as_tensor(refs, device=dev),
                            device=dev)
    sb = DynamicBatcher.scoring_service(engine, max_len=MAX_LEN,
                                        mode="nearest", min_bucket=32)
    t2 = [sb.submit(p) for p in reqs[:8]]
    nearest = sb.flush()
    print(f"scoring_service(nearest): "
          f"{[int(nearest[t]) for t in t2]} (reference indices)")
    if any(exact) or not all(close):
        raise SystemExit(f"padding is not the identity: max |err| "
                         f"{err_unpadded:.1e} vs the unpadded call, "
                         f"{err_batcher:.1e} vs the ragged batch")
    print("\nragged serving OK — see examples/sessions_serving_torch.py "
          "for the STATEFUL serving path (pooled multi-tenant sessions with "
          "checkpoint/restore)")


if __name__ == "__main__":
    main()
