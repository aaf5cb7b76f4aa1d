"""Data-parallel signature training over torch.distributed ranks.

The port of ``examples/distributed_training.py``.  One context manager
makes the signature stack data-parallel: a ``sharding_ctx(mesh)``
installed on every rank

- splits every signature and Gram batch over the mesh's "batch" logical
  axis (each rank runs the kernels of :mod:`repro_torch.kernels.ops` on
  its own rows),
- runs the signature-MMD Gram legs through the cross-rank send/recv ring
  (O(B·D_sig) communication, no replicated Gram-sized intermediate),
- and returns the rows as DTensors placed ``Shard(0)``.

The demo fits a tiny path generator to a drifted random-walk distribution
by gradient descent on the unbiased signature-MMD²: every rank draws the
same global batch, places it (``place_batch``), generates its own rows,
and the gradient of the shared parameters is summed over the ranks.  Then
the same context serves ragged traffic through a mesh-placed
DynamicBatcher.

Run:  PYTHONPATH=src python examples/distributed_training_torch.py
      [--device cpu] [--world N] [--iters 120]
On the card (the default) the ranks are gloo ranks sharing it, or one rank
per card under ``torchrun --nproc-per-node=N`` (NCCL); ``--device cpu``
spawns ``--world`` gloo ranks on the CPU.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed import batch as DB
from repro_torch.distributed import sharding_ctx
from repro_torch.launch.mesh import make_sig_mesh
from repro_torch.optim import adamw
from repro_torch.serve import DynamicBatcher
from repro_torch.sigkernel import sig_mmd
from repro_torch.train import place_batch

DEPTH, D_CH, M_STEPS, BATCH = 3, 2, 24, 16


def target_paths(n: int, seed: int) -> np.ndarray:
    """The distribution to match: drifted, anisotropic random walks."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(n, M_STEPS, D_CH)) * (0.2, 0.35) + (0.08, 0.0)
    return np.concatenate([np.zeros((n, 1, D_CH)), np.cumsum(steps, 1)],
                          1).astype(np.float32)


def generate(params: dict, noise: torch.Tensor) -> torch.Tensor:
    """Tiny generator: per-channel scale and drift applied to white
    noise."""
    steps = noise * params["scale"] + params["drift"]
    return torch.cat([torch.zeros_like(steps[:, :1]),
                      torch.cumsum(steps, dim=1)], dim=1)


def run(iters: int, device) -> dict:
    """Every rank's body: the fit, then the serving round."""
    dev = resolve_device(device)
    lead = dist.get_rank() == 0
    log = print if lead else (lambda *a, **k: None)
    mesh = make_sig_mesh(device=dev)     # every rank, one axis
    log(f"mesh: {tuple(mesh.shape)} over {dist.get_world_size()} ranks "
        f"({dist.get_backend()}, {dev.type})")
    params = {"scale": torch.full((D_CH,), 0.1, device=dev,
                                  requires_grad=True),
              "drift": torch.zeros(D_CH, device=dev, requires_grad=True)}
    opt = adamw(lr=2e-2)
    state = opt.init(params)
    norm = float(np.sqrt(M_STEPS))       # sqrt-length path normalisation
    rng = np.random.default_rng(0)
    mmd = torch.zeros(())
    with sharding_ctx(mesh):             # <- the only multi-rank line
        for it in range(iters):
            noise = torch.from_numpy(rng.normal(
                size=(BATCH, M_STEPS, D_CH)).astype(np.float32)).to(dev)
            ref = torch.from_numpy(target_paths(BATCH, 1000 + it)).to(dev)
            b = place_batch({"noise": noise, "ref": ref})
            # this rank's rows of the generated sample, as a batch DTensor
            fake = DB.rows_like(generate(params, b["noise"].to_local()),
                                b["noise"])
            mmd = sig_mmd(DB.rows_like(fake.to_local() / norm, fake),
                          DB.rows_like(b["ref"].to_local() / norm, b["ref"]),
                          DEPTH, device=dev)
            grads = torch.autograd.grad(mmd, list(params.values()))
            # each rank holds its rows' share of the gradient
            grads = {k: g.clone() for k, g in zip(params, grads)}
            for g in grads.values():
                dist.all_reduce(g)
            with torch.no_grad():
                opt.update(grads, state, params)
            if it % 30 == 0 or it == iters - 1:
                log(f"  it={it:3d}  sig-MMD²={float(mmd.detach()):+.5f}  "
                    f"scale={np.round(params['scale'].tolist(), 3)}  "
                    f"drift={np.round(params['drift'].tolist(), 3)}")
    log("target  |scale|≈[0.2, 0.35] (sign unidentifiable from white noise), "
        "drift≈[0.08, 0.0]; MMD²≈0 means matched")

    # --- the same mesh serving ragged traffic ---------------------------
    db = DynamicBatcher.signature_service(D_CH, DEPTH, max_len=64,
                                          min_bucket=8, device=dev,
                                          mesh=mesh)
    rng = np.random.default_rng(7)
    reqs = [np.cumsum(rng.normal(size=(L + 1, D_CH)).astype(np.float32), 0)
            for L in rng.integers(2, 64, size=25)]
    for r in reqs:
        db.submit(r)
    feats = db.flush()
    st = db.stats()
    log(f"served {len(feats)} requests over {st['devices']} devices: "
        f"{st['compiled_shapes']} shapes, {st['rows_per_device']} "
        f"rows/device, occupancy {st['occupancy']:.0%}")
    return {"mmd": float(mmd.detach()), "served": len(feats),
            "devices": st["devices"],
            "params": {k: v.tolist() for k, v in params.items()}}


def _rank(rank: int, world: int, store: str, iters: int, device,
          queue) -> None:
    backend = "gloo"     # ranks that share a card, or CPU ranks
    if resolve_device(device).type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        out = run(iters, device)
    finally:
        dist.destroy_process_group()
    queue.put((rank, out))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--world", type=int, default=2,
                    help="gloo ranks to spawn (without torchrun)")
    ap.add_argument("--iters", type=int, default=120)
    args = ap.parse_args(argv)
    if "WORLD_SIZE" in os.environ:       # torchrun: one rank a card
        rank = int(os.environ["LOCAL_RANK"])
        dev = args.device or f"cuda:{rank}"
        if resolve_device(dev).type == "cuda":
            torch.cuda.set_device(resolve_device(dev))
        dist.init_process_group("nccl" if resolve_device(dev).type == "cuda"
                                else "gloo")
        try:
            return run(args.iters, dev)
        finally:
            dist.destroy_process_group()
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank, args=(
            r, args.world, os.path.join(tmp, "store"), args.iters,
            args.device, q)) for r in range(args.world)]
        for p in procs:
            p.start()
        got = dict(q.get(timeout=600) for _ in procs)
        for p in procs:
            p.join(timeout=60)
    codes = [p.exitcode for p in procs]
    if codes != [0] * args.world:
        raise SystemExit(f"ranks exited {codes}")
    return got[0]


if __name__ == "__main__":
    main()
