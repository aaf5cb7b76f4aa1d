"""Training launcher, on one device or data-parallel over ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --reduced --steps 20 --batch 4 --seq 64 --ckpt-dir runs/ckpt \
        [--device cpu] [--loss sig_mmd --sig-channels 8 --sig-depth 3]

    PYTHONPATH=src torchrun --nproc-per-node=4 -m repro_torch.launch.train \
        --arch qwen3-4b --reduced --mesh 2x2 [--backend gloo --device cuda:0]

``--device`` defaults to the CUDA card (``cuda:LOCAL_RANK`` under
torchrun).  ``--mesh DxM``: a ``("data", "model")`` mesh of D x M ranks
(the world must hold them: torchrun's, or a process group the caller
initialised, gloo on the CPU or on one shared card), laid out by
``param_specs`` as the reference's launcher lays its parameters out:
tensor and expert parallel over the M model ranks, FSDP over the D data
ranks.  Every rank draws the same global batch and trains on its data
rows (:func:`repro_torch.train.place_batch`); rank 0 prints and writes
the checkpoints (the full arrays, gathered).  Under torchrun the process
group is NCCL on the card (one rank a card) unless ``--backend gloo``
asks for gloo: with ``--device cuda:0`` the ranks then share one card,
which checks the layout but is no speedup.
``--loss sig_mmd`` trains the
signature-MMD loss against a fixed sample of fBM reference paths (the
port's ``hurst_dataset``, one path an example of ``--seq`` points and
``--sig-channels`` channels, scaled by 1/√seq as the learned path is);
``--sig-channels`` and ``--sig-depth`` set the config's signature head.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import models as M
from ..checkpoint import Checkpointer, latest_step
from ..configs import get_config, reduce_config, with_sig_head
from ..data.pipeline import TokenStream, hurst_dataset
from ..device import resolve_device
from ..distributed import model_parallel as MP
from ..distributed import sharding_ctx
from ..optim import adafactor, adamw, linear_warmup_cosine
from ..optim.optimizers import named
from ..train import make_train_step, place_batch, replicate_tree
from .mesh import make_dev_mesh


def parse_mesh(spec: str) -> tuple[int, ...]:
    """``DxM`` -> (D, M)."""
    try:
        dims = tuple(int(x) for x in spec.lower().split("x"))
    except ValueError:
        dims = ()
    if len(dims) != 2 or min(dims) < 1:
        raise SystemExit(f"mesh {spec}: expected DATAxMODEL, e.g. 2x2")
    return dims


def build_mesh(dims: tuple[int, ...], device, backend: str = ""):
    """The ``("data", "model")`` mesh of ``--mesh DxM`` (None for 1x1);
    under torchrun (``WORLD_SIZE`` set) the process group is initialised
    here.  A world that does not hold D x M ranks is refused with the
    launch it needs."""
    if dims[0] * dims[1] == 1:
        return None
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend or (
            "nccl" if device.type == "cuda" else "gloo"))
    try:
        return make_dev_mesh(dims[0], dims[1], device=device)
    except ValueError as e:
        raise SystemExit(f"--mesh {dims[0]}x{dims[1]}: {e}") from None


def reference_paths(seed: int, batch: int, seq: int, channels: int,
                    device) -> torch.Tensor:
    """(batch, seq, channels) fBM paths (H ~ U(0.25, 0.75)) scaled by
    1/√seq, the sig-MMD loss's reference sample."""
    X, _ = hurst_dataset(seed, batch, seq - 1, channels)
    return torch.from_numpy(X / np.float32(np.sqrt(seq))).to(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="family-preserving reduced config")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--opt", default="adamw", choices=["adamw", "adafactor"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="dots",
                    choices=["dots", "full", "none"])
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--backend", default="",
                    help="process group under torchrun (default: nccl on "
                         "the card, gloo on the CPU)")
    ap.add_argument("--loss", default="lm", choices=["lm", "sig_mmd"])
    ap.add_argument("--sig-channels", type=int, default=8)
    ap.add_argument("--sig-depth", type=int, default=3)
    args = ap.parse_args(argv)

    dims = parse_mesh(args.mesh)
    if args.device is None and "LOCAL_RANK" in os.environ:
        args.device = f"cuda:{os.environ['LOCAL_RANK']}"
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    mesh = build_mesh(dims, dev, args.backend)
    # every rank runs the same loop; rank 0 prints and writes
    lead = mesh is None or dist.get_rank() == 0
    log = print if lead else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    if args.loss == "sig_mmd":
        cfg = with_sig_head(cfg, channels=args.sig_channels,
                            depth=args.sig_depth)
    log(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
        f"device={dev}, batch={args.batch}x{args.seq}, loss={args.loss}, "
        f"mesh={args.mesh}")

    opt = (adamw if args.opt == "adamw" else adafactor)(
        lr=linear_warmup_cosine(args.lr, max(1, args.steps // 10),
                                args.steps))
    params = M.init_params(args.seed, cfg, torch.float32, device=dev)
    if mesh is not None:
        replicate_tree(params, mesh)
        MP.shard_model(params, mesh)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, remat=args.remat,
                              microbatch=args.microbatch, loss=args.loss)

    ckpt = None
    start = 0
    if args.ckpt_dir:
        ckpt = Checkpointer(args.ckpt_dir)
        if args.resume and latest_step(args.ckpt_dir) is not None:
            start = latest_step(args.ckpt_dir)
            if mesh is not None:
                opt_state, _ = MP.restore_sharded(ckpt, params, opt_state,
                                                  start)
            else:
                tensors = named(params)
                restored, opt_state, _ = ckpt.restore(tensors, opt_state,
                                                      start)
                with torch.no_grad():
                    for k, t in restored.items():
                        tensors[k].copy_(t)
            log(f"[train] resumed from step {start}")

    def save(step):
        extra = {"data": stream.state()}
        if mesh is not None:
            MP.save_sharded(ckpt, params, opt_state, step, write=lead,
                            extra=extra)
        elif lead:
            ckpt.save(named(params), opt_state, step, extra=extra)

    stream = TokenStream(cfg.vocab_size, args.batch, args.seq, args.seed,
                         step=start, device=dev)
    paths = None if args.loss == "lm" else reference_paths(
        args.seed, args.batch, args.seq, args.sig_channels, dev)

    tokens_per_step = args.batch * args.seq
    m = {}
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        batch = next(stream)
        if paths is not None:
            batch["paths"] = paths
        if mesh is not None:
            with sharding_ctx(mesh):
                params, opt_state, m = step_fn(params, opt_state,
                                               place_batch(batch, mesh))
        else:
            params, opt_state, m = step_fn(params, opt_state, batch)
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        if step % args.log_every == 0 or step == args.steps - 1:
            log(f"  step {step:>5} loss {loss:.4f} "
                f"|g| {float(m['grad_norm']):.3f} "
                f"{tokens_per_step/dt:,.0f} tok/s")
        if ckpt and args.ckpt_every and step and \
                step % args.ckpt_every == 0:
            save(step)
    if ckpt:
        save(args.steps)
        ckpt.wait()
    log("[train] done")
    if mesh is not None:    # the full arrays, the same on every rank
        params = MP.gather_params(params)
    return params, m


if __name__ == "__main__":
    main()
