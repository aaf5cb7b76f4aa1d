"""Serving launcher: batched decode against a KV cache on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --reduced --batch 4 --steps 32 [--device cpu]

``--device`` defaults to the CUDA card; ``--ckpt-dir`` restores the
parameters of the newest training checkpoint there (the optimizer state
saved beside them is read and dropped).
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import models as M
from ..checkpoint import Checkpointer, latest_step
from ..configs import get_config, reduce_config
from ..device import resolve_device
from ..optim import adafactor, adamw, sgd
from ..optim.optimizers import named
from ..serve import ServeEngine


def restore_params(ckpt_dir: str, params) -> int:
    """Copy the newest checkpoint's parameters into ``params`` in place and
    return its step.  The checkpoint holds an optimizer state too, whose
    layout depends on the optimizer that trained it: each optimizer's
    template is tried until one matches the saved arrays."""
    ck = Checkpointer(ckpt_dir)
    step = latest_step(ckpt_dir)
    tensors = named(params)
    for make in (adamw, adafactor, sgd):
        try:
            restored, _, _ = ck.restore(tensors, make().init(params), step)
        except ValueError:
            continue
        with torch.no_grad():
            for k, t in restored.items():
                tensors[k].copy_(t)
        return step
    raise ValueError(f"the checkpoint at {ckpt_dir} step {step} matches no "
                     f"optimizer state of these parameters")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--steps", type=int, default=32,
                    help="new tokens per sequence")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--ckpt-dir", default="",
                    help="restore params from a training checkpoint")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    params = M.init_params(args.seed, cfg, torch.float32, device=dev)
    if args.ckpt_dir:
        step = restore_params(args.ckpt_dir, params)
        print(f"[serve] restored params from step {step}")

    print(f"[serve] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"family={cfg.family}, batch={args.batch}, device={dev}")
    engine = ServeEngine(cfg, params, max_len=args.max_len,
                         temperature=args.temperature, seed=args.seed,
                         device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    prompts = torch.randint(1, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=g, device=dev, dtype=torch.int32)

    t0 = time.perf_counter()
    out = engine.generate(prompts, args.steps).cpu()
    dt = time.perf_counter() - t0
    total_new = args.batch * args.steps
    print(f"[serve] {total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s incl. prefill)")
    for b in range(min(2, args.batch)):
        print(f"  seq{b}: {out[b].tolist()}")
    return out


if __name__ == "__main__":
    main()
