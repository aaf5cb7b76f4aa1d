"""Batched serving example on the PyTorch/CUDA port: KV-cache decode across
architecture families.

The port of ``examples/serve_lm.py``.  Serves three reduced architectures —
a GQA transformer (qwen3 family), an attention-free RWKV6, and the hybrid
Mamba2+shared-attention zamba2 — with the same ServeEngine, demonstrating
that the cache abstraction covers KV caches, recurrent states, and mixed
state types.  Sampling draws from a seeded ``torch.Generator``, so the
sampled tokens are reproducible but not the reference's (which draws
through ``jax.random``).

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

Variable-length signature traffic is served by a different layer: see
examples/ragged_serving_torch.py for the `repro_torch.serve.DynamicBatcher`
demo (length-bucketed micro-batching over `repro_torch.ragged` containers).
"""
from __future__ import annotations

import argparse
import time

import torch

import repro_torch.models as M
from repro_torch.configs import get_config, reduce_config
from repro_torch.device import resolve_device
from repro_torch.serve import ServeEngine

ARCHS = ("qwen3-4b", "rwkv6-1.6b", "zamba2-7b")


def demo(arch: str, dev: torch.device, n_new: int = 24) -> None:
    cfg = reduce_config(get_config(arch))
    params = M.init_params(0, cfg, torch.float32, device=dev)
    engine = ServeEngine(cfg, params, max_len=64, temperature=0.8,
                         device=dev)
    prompts = torch.tensor(
        [[1, 5, 9, 2], [3, 3, 7, 1], [2, 8, 4, 6], [9, 1, 1, 5]],
        dtype=torch.int32, device=dev)
    rng = torch.Generator(device=dev)
    rng.manual_seed(42)
    t0 = time.perf_counter()
    out = engine.generate(prompts, n_new, generator=rng).cpu()
    dt = time.perf_counter() - t0
    toks = out.shape[0] * n_new
    print(f"{arch:<22} family={cfg.family:<8} batch={out.shape[0]} "
          f"generated={n_new}/seq  {toks/dt:7.1f} tok/s")
    print(f"   sample: {out[0].tolist()}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    for arch in ARCHS:
        demo(arch, dev)
    print("\nserve OK (reduced configs; production decode is the same "
          "serve_step the decode_32k/long_500k dry-run cells lower)")


if __name__ == "__main__":
    main()
