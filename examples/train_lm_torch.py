"""End-to-end LM training with checkpoint/restart on the
PyTorch/CUDA port.

The port of ``examples/train_lm.py``: the same presets, config build,
AdamW + warmup-cosine schedule and checkpoint-every-10 run with a
simulated preemption and a restart from the latest checkpoint.  After the
restart it runs the same steps once more without the interruption and
prints both runs' losses side by side: the resumed steps must give the
uninterrupted run's losses, and the run fails when they do not.

Run:  PYTHONPATH=src python examples/train_lm_torch.py          # ~4M params
      PYTHONPATH=src python examples/train_lm_torch.py --preset 100m \\
          --steps 300
      (add --device cpu to run on the CPU)
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil

import torch

import repro_torch.models as M
from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.configs import get_config, reduce_config
from repro_torch.data.pipeline import TokenStream
from repro_torch.device import resolve_device
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.optim.optimizers import named
from repro_torch.train import TrainLoopConfig, make_train_step, train_loop

PRESETS = {
    # name: (d_model, n_layers, n_heads, n_kv, d_ff, vocab, batch, seq)
    "nano": (256, 4, 8, 4, 768, 2048, 4, 128),       # ~4M params, CPU-fast
    "100m": (768, 12, 12, 4, 2304, 16384, 8, 512),   # ~100M params
}


def build_cfg(preset: str):
    d, L, H, KV, FF, V, B, S = PRESETS[preset]
    base = reduce_config(get_config("qwen3-4b"))     # GQA + qk_norm family
    cfg = dataclasses.replace(base, name=f"lm-{preset}", n_layers=L,
                              d_model=d, n_heads=H, n_kv_heads=KV, d_ff=FF,
                              vocab_size=V, head_dim=d // H)
    return cfg, B, S


def main(argv=None) -> None:
    # The embedding's gradient is an accumulating index_put_, whose CPU
    # threads add in a varying order: two runs part by an ulp within a few
    # steps.  Deterministic algorithms make every run bit-reproducible,
    # which the resume check needs; the caller's setting comes back after.
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        run(argv)
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def run(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="nano", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ckpt-dir", default="runs/train_lm_ckpt")
    ap.add_argument("--no-restart-demo", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, B, S = build_cfg(args.preset)
    print(f"model: {cfg.name}  params={cfg.param_count()/1e6:.1f}M  "
          f"batch={B}x{S}")
    params = M.init_params(0, cfg, torch.float32, device=dev)
    opt = adamw(lr=linear_warmup_cosine(3e-4, args.steps // 10, args.steps))
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    ckpt = Checkpointer(args.ckpt_dir, keep=2)

    def stream():
        return TokenStream(cfg.vocab_size, B, S, seed=0, device=dev)

    def log(step, m):
        print(f"  step {m['step']:>4}  loss {m['loss']:.4f}  "
              f"|g| {m['grad_norm']:.3f}  {m['sec']*1e3:.0f} ms")

    half = args.steps // 2
    print(f"\nphase 1: train to step {half}, checkpoint every 10")
    loop1 = TrainLoopConfig(steps=half, log_every=10, ckpt_every=10,
                            ckpt_dir=args.ckpt_dir)
    _, _, hist1 = train_loop(cfg, params, opt, iter(stream()), loop1,
                             checkpointer=ckpt, on_metrics=log)
    ckpt.wait()

    if not args.no_restart_demo:
        print(f"\nphase 2: simulate preemption -> restart from latest "
              f"checkpoint (step {latest_step(args.ckpt_dir)})")
        # fresh process state: rebuild params/opt shapes, restore from disk
        params2 = M.init_params(1, cfg, torch.float32, device=dev)
        opt_state2 = opt.init(params2)
        step0 = latest_step(args.ckpt_dir)
        tensors = named(params2)
        restored, opt_state2, _ = ckpt.restore(tensors, opt_state2, step0)
        with torch.no_grad():
            for k, t in restored.items():
                tensors[k].copy_(t)
        stream2 = stream()
        stream2.restore({"step": step0, "seed": 0})   # resume the data
        step_fn = make_train_step(cfg, opt)
        resumed = {}
        for step in range(step0, args.steps):
            _, opt_state2, m = step_fn(params2, opt_state2, next(stream2))
            resumed[step] = float(m["loss"])
            if step % 10 == 0 or step == args.steps - 1:
                print(f"  step {step:>4}  loss {resumed[step]:.4f}")
        final_loss = resumed[args.steps - 1]

        print(f"\nphase 3: the same {args.steps} steps uninterrupted, "
              f"from the same initial parameters")
        loop3 = TrainLoopConfig(steps=args.steps, log_every=1, run_dir="")
        _, _, hist3 = train_loop(cfg, params, opt, iter(stream()), loop3)
        whole = {m["step"]: m["loss"] for m in hist3}
        for step in resumed:
            if step % 10 == 0 or step == args.steps - 1:
                print(f"  step {step:>4}  resumed {resumed[step]:.6f}  "
                      f"uninterrupted {whole[step]:.6f}")
        same = all(resumed[s] == whole[s] for s in resumed)
        print(f"resumed losses equal the uninterrupted run's: {same}")
        if not same:
            first = next(s for s in resumed if resumed[s] != whole[s])
            raise SystemExit(f"the resumed run parted from the uninterrupted "
                             f"one at step {first}: {resumed[first]!r} vs "
                             f"{whole[first]!r}")
    else:
        final_loss = hist1[-1]["loss"]

    first_loss = hist1[0]["loss"]
    print(f"\nloss {first_loss:.3f} -> {final_loss:.3f} "
          f"({'improved' if final_loss < first_loss else 'NO IMPROVEMENT'})")
    ckpt.wait()


if __name__ == "__main__":
    main()
