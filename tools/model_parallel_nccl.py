"""The model-parallel slice across four cards: one NCCL rank a card on a
2 x 2 ("data", "model") mesh, each case against rank 0 alone with the
whole model on its card.

    PYTHONPATH=src python tools/model_parallel_nccl.py [--out FILE]

Needs four CUDA cards.  Builds the kernels once (``chip_smoke.
phase_build``), then spawns four ranks that run ``chip_smoke.py`` phase
27's cases over NCCL instead of gloo: (a) qwen3-4b's sig-MMD train_loop
at full width, depth 2 (the Gram ring's send/recv over NCCL, FSDP
gathers and reduce-scatters), (c) one SGD step of deepseek-v2-lite-16b,
zamba2-7b and rwkv6-1.6b at depth 2, and (b) qwen3-4b as published
served on the 2 x 2 mesh (FSDP gathers every decode step).  Prints each
case and writes the results as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
WORLD = 4


def rank_main(rank: int, port: int, queue) -> None:
    from datetime import timedelta
    import torch
    import chip_smoke as cs
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_dev_mesh
    os.environ["PATHSIG_AUTOTUNE"] = "off"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=WORLD, timeout=timedelta(seconds=cs.DIST_COLLECTIVE_S))
    mesh = make_dev_mesh(2, 2)
    res, seconds = dict(rank=rank), {}
    parts = [("train", lambda: cs.mp_qwen_train(rank, mesh, 0))]
    parts += [(f"train/{a}", lambda a=a: cs.mp_family_train(rank, mesh, 0,
                                                            a))
              for a in cs.MP_FAMILIES]
    parts += [("serve", lambda: cs.mp_decode(
        rank, mesh, 0, cs.get_config(cs.LM_ARCH), cs.MP_SERVE))]
    for name, fn in parts:
        t0 = time.perf_counter()
        res[name] = fn()
        seconds[name] = time.perf_counter() - t0
    res["seconds"] = seconds
    res["transports"] = dict(C.LOG.transports)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    queue.put(res)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    if torch.cuda.device_count() < WORLD:
        raise SystemExit(f"needs {WORLD} CUDA cards, found "
                         f"{torch.cuda.device_count()}")
    os.environ["PATHSIG_AUTOTUNE"] = "off"
    smi = cs.phase_device()
    cs.phase_build()
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = cs.free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=rank_main, args=(r, port, q))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            r = q.get(timeout=cs.DIST_WORLD_S * 2)
            got[r["rank"]] = r
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    cs.check([p.exitcode for p in procs] == [0] * WORLD,
             f"exit codes {[p.exitcode for p in procs]}")
    r0 = got[0]
    t = r0["train"]
    print(f"[nccl] 2 x 2 sig-MMD train_loop qwen3-4b depth {t['layers']}: "
          f"losses {t['losses']} against one rank's {t['single_losses']}; "
          f"first-step gradients max |err| {t['grad_max_abs_err']:.2e}; step "
          f"{t['step_ms']:.1f} ms (one rank alone {t['single_step_ms']:.1f}"
          f" ms); launches a rank {t['launches_per_rank']}")
    print(f"[nccl] backbone forward collectives {t['collectives']}")
    for a in cs.MP_FAMILIES:
        f = r0[f"train/{a}"]
        print(f"[nccl] {f['case']}: loss {f['loss']:.6f} (one rank "
              f"{f['single_loss']:.6f}), |g| {f['grad_norm']:.4f} (one rank "
              f"{f['single_grad_norm']:.4f}); {f['ms']:.1f} ms (one rank "
              f"alone {f['single_ms']:.1f} ms)")
    d = r0["serve"]
    print(f"[nccl] 2 x 2 {d['case']} {d['shape']}: tokens equal one rank's; "
          f"{d['ms_per_step']:.1f} ms a decode step (one rank alone "
          f"{d['single_ms_per_step']:.1f} ms)")
    print(f"[nccl] transports {r0['transports']}; seconds {r0['seconds']}; "
          f"world {time.perf_counter() - t0:.1f} s")
    print(smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(device=smi, ranks=got),
                                             indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
