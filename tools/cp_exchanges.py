"""Exchanges by tag of ``chip_smoke.py`` phase 28 (j)'s layouts, counted on
the CPU at reduced width.

Context parallelism, ``{"seq": ("data", "model"), "batch": ("pod",)}``,
on a 2 x 2 mesh of four gloo ranks: the sig-MMD Adafactor step of qwen3-4b
with a signature head at depth 2 under that layout plus heads, kv_heads and
``ff`` over the model axis (FSDP over the data axis), then the prefills of
qwen3-4b (the layout alone, 6 layers), zamba2-7b, rwkv6-1.6b and
whisper-large-v3 (with the heads and ``ff`` split, 2 layers each stack) and
deepseek-v2-lite-16b (the layout alone with its MoE rules, 2 layers).  The
configs are the reduced ones at those depths; how many collectives a step
or a forward makes at each site depends on the layers and the remat, not on
the widths, so the counts are the card's at full width.  Prints rank 0's
count of every ``sp_*``, ``tp_param_gather`` and ``moe_aux`` collective by
case, and whether every rank made the same.

    PYTHONPATH=src python tools/cp_exchanges.py
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CP = {"seq": ("data", "model"), "batch": ("pod",)}
TP = {"heads": "model", "kv_heads": "model", "ff": "model", "fsdp": "data"}
# (arch, rule override, layers a stack) of each prefill
PREFILLS = (("qwen3-4b", CP, 6), ("zamba2-7b", dict(CP, **TP), 2),
            ("rwkv6-1.6b", dict(CP, **TP), 2),
            ("whisper-large-v3", dict(CP, **TP), 2),
            ("deepseek-v2-lite-16b", CP, 2))
SITES = ("sp_", "tp_param", "moe_aux")


def _counts(records) -> dict:
    from repro_torch.launch.dryrun import collectives_by_tag
    return {t: sum(v["count"] for v in kinds.values())
            for t, kinds in sorted(collectives_by_tag(records).items())
            if t.startswith(SITES)}


def _rank(rank: int, path: str, queue) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(path, 4),
                            rank=rank, world_size=4)
    from repro_torch import configs, optim, train
    from repro_torch import models as M
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import model_parallel as MP
    from repro_torch.distributed import sharding_ctx
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models.sig_head import init_sig_head
    from repro_torch.serve.engine import make_prefill_step
    mesh = make_dev_mesh(2, 2, device="cpu")
    MP.axes_split(mesh, ("data", "model"))      # every rank together
    out = {}
    specs.SHAPES["cp_train"] = dict(kind="train", seq=16, batch=8)
    cfg = configs.with_sig_head(dataclasses.replace(
        configs.reduce_config(configs.get_config("qwen3-4b")), n_layers=2),
        channels=3, depth=2)
    model = M.init_params(0, cfg, device="cpu")
    model["sig_head"] = init_sig_head(1, cfg, 4, device="cpu")
    rules = rules_for("qwen3-4b", "cp_train", dict(CP, **TP))
    MP.shard_model(model, mesh, rules)
    g = torch.Generator().manual_seed(0)
    batch = dict(next(TokenStream(cfg.vocab_size, 8, 16, 0, device="cpu")),
                 paths=torch.cumsum(torch.randn(8, 16, 3, generator=g), 1))
    opt = optim.adafactor(lr=1e-3)
    with sharding_ctx(mesh, rules):
        placed = train.place_batch(batch)
        C.LOG.reset()
        train.make_train_step(cfg, opt, loss="sig_mmd")(
            model, opt.init(model), placed)
        out["train/qwen3-4b"] = _counts(C.LOG.records)
    for arch, over, L in PREFILLS:
        c = configs.reduce_config(configs.get_config(arch))
        c = dataclasses.replace(c, n_layers=L, **(
            {"n_encoder_layers": L} if c.family == "encdec" else {}))
        rules = rules_for(arch, "prefill_32k", over)
        m = MP.shard_model(M.init_params(0, c, device="cpu"), mesh, rules)
        b = {"tokens": torch.randint(1, c.vocab_size, (2, 16), generator=g,
                                     dtype=torch.int32)}
        if c.family == "encdec":
            b["frames"] = torch.randn(2, c.n_audio_frames, c.d_model,
                                      generator=g)
        with sharding_ctx(mesh, rules):
            placed = train.place_batch(b)
            C.LOG.reset()
            make_prefill_step(c)(m, placed)
            out[f"prefill/{arch}"] = _counts(C.LOG.records)
    queue.put((rank, out))
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank, args=(r, path, queue))
                 for r in range(4)]
        for p in procs:
            p.start()
        got = dict(queue.get(timeout=600) for _ in procs)
        for p in procs:
            p.join()
    for case, counts in got[0].items():
        print(case, json.dumps(counts))
    print("every rank the same:", all(got[r] == got[0] for r in range(4)))


if __name__ == "__main__":
    main()
