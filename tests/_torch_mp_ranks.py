"""Rank bodies of ``tests/test_torch_model_parallel.py``: gloo CPU worlds
running the port's model-parallel path on ``("data", "model")`` meshes.

Imported by the spawned ranks, so it imports ``torch`` and ``repro_torch``
only (never ``jax`` or ``repro``).  The parent passes the reference's
numpy parameters and batches in and gets numpy results back: losses,
metrics, the trained parameters gathered to the reference's full arrays,
and greedy tokens.  A world of 4 ranks runs the 2 x 2 mesh, a world of 2
the 1 x 2 mesh; each also runs a data-only mesh of all its ranks for the
MoE aux loss.
"""
from __future__ import annotations

import dataclasses
import os
import traceback

import numpy as np

ARCHS = ("qwen3-4b", "deepseek-v2-lite-16b", "zamba2-7b", "rwkv6-1.6b")
TRAIN = (4, 8, 3)        # batch, sequence, steps
AUX = (8, 8)             # the MoE-aux batch: 64 tokens > 4E = 16
MICRO = (8, 8, 2)        # batch, sequence, microbatches
DECODE = (2, 3, 3, 16)   # batch, prompt, new tokens, max_len
SIG = dict(channels=3, depth=2)
# SGD's learning rate: small enough that three steps of the reduced
# models stay well conditioned.  At 1e-2 zamba2's gradient norms of 40-85
# amplify a 2e-7 first-step difference (sharded or not) to 1.5e-5 in the
# embedding; rwkv6's reduced init has gradient norms of 80-110 (its ``u``
# bonus), where float32 noise of 2e-5 in the first step's gradient grows
# past the tolerance within three steps at 1e-3.
LR = 1e-3
LR_OF = {"rwkv6-1.6b": 1e-4}


def lr_of(key: str) -> float:
    return LR_OF.get(key.split("/")[0], LR)


def config(arch: str, configs):
    """The reduced config both packages run (``configs`` is either
    package's ``configs`` module): deepseek's dispatch groups of 8 tokens
    so that no group straddles two ranks, zamba2 with 4 groups over its 2
    shared blocks (the decode's shared-block row restore)."""
    cfg = configs.reduce_config(configs.get_config(arch))
    if arch == "deepseek-v2-lite-16b":
        cfg = dataclasses.replace(cfg, moe_group_size=8)
    if arch == "zamba2-7b":
        cfg = dataclasses.replace(cfg, n_layers=8)
    return cfg


def _t(b):
    import torch
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _model(inputs, key, cfg, mesh=None):
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.distributed.model_parallel import shard_model
    model = lm_params_from_reference(inputs["params"][key], cfg,
                                     device="cpu")
    return model if mesh is None else shard_model(model, mesh)


def _steps(model, cfg, batches, mesh, **kw) -> tuple[list, dict]:
    """Train steps on placed batches -> (metrics a step, full params)."""
    from repro_torch import optim, train
    from repro_torch.distributed import sharding_ctx
    from repro_torch.distributed.model_parallel import gather_params
    opt = optim.sgd(lr=lr_of(cfg.name))
    state = opt.init(model)
    step = train.make_train_step(cfg, opt, **kw)
    hist = []
    with sharding_ctx(mesh):
        for b in batches:
            model, state, m = step(model, state, train.place_batch(_t(b)))
            hist.append({k: float(v) for k, v in m.items()})
    return hist, {k: v.numpy() for k, v in gather_params(model).items()}


def train_cases(mesh, inputs: dict) -> dict:
    """Three LM steps of each arch on the mesh, laid out by the specs."""
    from repro_torch import configs
    out = {}
    for arch in ARCHS:
        cfg = config(arch, configs)
        out[f"train/{arch}"] = _steps(_model(inputs, arch, cfg, mesh), cfg,
                                      inputs["batches"][arch], mesh)
    return out


def decode_cases(mesh, inputs: dict) -> dict:
    """Greedy tokens of each arch through ``ServeEngine`` on the sharded
    model, its cache placed by ``cache_specs``."""
    import torch
    from repro_torch import configs
    from repro_torch.distributed import sharding_ctx
    from repro_torch.serve import ServeEngine
    out = {}
    n_new, max_len = DECODE[2], DECODE[3]
    for arch in ARCHS:
        cfg = config(arch, configs)
        model = _model(inputs, arch, cfg, mesh)
        with sharding_ctx(mesh):
            toks = ServeEngine(cfg, model, max_len=max_len,
                               device="cpu").generate(
                torch.from_numpy(inputs["prompts"][arch]), n_new)
        out[f"decode/{arch}"] = toks.numpy()
    return out


def sig_mmd_case(mesh, inputs: dict) -> dict:
    """Three sig-MMD steps of qwen3-4b with its signature head."""
    from repro_torch import configs
    cfg = configs.with_sig_head(config("qwen3-4b", configs), **SIG)
    return {"sig_mmd": _steps(_model(inputs, "qwen3-4b/sig", cfg, mesh),
                              cfg, inputs["batches"]["sig_mmd"], mesh,
                              loss="sig_mmd")}


def micro_case(mesh, inputs: dict) -> dict:
    """``microbatch=2`` of a placed batch (qwen3-4b, LM loss)."""
    from repro_torch import configs
    cfg = config("qwen3-4b", configs)
    return {"microbatch": _steps(_model(inputs, "qwen3-4b", cfg, mesh), cfg,
                                 inputs["batches"]["micro"], mesh,
                                 microbatch=MICRO[2])}


def moe_aux_cases(dp, inputs: dict) -> dict:
    """One deepseek step of each loss on a data-only mesh of every rank
    (parameters replicated): the loss and the aux loss of the global
    batch."""
    from repro_torch import configs
    out = {}
    for loss in ("lm", "sig_mmd"):
        cfg = configs.with_sig_head(config("deepseek-v2-lite-16b", configs),
                                    **SIG)
        model = _model(inputs, "deepseek-v2-lite-16b/sig", cfg)
        out[f"moe_aux/{loss}"] = _steps(model, cfg,
                                        inputs["batches"][f"aux/{loss}"], dp,
                                        loss=loss)
    return out


def donation_case(mesh, inputs: dict) -> dict:
    """A sharded decode step and a sharded train step update their
    buffers in place (``hlo.donation_stats``)."""
    import torch
    from repro_torch import configs, optim, train
    from repro_torch import models as M
    from repro_torch.distributed import sharding_ctx
    from repro_torch.distributed.hlo import (assert_donation, buffer_ptrs,
                                             donation_stats)
    cfg = config("qwen3-4b", configs)
    model = _model(inputs, "qwen3-4b", cfg, mesh)
    with sharding_ctx(mesh):
        cache = M.init_cache(cfg, 2, 8, torch.float32, device="cpu")
        before = buffer_ptrs((model, cache))
        _, cache = M.decode_step(model, cfg, torch.ones((2, 1), dtype=
                                                        torch.int32), cache)
        dec = donation_stats(before, (model, cache))
        assert_donation(before, (model, cache), min_aliased=len(before))
        opt = optim.sgd(lr=LR)
        state = opt.init(model)
        before = buffer_ptrs((model, state))
        step = train.make_train_step(cfg, opt)
        step(model, state, train.place_batch(_t(inputs["batches"][
            "qwen3-4b"][0])))
        tr = donation_stats(before, (model, state))
    return {"donation": dict(decode=(dec.n_aliased, len(buffer_ptrs(
        (model, cache)))), train=(tr.n_aliased, len(before)),
        cache_heads=tuple(cache["layers"]["k"].shape))}


def launcher_case(ckpt_dir: str) -> dict:
    """``launch.train --mesh 2x2`` with a checkpoint, then a resume."""
    import json
    import torch.distributed as dist
    from repro_torch.launch import train as train_cli
    args = ["--arch", "qwen3-4b", "--reduced", "--device", "cpu", "--batch",
            "4", "--seq", "8", "--log-every", "1", "--mesh", "2x2",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "0"]
    params, m = train_cli.main(args + ["--steps", "2"])
    shapes = None
    if dist.get_rank() == 0:
        with open(os.path.join(ckpt_dir, "step_2", "manifest.json")) as f:
            shapes = json.load(f)["shapes"]
    dist.barrier()
    params3, m3 = train_cli.main(args + ["--steps", "3", "--resume"])
    return {"launcher": dict(
        loss=(float(m["loss"]), float(m3["loss"])),
        shapes=shapes, full={k: tuple(v.shape) for k, v in params.items()},
        checksum=float(sum(v.double().sum() for v in params3.values())))}


def rank_main(rank: int, world: int, store_path: str, inputs: dict,
              dirs: dict, queue) -> None:
    """One rank of a gloo world: every case, results on ``queue``.  An
    exception goes to the queue as its traceback (the parent fails)."""
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        os.environ.setdefault("PATHSIG_AUTOTUNE", "off")
        dist.init_process_group("gloo", store=dist.FileStore(
            store_path, world), rank=rank, world_size=world)
        from repro_torch.launch.mesh import make_dev_mesh
        mesh = make_dev_mesh(2, 2, device="cpu") if world == 4 else \
            make_dev_mesh(1, 2, device="cpu")
        out = {}
        out.update(train_cases(mesh, inputs))
        out.update(decode_cases(mesh, inputs))
        if world == 4:
            out.update(sig_mmd_case(mesh, inputs))
            out.update(micro_case(mesh, inputs))
            out.update(donation_case(mesh, inputs))
            out.update(launcher_case(dirs["ckpt"]))
        out.update(moe_aux_cases(make_dev_mesh(world, 1, device="cpu"),
                                 inputs))
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
        raise
