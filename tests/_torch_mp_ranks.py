"""Rank bodies of ``tests/test_torch_model_parallel.py``: gloo CPU worlds
running the port's model-parallel path on ``("data", "model")`` meshes.

Imported by the spawned ranks, so it imports ``torch`` and ``repro_torch``
only (never ``jax`` or ``repro``).  The parent passes the reference's
numpy parameters and batches in and gets numpy results back: losses,
metrics, the trained parameters gathered to the reference's full arrays,
and greedy tokens.  A world of 4 ranks runs the 2 x 2 mesh, a world of 2
the 1 x 2 mesh; each also runs a data-only mesh of all its ranks for the
MoE aux loss (the world of 2 also microbatched sig-MMD and MoE-aux steps
there).  The world of 4 also trains with Adafactor on the sharded
parameters and records what the dry run predicts for its cells: the
parameter and optimizer-state bytes a rank holds and the collectives of
one step.  Both worlds prefill six archs under their ``prefill_32k``
cells' rules (the prompt in blocks over the model axis), and the world of
2 records what the dry run predicts for a small prefill cell.  The world
of 4 also trains under the train cells' rules (each sequence in blocks
over the model axis): four archs, a sig-MMD step, a masked and strided
one, a batch whose ignored labels fill one block, and an eval step.
Both worlds run Megatron sequence parallelism (``sp_tp_cases``): reduced
deepseek-v2-lite-16b, phi3.5-moe-42b-a6.6b and qwen3-4b with their heads,
``ff`` and experts over the model axis that cuts each sequence, and the
hybrid, rwkv and encdec families (zamba2-7b, rwkv6-1.6b,
whisper-large-v3) with their heads and ``ff`` over it.  Both
worlds train reduced phi3.5-moe in dispatch groups that straddle data
ranks on their data-only mesh, and the world of 4 on 2 x 2, where it
also decodes 24 requests in one group a step (``STRADDLE_*``).  The
world of 4 also runs context parallelism (``cp_cases``): each sequence
in blocks over both axes of the 2 x 2 mesh, the batch whole, qwen3-4b
and deepseek prefilled and trained, the hybrid, rwkv and encdec families
prefilled, with their vocabulary and split layers over the model axis.
"""
from __future__ import annotations

import dataclasses
import os
import traceback

import numpy as np

ARCHS = ("qwen3-4b", "deepseek-v2-lite-16b", "zamba2-7b", "rwkv6-1.6b",
         "whisper-large-v3")
ADAFACTOR_ARCHS = ("qwen3-4b", "deepseek-v2-lite-16b", "whisper-large-v3")
# Adafactor's factoring threshold in the sharded cases: the reduced
# widths (64, 96, 128) are all under the default 128, so 32 factors the
# 2-D weights and the experts, their averaged dimensions sharded
ADAFACTOR = dict(lr=1e-3, min_dim_factored=32)
# the dry run's cells held against this world: a reduced arch's train step
# under the cell's rules (rules_for of the published arch and this shape)
DRYRUN_SHAPE = ("train_tiny", dict(kind="train", seq=8, batch=8))
DRYRUN_ARCHS = ("qwen3-4b", "deepseek-v2-lite-16b")
# {cell: (arch, rule override)}: DRYRUN_ARCHS' cells, and deepseek's under
# the "seq" override (MLA's heads and the experts over the model axis
# that cuts each sequence)
DRYRUN_CELLS = {**{a: (a, None) for a in DRYRUN_ARCHS},
                "deepseek-v2-lite-16b/sp_tp": ("deepseek-v2-lite-16b",
                                               {"seq": "model"})}
TRAIN = (4, 8, 3)        # batch, sequence, steps
AUX = (8, 8)             # the MoE-aux batch: 64 tokens > 4E = 16
MICRO = (8, 8, 2)        # batch, sequence, microbatches
DECODE = (2, 3, 3, 16)   # batch, prompt, new tokens, max_len
# the decode cells' layout (rules_for(arch, "decode_32k")): the cache's
# sequence in blocks of 8 over the model axis, which the prompt and the
# new tokens cross, the batch over the data axis of the 2 x 2 mesh
CP_DECODE = (2, 6, 6, 16)
CP_SHAPE = "decode_32k"
# reduced qwen3-4b under the long-context override: the sequence over
# both axes (blocks of 4), the batch whole
CP_OVERRIDE = {"kv_seq": ("data", "model"), "batch": ("pod",)}
# writes of S > 1 rows on the 2 x 2 mesh under rules_for (blocks of 8):
# 10 rows (more than a block, across its end), 3, then 5 at index 13,
# clamped to rows 11-15 as lax.dynamic_update_slice clamps
CP_WRITES = (10, 3, 5)
# the prefill cells' layout (rules_for(arch, "prefill_32k")): the
# requests over the data axis, the prompt in blocks of 4 over the model
# axis; a prompt of 7 is left whole by the divisibility guard.  The two
# dense archs that the other cases do not run have references of their
# own (M-RoPE embeds and positions; tied embeddings).
PREFILL_ARCHS = ("qwen3-4b", "qwen2-vl-2b", "command-r-35b", "zamba2-7b",
                 "rwkv6-1.6b", "whisper-large-v3")
PREFILL = (2, 8)         # requests, prompt
PREFILL_ODD = 7
PREFILL_SHAPE = "prefill_32k"
# the small prefill cells the dry run predicts on AbstractMesh((1, 2))
DRYRUN_PREFILL = ("prefill_tiny", dict(kind="prefill", seq=PREFILL[1],
                                       batch=PREFILL[0]))
DRYRUN_PREFILL_ARCHS = ("qwen3-4b", "zamba2-7b")
SIG = dict(channels=3, depth=2)
# MoE dispatch groups that straddle data ranks: reduced phi3.5-moe (E = 4,
# top-2) at capacity factor 0.5.  Training in groups of 16: (8, 6) is 48
# tokens, 3 groups of C = 4 (on 2 data ranks group [16, 32) straddles,
# on 4 every group does); (7, 6), rows the data ranks do not divide, is
# 42 tokens in groups of 14 (C = 3).  Decode keeps the config's group
# size: STRADDLE_DECODE's 24 requests are one group of 24 a step (C = 6),
# 12 tokens a data rank on the 2 x 2 mesh under rules_for(arch, CP_SHAPE)
STRADDLE_ARCH = "phi3.5-moe-42b-a6.6b"
STRADDLE_GROUP = 16
STRADDLE_CF = 0.5
STRADDLE_TRAIN = (8, 6, 3)     # batch, sequence, steps
STRADDLE_PAD = (7, 6, 3)
STRADDLE_DECODE = (24, 4, 4, 16)   # requests, prompt, new tokens, max_len
# Megatron sequence parallelism (the model axis both cuts each sequence and
# splits the layers): the MoE archs under rules_for(arch, shape, SP_TP's
# override) (heads, ff and experts over the model axis, FSDP over the data
# axis), qwen3-4b with its heads and ff over the model axis too (FSDP over
# the data axis, so that wq and wo split on head boundaries); prefill, LM
# and sig-MMD steps, the MoE aux loss at AUX and SEQ_ODD's sequence of 7,
# which the split leaves whole
SP_TP_ARCHS = ("deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b", "qwen3-4b")
# the hybrid, rwkv and encdec families under SP_TP + SP_TP_DENSE: the
# prefill and the LM steps (a sig-MMD head is not family-specific)
SP_TP_FAMILIES = ("zamba2-7b", "rwkv6-1.6b", "whisper-large-v3")
SP_TP = {"seq": "model"}
SP_TP_DENSE = {"heads": "model", "kv_heads": "model", "ff": "model",
               "fsdp": "data"}
# context parallelism, the reference's long_500k layout for a prompt or a
# training sequence: each sequence in blocks over both axes of the 2 x 2
# mesh (blocks of 2 of PREFILL's and TRAIN's 8), the batch whole on every
# rank.  CP_STEPS prefill and train (three LM steps) under rules_for(arch,
# shape, CP), qwen3-4b also with SP_TP_DENSE (its heads and ff over the
# model axis inside the sequence's group; alone only its vocabulary is
# split there), deepseek with its MoE rules (MLA's heads and the experts
# over the model axis, capacity-bound groups of 8); CP_FAMILIES prefill
# under CP + SP_TP_DENSE
CP = {"seq": ("data", "model"), "batch": ("pod",)}
CP_STEPS = (("qwen3-4b", False), ("qwen3-4b", True),
            ("deepseek-v2-lite-16b", False))
CP_FAMILIES = ("zamba2-7b", "rwkv6-1.6b", "whisper-large-v3")
# training under rules_for(arch, DRYRUN_SHAPE's cell): the rows over the
# data axis, each sequence in blocks of 4 over the model axis (TRAIN's
# batches); the masked sig-MMD case's sequences of 6 in blocks of 3, whose
# second block starts off SEQ_STRIDE
SEQ_ARCHS = ("qwen3-4b", "zamba2-7b", "rwkv6-1.6b", "whisper-large-v3")
SEQ_MASKED = (4, 6)      # batch, sequence
SEQ_STRIDE = 2
# a sequence the model axis does not divide stays whole (the divisibility
# guard): the model ranks then run the same rows, which FSDP over both
# axes must not count twice
SEQ_ODD = (4, 7)
# SGD's learning rate: small enough that three steps of the reduced
# models stay well conditioned.  At 1e-2 zamba2's gradient norms of 40-85
# amplify a 2e-7 first-step difference (sharded or not) to 1.5e-5 in the
# embedding.  rwkv6 trains at 1e-4 in float32: its reduced init has
# gradient norms of ~83, and float32's own spread of its first-step
# gradient (2.3e-5 relative: the reference in float32 against itself in
# float64, ``tools/rwkv_drift.py --grads``) carries its embedding to 2.2x
# the tolerance band in three steps at 1e-3 (the port against the
# reference 2.8x), so no float32 run of either package holds that band
# there.  At the shared 1e-3 it trains in float64 (RWKV64_LR), where the
# port holds the reference's tolerance.
LR = 1e-3
LR_OF = {"rwkv6-1.6b": 1e-4}
RWKV64_LR = LR


def lr_of(key: str) -> float:
    return LR_OF.get(key.split("/")[0], LR)


def config(arch: str, configs):
    """The reduced config both packages run (``configs`` is either
    package's ``configs`` module): the MoE archs' dispatch groups of 8
    tokens so that no group straddles two ranks, zamba2 with 4 groups
    over its 2 shared blocks (the decode's shared-block row restore),
    whisper with 16 decoder positions (CP_DECODE crosses their blocks of
    8)."""
    cfg = configs.reduce_config(configs.get_config(arch))
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe_group_size=8)
    if arch == "zamba2-7b":
        cfg = dataclasses.replace(cfg, n_layers=8)
    if arch == "whisper-large-v3":
        cfg = dataclasses.replace(cfg, decoder_max_len=16)
    return cfg


def straddle_config(configs, decode: bool = False):
    """The reduced phi3.5-moe of the straddling cases: capacity factor
    STRADDLE_CF, dispatch groups of STRADDLE_GROUP tokens (decode: the
    config's own)."""
    cfg = dataclasses.replace(
        configs.reduce_config(configs.get_config(STRADDLE_ARCH)),
        capacity_factor=STRADDLE_CF)
    return cfg if decode else dataclasses.replace(
        cfg, moe_group_size=STRADDLE_GROUP)


def _t(b):
    import torch
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _model(inputs, key, cfg, mesh=None, rules=None):
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.distributed.model_parallel import shard_model
    model = lm_params_from_reference(inputs["params"][key], cfg,
                                     device="cpu")
    return model if mesh is None else shard_model(model, mesh, rules)


def _steps(model, cfg, batches, mesh, opt=None, rules=None,
           **kw) -> tuple[list, dict]:
    """Train steps on batches placed under ``rules`` -> (metrics a step,
    full params)."""
    from repro_torch import optim, train
    from repro_torch.distributed import sharding_ctx
    from repro_torch.distributed.model_parallel import gather_params
    opt = optim.sgd(lr=lr_of(cfg.name)) if opt is None else opt
    state = opt.init(model)
    step = train.make_train_step(cfg, opt, **kw)
    hist = []
    with sharding_ctx(mesh, rules):
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


def greedy_logits(model, cfg, prompts, n_new: int, max_len: int,
                  enc_out=None):
    """Greedy decode through ``decode_step`` (whisper's cross K/V
    prefilled from ``enc_out``) -> (tokens (B, P + n_new), the whole
    batch's float32 logits a step (steps, B, V)), both gathered over the
    batch axes under a sharding context."""
    import torch
    from repro_torch import models as M
    from repro_torch.distributed.model_parallel import gather_decode_rows
    B, P = prompts.shape
    cache = M.init_cache(cfg, B, max_len, torch.float32, device="cpu")
    if enc_out is not None:
        cache = M.encdec.prefill_cross(model, cfg, enc_out, cache)
    tok, out, hist = prompts[:, :1], [prompts], []
    for j in range(P - 1 + n_new):
        logits, cache = M.decode_step(model, cfg, tok, cache)
        logits = gather_decode_rows(logits[:, -1].float(), cache)
        hist.append(logits)
        if j + 1 < P:
            tok = prompts[:, j + 1:j + 2]
        else:
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            out.append(tok)
    return torch.cat(out, dim=1).numpy(), torch.stack(hist).numpy()


def cp_inputs(inputs, arch):
    """(prompts, enc_out or None) of an arch's CP_DECODE case."""
    import torch
    enc = inputs["enc_out"].get(arch)
    return (torch.from_numpy(inputs["prompts_cp"][arch]),
            None if enc is None else torch.from_numpy(enc))


def cp_decode_cases(mesh, inputs: dict) -> dict:
    """Each arch decoded under its decode cell's rules
    (``rules_for(arch, CP_SHAPE)``) at CP_DECODE: the greedy tokens of
    ``ServeEngine`` and the tokens and logits of :func:`greedy_logits`,
    and rank 0's cache leaf shapes; on the 2 x 2 mesh also reduced
    qwen3-4b under CP_OVERRIDE."""
    import torch
    from repro_torch import configs
    from repro_torch import models as M
    from repro_torch.distributed import sharding_ctx
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.serve import ServeEngine
    B, P, n_new, max_len = CP_DECODE
    cases = [(f"cp/{arch}", arch, rules_for(arch, CP_SHAPE))
             for arch in ARCHS]
    if mesh.size() == 4:
        cases.append(("cp/qwen3-4b/override", "qwen3-4b",
                      rules_for("qwen3-4b", CP_SHAPE, CP_OVERRIDE)))
    out = {}
    for key, arch, rules in cases:
        cfg = config(arch, configs)
        model = _model(inputs, arch, cfg, mesh, rules)
        prompts, enc = cp_inputs(inputs, arch)
        with sharding_ctx(mesh, rules):
            engine = ServeEngine(cfg, model, max_len=max_len, device="cpu")
            toks = engine.generate(prompts, n_new).numpy()
            got = greedy_logits(model, cfg, prompts, n_new, max_len, enc)
            cache = M.init_cache(cfg, B, max_len, torch.float32,
                                 device="cpu")
        out[key] = dict(engine=toks, tokens=got[0], logits=got[1],
                        shapes={"/".join(map(str, k)): tuple(v.shape)
                                for k, v in _leaves(cache)})
    return out


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def cp_write_steps(model, cfg, tokens, writes, max_len: int):
    """Decode steps of S = ``writes`` rows each -> (the whole batch's
    float32 logits of every step, the whole cache after them), both
    gathered under a sharding context."""
    import torch
    from repro_torch import models as M
    from repro_torch.distributed.model_parallel import (gather_decode_rows,
                                                        gather_tensor)
    cache = M.init_cache(cfg, tokens.shape[0], max_len, torch.float32,
                         device="cpu")
    hist, j = [], 0
    for S in writes:
        logits, cache = M.decode_step(model, cfg, tokens[:, j:j + S], cache)
        hist.append(gather_decode_rows(logits.float(), cache).numpy())
        j += S
    pl = getattr(cache, "placements", {})
    whole = {"/".join(map(str, k)): (gather_tensor(v, pl[k]) if k in pl
                                     else v).numpy()
             for k, v in _leaves(cache)}
    return hist, whole


def cp_write_case(mesh, inputs: dict) -> dict:
    """Reduced qwen3-4b and deepseek under their decode cells' rules on
    the 2 x 2 mesh: CP_WRITES, rows across a block's end, more rows than
    a block and a clamped write."""
    import torch
    from repro_torch import configs
    from repro_torch.distributed import sharding_ctx
    from repro_torch.launch.dryrun import rules_for
    out = {}
    for arch in ("qwen3-4b", "deepseek-v2-lite-16b"):
        cfg = config(arch, configs)
        rules = rules_for(arch, CP_SHAPE)
        model = _model(inputs, arch, cfg, mesh, rules)
        tokens = torch.from_numpy(inputs["write_tokens"])
        with sharding_ctx(mesh, rules):
            out[f"cp_write/{arch}"] = cp_write_steps(
                model, cfg, tokens, CP_WRITES, CP_DECODE[3])
    return out


def sig_mmd_case(mesh, inputs: dict) -> dict:
    """Three sig-MMD steps of qwen3-4b with its signature head."""
    from repro_torch import configs
    cfg = configs.with_sig_head(config("qwen3-4b", configs), **SIG)
    return {"sig_mmd": _steps(_model(inputs, "qwen3-4b/sig", cfg, mesh),
                              cfg, inputs["batches"]["sig_mmd"], mesh,
                              loss="sig_mmd")}


def seq_cfg(key: str, configs):
    """The config of a sequence-split training case: ``arch``,
    ``qwen3-4b/sig`` (the signature head) or ``qwen3-4b/masked`` (the head
    at SEQ_STRIDE)."""
    arch, _, kind = key.partition("/")
    cfg = config(arch, configs)
    if kind == "sig":
        cfg = configs.with_sig_head(cfg, **SIG)
    elif kind == "masked":
        cfg = configs.with_sig_head(cfg, **SIG, stride=SEQ_STRIDE)
    return cfg


# (case, model and config key, batches key, loss, microbatches)
SEQ_CASES = tuple((a, a, a, "lm", 0) for a in SEQ_ARCHS) + (
    ("sig_mmd", "qwen3-4b/sig", "sig_mmd", "sig_mmd", 0),
    ("masked", "qwen3-4b/masked", "seq_masked", "sig_mmd", 0),
    ("uneven", "qwen3-4b", "seq_uneven", "lm", 0),
    ("odd", "qwen3-4b", "seq_odd", "lm", 0),
    ("micro", "qwen3-4b/sig", "micro/sig_mmd", "sig_mmd", MICRO[2]))


def seq_train_cases(mesh, inputs: dict) -> dict:
    """SGD steps under the train cells' rules (``rules_for(arch,
    DRYRUN_SHAPE's cell)``: the rows over the data axis, each sequence in
    blocks over the model axis) of each of SEQ_CASES, with the executed
    rules and the batch's sequence split; and an eval step of qwen3-4b
    there."""
    from repro_torch import configs, train
    from repro_torch.distributed import batch as DB
    from repro_torch.distributed import sharding_ctx
    from repro_torch.launch import dryrun, specs
    name, shape = DRYRUN_SHAPE
    specs.SHAPES[name] = shape
    out = {}
    for case, key, bkey, loss, micro in SEQ_CASES:
        cfg = seq_cfg(key, configs)
        rules = dryrun.rules_for(key.split("/")[0], name)
        pkey = "qwen3-4b/sig" if key == "qwen3-4b/masked" else key
        model = _model(inputs, pkey, cfg, mesh, rules)
        batches = inputs["batches"][bkey]
        with sharding_ctx(mesh, rules):
            seq = DB.batch_seq(train.place_batch(_t(batches[0])))
        out[f"seq/{case}"] = dict(
            steps=_steps(model, cfg, batches, mesh, rules=rules, loss=loss,
                         microbatch=micro),
            seq_rule=rules.get("seq"), split=None if seq is None
            else (seq.axes, seq.size))
    cfg = config("qwen3-4b", configs)
    rules = dryrun.rules_for("qwen3-4b", name)
    model = _model(inputs, "qwen3-4b", cfg, mesh, rules)
    with sharding_ctx(mesh, rules):
        m = train.make_eval_step(cfg)(model, train.place_batch(_t(
            inputs["batches"]["qwen3-4b"][0])))
    out["seq/eval"] = {k: float(v) for k, v in m.items()}
    del specs.SHAPES[name]
    return out


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


def place_uneven(batch: dict, mesh) -> dict:
    """Each leaf's rows over the mesh's ``"data"`` axis in
    ``distributed.batch.rows_of`` blocks, the last ranks holding fewer
    true rows, as DTensors of the global shape: the layout of a batch the
    data ranks do not divide, which ``place_batch``'s divisibility guard
    leaves whole, placed by hand."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.distributed.batch import rows_of
    P, r = mesh.size(0), mesh.get_local_rank(0)
    out = {}
    for k, v in batch.items():
        start, n, _ = rows_of(v.shape[0], P, r)
        out[k] = DTensor.from_local(
            v[start:start + n], mesh,
            [Shard(0)] + [Replicate()] * (mesh.ndim - 1), run_check=False,
            shape=v.shape, stride=v.stride())
    return out


def _sgd_steps(model, cfg, batches, mesh, place, rules=None) -> dict:
    """Three SGD steps on batches placed by ``place`` under ``rules`` ->
    {"steps": (metrics a step, full params), "grads": the first step's
    full gradient (SGD's momentum after one step), "drops": this rank's
    dropped pairs a step, "tags": the collectives' tags a step}."""
    from repro_torch import optim, train
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding_ctx
    from repro_torch.distributed.model_parallel import (
        gather_params, gather_tensor, placements)
    from repro_torch.models.layers import dropped_pairs
    opt = optim.sgd(lr=lr_of(cfg.name))
    state = opt.init(model)
    step = train.make_train_step(cfg, opt)
    pl = placements(model)
    hist, grads, drops, tags = [], None, [], []
    with sharding_ctx(mesh, rules):
        for b in batches:
            C.LOG.reset()
            with dropped_pairs() as d:
                model, state, m = step(model, state, place(_t(b), mesh))
            hist.append({k: float(v) for k, v in m.items()})
            drops.append(int(sum(d)))
            tags.append(sorted({r.tag for r in C.LOG.records}))
            if grads is None:
                grads = {k: (gather_tensor(v, pl[k]) if k in pl else v)
                         .numpy().copy() for k, v in state["mom"].items()}
    params = {k: v.numpy() for k, v in gather_params(model).items()}
    return dict(steps=(hist, params), grads=grads, drops=drops, tags=tags)


def straddle_train_cases(mesh, inputs: dict, keys=("train", "pad")) -> dict:
    """SGD steps of the straddling config (``straddle_config``) on the
    mesh (the model sharded where it has a model axis of 2):
    STRADDLE_TRAIN's batches placed by ``place_batch``, and STRADDLE_PAD's,
    whose rows the data ranks do not divide, by :func:`place_uneven`."""
    from repro_torch import configs, train
    cfg = straddle_config(configs)
    place = {"train": lambda b, mesh: train.place_batch(b),
             "pad": place_uneven}
    return {f"straddle/{k}": _sgd_steps(
        _model(inputs, STRADDLE_ARCH, cfg,
               mesh if mesh.size(1) > 1 else None), cfg,
        inputs["batches"][f"straddle/{k}"], mesh, place[k]) for k in keys}


def straddle_decode_case(mesh, inputs: dict) -> dict:
    """STRADDLE_DECODE's greedy decode of the straddling config under
    ``rules_for(arch, CP_SHAPE)``: ``ServeEngine``'s tokens, and the
    tokens, every step's logits, this rank's dropped pairs a step and the
    collectives by tag of :func:`greedy_logits`."""
    import torch
    from repro_torch import configs
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding_ctx
    from repro_torch.launch.dryrun import collectives_by_tag, rules_for
    from repro_torch.models.layers import dropped_pairs
    from repro_torch.serve import ServeEngine
    B, P, n_new, max_len = STRADDLE_DECODE
    cfg = straddle_config(configs, decode=True)
    rules = rules_for(STRADDLE_ARCH, CP_SHAPE)
    model = _model(inputs, STRADDLE_ARCH, cfg, mesh, rules)
    prompts = torch.from_numpy(inputs["prompts_straddle"])
    with sharding_ctx(mesh, rules):
        engine = ServeEngine(cfg, model, max_len=max_len, device="cpu")
        toks = engine.generate(prompts, n_new).numpy()
        C.LOG.reset()
        with dropped_pairs() as d:
            got = greedy_logits(model, cfg, prompts, n_new, max_len)
        tags = collectives_by_tag(C.LOG.records)
    L = cfg.n_layers
    return {"straddle/decode": dict(
        engine=toks, tokens=got[0], logits=got[1], tags=tags,
        drops=[int(sum(d[i:i + L])) for i in range(0, len(d), L)])}


def adafactor_cases(mesh, inputs: dict) -> dict:
    """Three Adafactor steps of each of ADAFACTOR_ARCHS on the sharded
    model: factored moments over sharded dimensions, replicated slots."""
    from repro_torch import configs, optim
    out = {}
    for arch in ADAFACTOR_ARCHS:
        cfg = config(arch, configs)
        out[f"adafactor/{arch}"] = _steps(
            _model(inputs, arch, cfg, mesh), cfg, inputs["batches"][arch],
            mesh, opt=optim.adafactor(**ADAFACTOR))
    return out


def micro_dp_cases(dp, inputs: dict) -> dict:
    """``microbatch=2`` on the data-only mesh of every rank: a sig-MMD
    step of qwen3-4b and a MoE-aux (LM) step of deepseek, each microbatch
    the reference's contiguous slice of the global batch."""
    from repro_torch import configs
    out = {}
    for key, arch, loss in (("micro/sig_mmd", "qwen3-4b", "sig_mmd"),
                            ("micro/moe_aux", "deepseek-v2-lite-16b", "lm")):
        cfg = configs.with_sig_head(config(arch, configs), **SIG)
        out[key] = _steps(_model(inputs, f"{arch}/sig", cfg), cfg,
                          inputs["batches"][key], dp, loss=loss,
                          microbatch=MICRO[2])
    return out


def dryrun_cases(mesh, inputs: dict) -> dict:
    """What the dry run predicts, measured: a reduced arch's Adafactor
    train step under the rules of the dry run's DRYRUN_SHAPE cell (each
    sequence in blocks over the model axis, as the dry run runs it): rank
    0's parameter and optimizer-state bytes and the collectives of one
    step by kind and by tag, the backward's exchanges included."""
    import torch
    from repro_torch import configs, optim, train
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding_ctx
    from repro_torch.distributed.hlo import collective_stats
    from repro_torch.distributed.model_parallel import shard_model
    from repro_torch.launch import dryrun, specs
    name, shape = DRYRUN_SHAPE
    specs.SHAPES[name] = shape
    out = {}
    for cell, (arch, over) in DRYRUN_CELLS.items():
        cfg = config(arch, configs)
        rules = dryrun.rules_for(arch, name, over)
        model = shard_model(_model(inputs, arch, cfg), mesh, rules)
        opt = optim.adafactor(**ADAFACTOR)
        state = opt.init(model)
        g = torch.Generator().manual_seed(0)
        batch = {k: torch.randint(1, cfg.vocab_size, (shape["batch"],
                                                     shape["seq"]),
                                  generator=g, dtype=torch.int32)
                 for k in ("tokens", "labels")}
        with sharding_ctx(mesh, rules):
            placed = train.place_batch(batch)
            step = train.make_train_step(cfg, opt)
            C.LOG.reset()
            step(model, state, placed)
            st = collective_stats()
        out[f"dryrun/{cell}"] = dict(
            param_bytes=dryrun.tree_bytes(model),
            opt_state_bytes=dryrun.tree_bytes(state),
            collectives={k: list(v) for k, v in st.by_kind.items()},
            by_tag=dryrun.collectives_by_tag(C.LOG.records))
    del specs.SHAPES[name]
    return out


def prefill_batch(inputs: dict, arch: str, key: str = "prefill"):
    """The torch batch of an arch's prefill case (``inputs[key]``)."""
    return _t(inputs[key][arch])


def prefill_model(inputs: dict, arch: str, cfg, mesh=None, rules=None):
    """The converted reference model of a prefill case (rwkv6 in
    float64)."""
    import torch
    model = _model(inputs, arch, cfg)
    if arch == "rwkv6-1.6b":
        model = model.to(torch.float64)
    if mesh is not None:
        from repro_torch.distributed.model_parallel import shard_model
        shard_model(model, mesh, rules)
    return model


def prefill_cases(mesh, inputs: dict) -> dict:
    """Each of PREFILL_ARCHS prefilled under its prefill cell's rules:
    this rank's rows' last-position logits and their first row, and the
    collectives' tags; a prompt of PREFILL_ODD tokens (left whole); a
    train step under the prefill rules (labels the tokens); and
    qwen3-4b's prefill under a layout that also splits its heads and
    ``ff`` over the model axis that cuts the prompt (FSDP over both axes:
    ``wq`` and ``w_up`` then shard over both, ``wo`` and ``w_down``
    split their rows over the model axis, and the layers read them
    whole)."""
    from repro_torch import configs, train
    from repro_torch.distributed import batch as DB
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding_ctx
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.serve.engine import make_prefill_step
    out = {}
    cases = [(f"prefill/{a}", a, "prefill") for a in PREFILL_ARCHS]
    cases.append(("prefill_odd/qwen3-4b", "qwen3-4b", "prefill_odd"))
    for key, arch, bkey in cases:
        cfg = config(arch, configs)
        rules = rules_for(arch, PREFILL_SHAPE)
        model = prefill_model(inputs, arch, cfg, mesh, rules)
        with sharding_ctx(mesh, rules):
            placed = train.place_batch(prefill_batch(inputs, arch, bkey))
            lead = placed.get("tokens", placed.get("embeds"))
            with DB.rows_scope(lead) as rows:
                start, split = rows.start, rows.seq is not None
            C.LOG.reset()
            logits = make_prefill_step(cfg)(model, placed)
        out[key] = dict(logits=logits.numpy(), start=start, split=split,
                        tags=sorted({r.tag for r in C.LOG.records}))
    cfg = config("qwen3-4b", configs)
    rules = rules_for("qwen3-4b", PREFILL_SHAPE)
    model = prefill_model(inputs, "qwen3-4b", cfg, mesh, rules)
    out["prefill_train"] = _steps(model, cfg, [prefill_train_batch(inputs)],
                                  mesh, rules=rules)
    tp = dict(rules, heads="model", ff="model")
    model = prefill_model(inputs, "qwen3-4b", cfg, mesh, tp)
    with sharding_ctx(mesh, tp):
        placed = train.place_batch(prefill_batch(inputs, "qwen3-4b"))
        with DB.rows_scope(placed["tokens"]) as rows:
            start = rows.start
        C.LOG.reset()
        logits = make_prefill_step(cfg)(model, placed)
    out["prefill_tp"] = dict(logits=logits.numpy(), start=start, split=True,
                             tags=sorted({r.tag for r in C.LOG.records}))
    return out


def sp_tp_rules(arch: str, shape: str) -> dict:
    """``rules_for(arch, shape, SP_TP)``, with SP_TP_DENSE for a dense
    arch."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import rules_for
    over = dict(SP_TP) if get_config(arch).moe else dict(SP_TP, **SP_TP_DENSE)
    return rules_for(arch, shape, over)


def sp_tp_cases(mesh, inputs: dict) -> dict:
    """Each of SP_TP_ARCHS and SP_TP_FAMILIES under :func:`sp_tp_rules`: a
    prefill (this rank's rows' last-position logits, its first row, the
    collectives' tags), three LM steps of the train cell's rules and, for
    SP_TP_ARCHS, three sig-MMD steps (with their tags); deepseek's
    MoE-aux step at AUX and qwen3-4b's steps on SEQ_ODD's sequence of 7
    there."""
    from repro_torch import configs, train
    from repro_torch.distributed import batch as DB
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding_ctx
    from repro_torch.launch import specs
    from repro_torch.serve.engine import make_prefill_step
    name, shape = DRYRUN_SHAPE
    specs.SHAPES[name] = shape
    out = {}

    def steps(key, cfg, bkey, rules, loss="lm"):
        model = _model(inputs, key, cfg, mesh, rules)
        C.LOG.reset()
        got = _steps(model, cfg, inputs["batches"][bkey], mesh, rules=rules,
                     loss=loss)
        return dict(steps=got, tags=sorted({r.tag for r in C.LOG.records}))
    for arch in SP_TP_ARCHS + SP_TP_FAMILIES:
        cfg = config(arch, configs)
        rules = sp_tp_rules(arch, PREFILL_SHAPE)
        model = prefill_model(inputs, arch, cfg, mesh, rules)
        with sharding_ctx(mesh, rules):
            placed = train.place_batch(prefill_batch(inputs, arch))
            with DB.rows_scope(placed["tokens"]) as rows:
                start, split = rows.start, rows.seq is not None
            C.LOG.reset()
            logits = make_prefill_step(cfg)(model, placed)
        out[f"sp_tp/prefill/{arch}"] = dict(
            logits=logits.numpy(), start=start, split=split,
            tags=sorted({r.tag for r in C.LOG.records}))
        rules = sp_tp_rules(arch, name)
        out[f"sp_tp/lm/{arch}"] = steps(arch, cfg, arch, rules)
        if arch in SP_TP_ARCHS:
            out[f"sp_tp/sig_mmd/{arch}"] = steps(
                f"{arch}/sig", configs.with_sig_head(cfg, **SIG), "sig_mmd",
                rules, "sig_mmd")
    arch = "deepseek-v2-lite-16b"
    out["sp_tp/aux"] = steps(
        f"{arch}/sig", configs.with_sig_head(config(arch, configs), **SIG),
        "aux/lm", sp_tp_rules(arch, name))
    out["sp_tp/odd"] = steps("qwen3-4b", config("qwen3-4b", configs),
                             "seq_odd", sp_tp_rules("qwen3-4b", name))
    del specs.SHAPES[name]
    return out


def cp_key(arch: str, tp: bool) -> str:
    return f"{arch}/tp" if tp else arch


def cp_cases(mesh, inputs: dict) -> dict:
    """Context parallelism on the 2 x 2 mesh: each of CP_STEPS prefilled
    (this rank's rows' last-position logits, the collectives' tags, the
    sequence's split axes) and trained (:func:`_sgd_steps`: three LM
    steps, the first step's gradients, the tags a step) under
    ``rules_for(arch, shape, CP)`` (with SP_TP_DENSE where marked), each
    of CP_FAMILIES prefilled under CP + SP_TP_DENSE, and qwen3-4b trained
    on SEQ_ODD's sequence under CP, which leaves the batch whole."""
    from repro_torch import configs, train
    from repro_torch.distributed import batch as DB
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding_ctx
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.serve.engine import make_prefill_step
    name, shape = DRYRUN_SHAPE
    specs.SHAPES[name] = shape
    out = {}

    def rules(arch, cell, tp):
        return rules_for(arch, cell, dict(CP, **SP_TP_DENSE) if tp else CP)

    def prefill(arch, tp):
        cfg = config(arch, configs)
        r = rules(arch, PREFILL_SHAPE, tp)
        model = prefill_model(inputs, arch, cfg, mesh, r)
        with sharding_ctx(mesh, r):
            placed = train.place_batch(prefill_batch(inputs, arch))
            with DB.rows_scope(placed["tokens"]) as rows:
                start, split = rows.start, rows.seq
            C.LOG.reset()
            logits = make_prefill_step(cfg)(model, placed)
        out[f"cp/prefill/{cp_key(arch, tp)}"] = dict(
            logits=logits.numpy(), start=start, split=split is not None,
            axes=split.axes, tags=sorted({r.tag for r in C.LOG.records}))
    for arch, tp in CP_STEPS:
        prefill(arch, tp)
        cfg = config(arch, configs)
        r = rules(arch, name, tp)
        out[f"cp/lm/{cp_key(arch, tp)}"] = _sgd_steps(
            _model(inputs, arch, cfg, mesh, r), cfg,
            inputs["batches"][arch], mesh,
            lambda b, mesh: train.place_batch(b), r)
    for arch in CP_FAMILIES:
        prefill(arch, True)
    # SEQ_ODD's 7 tokens, which the four blocks do not divide: the batch
    # is whole on every rank, placed nowhere
    cfg = config("qwen3-4b", configs)
    r = rules("qwen3-4b", name, False)
    out["cp/odd"] = _sgd_steps(_model(inputs, "qwen3-4b", cfg, mesh, r), cfg,
                               inputs["batches"]["seq_odd"], mesh,
                               lambda b, mesh: train.place_batch(b), r)
    del specs.SHAPES[name]
    return out


def prefill_train_batch(inputs: dict) -> dict:
    """qwen3-4b's prefill prompts as a train batch, the tokens their own
    labels (numpy)."""
    b = inputs["prefill"]["qwen3-4b"]
    return dict(b, labels=b["tokens"])


def dryrun_prefill_cases(mesh, inputs: dict) -> dict:
    """What the dry run predicts for DRYRUN_PREFILL's cells, measured:
    rank 0's argument, output and peak bytes of the prefill step and its
    collectives by kind and by tag."""
    from repro_torch import configs, train
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding_ctx
    from repro_torch.distributed.hlo import collective_stats
    from repro_torch.launch import dryrun
    from repro_torch.obs.compile import CostCounter
    from repro_torch.serve.engine import make_prefill_step
    name, shape = DRYRUN_PREFILL
    out = {}
    for arch in DRYRUN_PREFILL_ARCHS:
        cfg = config(arch, configs)
        rules = dryrun.rules_for(arch, PREFILL_SHAPE)
        model = prefill_model(inputs, arch, cfg, mesh, rules)
        with sharding_ctx(mesh, rules):
            placed = train.place_batch(prefill_batch(inputs, arch))
            C.LOG.reset()
            with CostCounter() as cost:
                logits = make_prefill_step(cfg)(model, placed)
            records = list(C.LOG.records)
        out[f"dryrun_prefill/{arch}"] = dict(
            argument_bytes=dryrun.tree_bytes(model) + dryrun.tree_bytes(
                placed),
            output_bytes=dryrun.tree_bytes(logits),
            peak_bytes=cost.peak_bytes,
            collectives={k: list(v) for k, v in
                         collective_stats(records).by_kind.items()},
            by_tag=dryrun.collectives_by_tag(records))
    return out


def rwkv64_case(mesh, inputs: dict) -> dict:
    """Three float64 SGD steps of rwkv6 at the shared learning rate."""
    import torch
    from repro_torch import configs, optim
    from repro_torch.distributed.model_parallel import shard_model
    cfg = config("rwkv6-1.6b", configs)
    model = shard_model(_model(inputs, "rwkv6-1.6b", cfg).to(torch.float64),
                        mesh)
    return {"rwkv64": _steps(model, cfg, inputs["batches"]["rwkv6-1.6b"],
                             mesh, opt=optim.sgd(lr=RWKV64_LR))}


def whisper_case(mesh) -> dict:
    """The placements ``shard_model`` gives reduced whisper on the mesh
    (its model axis is executed)."""
    from repro_torch import configs
    from repro_torch import models as M
    from repro_torch.distributed.model_parallel import placements, shard_model
    cfg = config("whisper-large-v3", configs)
    model = shard_model(M.init_params(0, cfg, device="cpu"), mesh)
    return {"whisper_specs": {k: p.spec for k, p in
                              placements(model).items()}}


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
        out.update(cp_decode_cases(mesh, inputs))
        out.update(whisper_case(mesh))
        out.update(rwkv64_case(mesh, inputs))
        out.update(prefill_cases(mesh, inputs))
        out.update(sp_tp_cases(mesh, inputs))
        if world == 2:
            out.update(dryrun_prefill_cases(mesh, inputs))
        if world == 4:
            out.update(sig_mmd_case(mesh, inputs))
            out.update(seq_train_cases(mesh, inputs))
            out.update(cp_cases(mesh, inputs))
            out.update(micro_case(mesh, inputs))
            out.update(adafactor_cases(mesh, inputs))
            out.update(dryrun_cases(mesh, inputs))
            out.update(donation_case(mesh, inputs))
            out.update(cp_write_case(mesh, inputs))
            out.update(launcher_case(dirs["ckpt"]))
        dp = make_dev_mesh(world, 1, device="cpu")
        if world == 4:
            out.update(straddle_train_cases(mesh, inputs))
            out.update(straddle_decode_case(mesh, inputs))
        out.update(moe_aux_cases(dp, inputs))
        out.update({f"dp/{k}": v for k, v in
                    straddle_train_cases(dp, inputs).items()})
        if world == 2:
            out.update(micro_dp_cases(dp, inputs))
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
        raise


# sharded leaves of tests/test_torch_optim.py's tree on a 1 x 2 mesh:
# "w" (130 x 140) split by columns, each layer of "layers.m" (128 x 130)
# by rows, so each factored mean averages a sharded dimension once
OPTIM_SPECS = {"w": (None, "model"), "layers.0.m": ("model", None),
               "layers.1.m": ("model", None)}


def optim_rank(rank: int, world: int, store_path: str, params: dict,
               grads: list, schedule: tuple, queue) -> None:
    """Adafactor (lr ``cosine_schedule(*schedule)``) over a ParamTree
    whose OPTIM_SPECS leaves are laid out over a 1 x 2 mesh by hand: each
    step takes this rank's block of the same gradients; -> the gathered
    parameters and the slots' shapes."""
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(
            store_path, world), rank=rank, world_size=world)
        from repro_torch.convert import _nest
        from repro_torch.distributed.ctx import NamedSharding
        from repro_torch.distributed.model_parallel import (
            Placement, _owners, block, gather_params)
        from repro_torch.launch.mesh import make_dev_mesh
        from repro_torch.models.layers import ParamTree
        from repro_torch.optim import adafactor, cosine_schedule
        mesh = make_dev_mesh(1, 2, device="cpu")
        model = ParamTree(_nest({k: torch.from_numpy(v)
                                 for k, v in params.items()}))
        sh = {k: NamedSharding(mesh, s) for k, s in OPTIM_SPECS.items()}
        with torch.no_grad():
            for name, mod, key in list(_owners(model)):
                if name in sh:
                    p = mod._parameters[key]
                    full = tuple(p.shape)
                    p.data = block(p.data, sh[name])
                    mod._placed[key] = Placement(sh[name], full)
        opt = adafactor(lr=cosine_schedule(*schedule))
        state = opt.init(model)
        for g in grads:
            opt.update({k: block(torch.from_numpy(v), sh[k]) if k in sh
                        else torch.from_numpy(v) for k, v in g.items()},
                       state, model)
        out = dict(params={k: v.numpy() for k, v in
                           gather_params(model).items()},
                   slots={k: {s: tuple(t.shape) for s, t in v.items()}
                          for k, v in state["slots"].items()},
                   local={k: tuple(p.shape)
                          for k, p in model.named_parameters()})
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
        raise
