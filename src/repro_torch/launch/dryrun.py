"""Multi-pod dry run on meta tensors (port of ``repro.launch.dryrun``).

The reference lowers and compiles every (architecture × shape × mesh)
cell on 512 placeholder CPU devices and reads XLA's cost and memory
analyses.  The port has no compiler: :func:`lower_cell` runs **one
rank's step on meta tensors in a fake world** of the mesh's size (256 or
512 ranks) on ``torch.distributed``'s fake backend
(``torch.testing._internal.distributed.fake_pg``), where every
collective is accepted and moves nothing.  The step is the port's own:
:func:`~repro_torch.distributed.model_parallel.shard_model` of the meta
model under the cell's rules, then the train, prefill or decode step.
From it:

- ``hlo_flops_per_dev``: the step's FLOPs as XLA's ``cost_analysis``
  counts them, as the reference's are (:class:`repro_torch.obs.compile.
  CostCounter`: matmuls by ``FlopCounterMode``, elementwise and reduction
  work an output element, transcendentals apart);
- ``hlo_bytes_per_dev``: each operation's inputs and outputs, unfused, as
  XLA's ``bytes accessed`` is (:class:`repro_torch.obs.compile.
  CostCounter`, shared with ``obs.record_cost``);
- ``collectives`` and ``collective_wire_bytes_per_dev``: the port's log
  of the collectives the step issued (``distributed/hlo.py::
  collective_stats``);
- ``remat_dot_duplication``: the step's matmuls over their unique
  shapes (``hlo.duplication``; the port's layers are unrolled, so every
  layer repeats its products);
- ``memory_analysis``: argument and output bytes of the rank's meta
  tensors (its parameter and optimizer-state bytes apart), and as
  temporary bytes the peak of the live bytes of the step's intermediate
  tensors (operation outputs, views excluded), which holds the tensors
  saved for the backward, checkpointed layers' included.

The port executes the reference's layouts.  A prefill or train cell
under the reference's ``seq: "model"`` rule (``rules_for`` gives it to
the cells whose batch 256 does not divide: every prefill cell of a dense
model, and a train cell of such a batch; ``rule_overrides={"seq":
"model"}``, the CLI's ``--override``, gives it to any cell, the MoE and
MLA archs' and those whose heads, ``ff`` and experts the model axis
splits included) runs it: each rank runs its rows
and its block of every sequence, the blocks exchanging keys and values
for attention, boundary rows for the convolution and the token shifts,
and one state a block for the Mamba2 and RWKV6 recurrences
(``serve.engine.make_prefill_step``, ``train.make_train_step``); a train
step's backward sums each exchange's gradients back to the blocks, and
the dry run counts those collectives under their own tags (``sp_kv_grad``,
...).  Where the model axis also splits a layer, the layer gathers the
group's rows and reduce-scatters its output (``sp_tp_in`` /
``sp_tp_out``, the MoE's ``sp_moe_in`` / ``sp_moe_out``).  Decode runs
the reference's layout: each rank decodes its rows of the requests, and
each attention cache is cut on its sequence over ``kv_seq``'s axes
(``model_parallel.local_cache``), the blocks' softmax partials combined
over their group (``models.layers.attention``).

A process holds one default process group, so the fake world lives in a
process of its own (the CLI's, or a subprocess), never inside a real
rank.  The H100's constants replace the v5e's.  The production meshes
keep the reference's shapes (16 × 16 and 2 × 16 × 16) so the specs
compare leaf for leaf; with 8 cards a node, their ``"model"`` axis of 16
spans two nodes, so its collectives run at the NIC's rate, as the data
and pod axes' do.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --both-meshes [--out runs/dryrun]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get_config
from ..distributed import batch as DB
from ..distributed import collectives as C
from ..distributed import model_parallel as MP
from ..distributed.ctx import AbstractMesh, sharding_ctx
from ..distributed.hlo import collective_stats, duplication
from ..kernels.cost import BF16_FLOPS_PER_S, HBM_BYTES_PER_S
from ..obs.compile import CostCounter
from ..optim import adafactor, adamw
from ..serve.engine import (make_prefill_step, make_serve_step,
                            prefill_hidden)
from ..train.trainer import make_train_step, place_batch
from . import specs as SP

# H100 SXM5 hardware model (roofline constants), the first two from the
# kernels' cost module
PEAK_FLOPS = BF16_FLOPS_PER_S   # dense BF16 tensor-core FLOP/s (datasheet)
HBM_BW = HBM_BYTES_PER_S        # HBM3 bytes/s (NVIDIA H100 datasheet, SXM5)
NVLINK_BW = 450e9          # bytes/s a direction: NVLink 4's 900 GB/s (H100 datasheet)
NIC_BW = 50e9              # bytes/s: one 400 Gb/s NIC a card (ConnectX-7, DGX H100)
CARDS_PER_NODE = 8         # HGX / DGX H100 node


def rules_for(arch: str, shape: str, overrides: dict | None = None) -> dict:
    rules: dict = {}
    cfg = get_config(arch)
    kind = SP.SHAPES.get(shape, {}).get("kind")
    # NB (§Perf cell A it3/it4, REFUTED): turning dense TP off for MoE and
    # sharding tokens over 'model' replicates dense compute (it3, t_comp
    # 0.67->3.1s) or forces remat'd dispatch one-hots to reshard (it4,
    # t_coll 2.6->3.2s).  Megatron TP for the dense parts + EP stays.
    if (not cfg.moe) and kind in ("train", "prefill") and \
            cfg.param_count() <= 60e9:
        # §Perf cell C, generalized: models far narrower than the mesh are
        # collective-bound under 16-way TP (every projection's bwd gathers
        # its ~268MB input).  Pure DP over all 256 chips + ZeRO-3 over both
        # axes: per-layer weight gathers are small and overlap with compute.
        # Tokens must shard over 'model' too or dense compute replicates:
        # batch when divisible (train), else the sequence axis (prefill).
        rules.update({"heads": None, "kv_heads": None, "ff": None,
                      "fsdp": ("data", "model")})
        if SP.SHAPES[shape]["batch"] % 256 == 0:
            rules["batch"] = ("data", "model")
        else:
            rules["seq"] = "model"
    if kind == "decode":
        # weight-stationary decode (§Perf cell B): no FSDP re-gather of the
        # params every token, KV cache sharded over 'model' on the sequence
        # axis (softmax/PV reductions over the sharded axis become tiny
        # partial-sum all-reduces under SPMD).  State-cache families
        # (hybrid/rwkv) keep kv_seq unsharded: their caches are recurrent
        # states, and seq-sharding the two zamba shared-attn KV blocks
        # forces a per-step cache reshard (measured 0.026 -> 0.199s; with
        # kv_seq=None it is 0.00034s).
        rules.update({"fsdp": None})
        if cfg.family not in ("hybrid", "rwkv"):
            rules.update({"kv_seq": "model"})
    if shape == "long_500k" and cfg.family not in ("hybrid", "rwkv"):
        # context parallelism: B=1 cells shard the KV/state seq over BOTH
        # axes ('data' carries no batch when B=1).  hybrid/rwkv long-context
        # state is O(1) in seq — the decode rules above already apply.
        rules.update({"kv_seq": ("data", "model"), "batch": ("pod",)})
    if overrides:
        rules.update(overrides)
    return rules


def production_mesh(multi_pod: bool = False) -> AbstractMesh:
    """The reference's production mesh as an :class:`AbstractMesh`:
    (16, 16) ``("data", "model")``, or (2, 16, 16) with a ``"pod"``
    axis."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

def fake_world(size: int) -> None:
    """Make the default process group a fake world of ``size`` ranks (this
    process rank 0), replacing an earlier fake world of another size.  A
    real process group is never replaced."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if str(dist.get_backend()) != "fake":
            raise RuntimeError(
                "the dry run's fake world needs a process of its own: this "
                f"one is a rank of a {dist.get_backend()} world")
        if dist.get_world_size() == size:
            return
        close_world()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def close_world() -> None:
    """Destroy the fake world (and the groups the port cached on it)."""
    if dist.is_initialized() and str(dist.get_backend()) == "fake":
        dist.destroy_process_group()
    MP._GROUPS.clear()
    C._RANKS.clear()


def device_mesh(mesh: AbstractMesh):
    """A DeviceMesh of the abstract mesh's shape and names on the fake
    world (sized to it)."""
    from torch.distributed.device_mesh import DeviceMesh
    fake_world(mesh.size())
    ranks = torch.arange(mesh.size()).reshape(tuple(mesh.shape))
    return DeviceMesh("cpu", ranks, mesh_dim_names=tuple(mesh.mesh_dim_names))


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

def tree_bytes(tree) -> int:
    """Bytes of every tensor of a tree (a module's parameters, dicts,
    lists, tuples; a DTensor's local block)."""
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() * p.element_size() for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = DB.to_local(tree)
        return t.numel() * t.element_size()
    return 0


def node_local(ranks: tuple) -> bool:
    """True when the ranks lie inside one node of CARDS_PER_NODE cards
    (consecutive ranks a node)."""
    return len({r // CARDS_PER_NODE for r in ranks}) <= 1


def axis_bandwidth(mesh: AbstractMesh) -> dict:
    """``{axis: bytes/s}``: NVLink for an axis whose groups fit inside a
    node, the NIC's rate for one whose groups span nodes."""
    ranks = torch.arange(mesh.size()).reshape(tuple(mesh.shape))
    out = {}
    for i, name in enumerate(mesh.mesh_dim_names):
        group = ranks.movedim(i, -1).reshape(-1, mesh.shape[i])[0].tolist()
        out[name] = NVLINK_BW if node_local(tuple(group)) else NIC_BW
    return out


def collective_seconds(records) -> float:
    """Σ wire bytes / bandwidth over the recorded collectives, each at the
    rate of its group's span (inside a node or across nodes)."""
    st = 0.0
    for r in records:
        if r.ranks:
            st += r.wire_bytes / (NVLINK_BW if node_local(r.ranks)
                                  else NIC_BW)
    return st


def backbone_forward(model, cfg, batch: dict) -> None:
    """One backbone forward (no logits, no loss) of a placed batch on this
    rank's rows, and its block of the sequence under the ``"seq"`` rule:
    the decoder's ``backbone``, or whisper's encoder and decoder
    (``serve.engine.prefill_hidden``)."""
    with torch.no_grad():
        prefill_hidden(model, cfg, batch, remat="none")


def collectives_by_tag(records) -> dict:
    """``{tag: {kind: {"count", "result_bytes"}}}`` of the recorded
    collectives: each site's share (``sp_kv``, ``fsdp_gather``, ...)."""
    out: dict = {}
    for r in records:
        if r.ranks:
            c = out.setdefault(r.tag, {}).setdefault(
                r.kind, {"count": 0, "result_bytes": 0})
            c["count"] += 1
            c["result_bytes"] += r.result_bytes
    return out


def _stats(records) -> dict:
    st = collective_stats(records)
    return {k: {"count": v[0], "result_bytes": v[1], "wire_bytes": v[2]}
            for k, v in st.by_kind.items()}


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

# rwkv's WKV recurrence runs its steps one by one, and on meta tensors a
# step of a layer costs ~30 ms (PyTorch's meta kernels are Python): a 4k
# train cell would take ~50 min, a 32k prefill hours.  With no attention
# its counts are polynomials of degree <= 2 in the sequence length S:
# FLOPs, collective bytes and argument bytes affine, the unfused bytes
# quadratic (the backward of each step's slice writes a zero tensor of the
# whole sequence), counts of collectives constant.  Its long cells run at
# three short lengths and each number is read off the parabola through
# them.  Two are not polynomials and are estimates (the result's notes
# say so): the peak live bytes, on the line through the two longest runs,
# and the matmuls' duplication, the longest run's.  The cost and the peak
# follow the block of the sequence a rank runs: under a sequence split
# over m ranks the runs are m times POLY_SEQ's lengths, so that each
# rank's block is POLY_SEQ's (shorter blocks leave the peak on the
# optimizer's, not on the line).  Where the WKV heads are split over the
# model axis that cuts the sequence (Megatron sequence parallelism) each
# rank scans its model group's blocks (the whole sequences, or under
# context parallelism a super-block), and the runs are POLY_SEQ's times
# the super-blocks: a rank's blocks are too short to put the peak on the
# line, so such a cell's peak is not predicted (None), and the runs are
# checked to have run a WKV state fold exactly where there is more than
# one super-block (rwkv_block's dispatch, not scan_blocks', decides).
POLY_FAMILIES = ("rwkv",)
POLY_SEQ = (32, 64, 128)


def seq_blocks(rules: dict, mesh, seq: int) -> int:
    """The number of blocks the ``"seq"`` rule cuts a sequence of ``seq``
    into on ``mesh`` (1 where it is whole or not divided)."""
    axes = rules.get("seq")
    names = () if axes is None else (axes,) if isinstance(axes, str) \
        else tuple(axes)
    m = 1
    for a in names:
        if a in mesh.mesh_dim_names:
            m *= mesh.shape[mesh.mesh_dim_names.index(a)]
    return m if seq % m == 0 else 1


def scan_blocks(cfg, rules: dict, mesh, seq: int) -> int:
    """The number of blocks of a sequence of ``seq`` of which a rank's
    recurrence scans one: :func:`seq_blocks`'s, or, where the rwkv
    family's heads (its ``"ff"`` rule) are split over the model axis that
    cuts the sequence and the model axis divides them, the number of the
    model groups' super-blocks (each rank then scans its model group's
    blocks for its heads: the whole sequences where the model axis alone
    cuts them)."""
    m = seq_blocks(rules, mesh, seq)

    def names(axes):
        return () if axes is None else (axes,) if isinstance(axes, str) \
            else tuple(axes)
    M = mesh.shape[mesh.mesh_dim_names.index("model")] \
        if "model" in mesh.mesh_dim_names else 1
    if m > 1 and cfg.family == "rwkv" and names(rules.get("ff")) == \
            ("model",) and "model" in names(rules.get("seq")) and \
            (cfg.d_model // cfg.rwkv_head_dim) % M == 0:
        return m // M
    return m


def _extrapolate(runs: list, seqs: tuple, seq: int) -> dict:
    """The result at ``seq`` from the results at ``seqs`` (three lengths):
    every number of the counted keys on the parabola through them
    (Lagrange), counts of collectives checked constant."""
    weights = []
    for i, si in enumerate(seqs):
        w = 1.0
        for j, sj in enumerate(seqs):
            if j != i:
                w *= (seq - sj) / (si - sj)
        weights.append(w)

    def curve(*vals):
        a = vals[0]
        if isinstance(a, dict):
            return {k: curve(*(v[k] for v in vals)) for k in a}
        if isinstance(a, bool) or not isinstance(a, (int, float)):
            return a
        v = sum(w * x for w, x in zip(weights, vals))
        return int(round(v)) if isinstance(a, int) else v

    first = runs[0]
    for kind, c in first["collectives"].items():
        got = [r["collectives"][kind]["count"] for r in runs]
        if len(set(got)) != 1:
            raise RuntimeError(f"{first['arch']}: {kind} counts {got} at "
                               f"seq {list(seqs)}: not constant")
    out = dict(first)
    for key in ("hlo_flops_per_dev", "hlo_bytes_per_dev",
                "collective_wire_bytes_per_dev", "t_collective_s",
                "memory_analysis", "collectives", "forward_collectives",
                "collectives_by_tag"):
        if key in first:
            out[key] = curve(*(r[key] for r in runs))
    (s1, t1), (s2, t2) = [(s, r["memory_analysis"]["temp_size_bytes"])
                          for s, r in zip(seqs[-2:], runs[-2:])]
    out["memory_analysis"]["temp_size_bytes"] = int(round(
        t1 + (t2 - t1) * (seq - s1) / (s2 - s1)))
    out["remat_dot_duplication"] = runs[-1]["remat_dot_duplication"]
    out["remat_note"] = f"the run at seq {seqs[-1]}'s"
    out["t_compute_s"] = out["hlo_flops_per_dev"] / PEAK_FLOPS
    out["t_memory_s"] = out["hlo_bytes_per_dev"] / HBM_BW
    terms = {k: out[f"t_{k}"] for k in ("compute_s", "memory_s",
                                         "collective_s")}
    out["dominant"] = max(terms, key=terms.get)
    out["compile_s"] = round(sum(r["compile_s"] for r in runs), 1)
    out["memory_analysis"]["temp_size_note"] = (
        f"{first['memory_analysis']['temp_size_note']}; on the line through "
        f"the runs at seq {list(seqs[-2:])}: an estimate")
    out["extrapolated_from_seq"] = list(seqs)
    return out


def lower_cell(arch: str, shape: str, *, multi_pod: bool = False,
               opt_name: str = "adafactor", remat: str = "dots",
               rule_overrides: dict | None = None, mesh=None,
               keep_hlo: bool = False, cfg=None, params=None, batch=None,
               loss: str = "lm", forward_collectives: bool = False,
               opt=None, rules: dict | None = None):
    """Run one rank's step of one (arch × shape × mesh) cell on meta
    tensors in a fake world of the mesh's size.  Returns the reference's
    result dict (its keys, the port's numbers).

    ``mesh`` is an :class:`AbstractMesh` (default the production mesh).
    Beyond the reference's arguments, for holding a cell against a real
    world: ``cfg`` (a config in place of ``get_config(arch)``),
    ``params`` (a meta model in place of the bf16 one), ``batch`` (meta
    tensors in place of ``specs.batch_specs_for``), ``loss`` (``"lm"`` or
    ``"sig_mmd"``), ``opt`` (an optimizer in place of ``opt_name``'s
    default), ``rules`` (in place of ``rules_for``'s) and
    ``forward_collectives`` (also log one backbone forward's
    collectives).  ``keep_hlo`` keeps the collective log's records.

    An rwkv train or prefill cell whose blocks a rank are longer than
    ``POLY_SEQ[-1]`` tokens runs at the three lengths of ``POLY_SEQ``
    times the number of blocks a rank's scan runs one of
    (:func:`scan_blocks`) and is extrapolated (``extrapolated_from_seq``
    in the result: the runs' lengths); where a rank scans whole sequences
    of a cut one its peak (``temp_size_bytes``) is None."""
    cfg = cfg if cfg is not None else get_config(arch)
    ok, why = SP.cell_is_runnable(arch, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "skipped": why}
    amesh = mesh if mesh is not None else production_mesh(multi_pod)
    if rules is None:
        rules = rules_for(arch, shape, rule_overrides)
    kind = SP.SHAPES[shape]["kind"]
    seq = SP.SHAPES[shape]["seq"]
    blocks = scan_blocks(cfg, rules, amesh, seq)
    lengths = tuple(s * blocks for s in POLY_SEQ)
    if cfg.family in POLY_FAMILIES and kind != "decode" and batch is None \
            and params is None and seq > lengths[-1]:
        runs = []
        for s_short in lengths:
            name = f"{shape}@seq{s_short}"
            SP.SHAPES[name] = dict(SP.SHAPES[shape], seq=s_short)
            try:
                runs.append(lower_cell(
                    arch, name, mesh=mesh, multi_pod=multi_pod,
                    opt_name=opt_name, remat=remat, cfg=cfg, loss=loss,
                    forward_collectives=forward_collectives, opt=opt,
                    rules=rules))
            finally:
                del SP.SHAPES[name]
        if ("sp_state" in runs[0]["collectives_by_tag"]) != (blocks > 1):
            raise RuntimeError(
                f"{arch}: the WKV scan ran {'' if blocks > 1 else 'no '}"
                f"state fold where scan_blocks gives {blocks} blocks: the "
                f"dry run's runs do not follow rwkv_block's dispatch")
        res = _extrapolate(runs, lengths, seq)
        if blocks < seq_blocks(rules, amesh, seq):
            mem = res["memory_analysis"]
            mem["temp_size_bytes"] = None
            mem["temp_size_note"] = (
                f"not predicted: a rank scans its model group's "
                f"{list(POLY_SEQ)} tokens of runs of {list(lengths)}, "
                f"its block of them {seq_blocks(rules, amesh, seq) // blocks}"
                f" times shorter, and at those lengths the peak sits on the "
                f"weights' temporaries, not on the gathered rows")
        model_flops = SP.flops_estimate(cfg, shape)
        res.update(shape=shape, model_flops_global=model_flops,
                   useful_flops_ratio=model_flops / max(
                       res["hlo_flops_per_dev"] * res["devices"], 1.0))
        return res
    t0 = time.time()
    dmesh = device_mesh(amesh)
    model = params if params is not None else SP.params_specs_for(cfg)
    MP.shard_model(model, dmesh, rules)
    param_bytes = tree_bytes(model)
    opt_bytes = 0
    C.LOG.reset()
    with sharding_ctx(dmesh, rules):
        if kind == "train":
            if opt is None:
                opt = adafactor() if opt_name == "adafactor" else adamw()
            state = SP.opt_state_specs_for(opt, model)
            opt_bytes = tree_bytes(state)
            placed = place_batch(batch if batch is not None
                                 else SP.batch_specs_for(cfg, shape))
            args_bytes = param_bytes + opt_bytes + tree_bytes(placed)
            step = make_train_step(cfg, opt, remat=remat, loss=loss)
            with CostCounter() as cost:
                _, _, metrics = step(model, state, placed)
            out_bytes = param_bytes + opt_bytes + tree_bytes(metrics)
        elif kind == "prefill":
            placed = place_batch(batch if batch is not None
                                 else SP.batch_specs_for(cfg, shape))
            args_bytes = param_bytes + tree_bytes(placed)
            step = make_prefill_step(cfg, remat=remat)
            with CostCounter() as cost:
                logits = step(model, placed)
            out_bytes = tree_bytes(logits)
        else:  # decode: this rank's blocks of the cache, updated in place
            tokens, cache, gen = SP.decode_inputs_for(cfg, shape)
            args_bytes = param_bytes + tree_bytes(cache) + tree_bytes(tokens)
            step = make_serve_step(cfg)
            with CostCounter() as cost:
                nxt, cache = step(model, cache, tokens, gen)
            out_bytes = tree_bytes(nxt) + tree_bytes(cache)
        step_records = list(C.LOG.records)
        fwd = None
        if forward_collectives and kind != "decode":
            C.LOG.reset()
            backbone_forward(model, cfg, placed)
            fwd = _stats(C.LOG.records)
    t_compile = time.time() - t0
    n_dev = amesh.size()
    coll = collective_stats(step_records)
    flops, bytes_accessed = cost.flops, cost.bytes
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_accessed / HBM_BW
    t_coll = collective_seconds(step_records)
    model_flops = SP.flops_estimate(cfg, shape)
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    temp_note = ("peak live bytes of the step's intermediate tensors "
                 "(operation outputs, views excluded), counted on meta "
                 "tensors")
    if kind != "decode" and rules.get("seq") is not None:
        what = "prompt" if kind == "prefill" else "sequence"
        temp_note += (f", of this rank's block of the {what} (the 'seq' "
                      f"rule), the whole {what}'s keys and values gathered "
                      f"a layer")
    result = {
        "arch": arch, "shape": shape, "kind": kind,
        "mesh": "x".join(map(str, amesh.shape)),
        "axes": list(amesh.mesh_dim_names), "devices": n_dev,
        "compile_s": round(t_compile, 1),
        "hlo_flops_per_dev": flops,
        "hlo_bytes_per_dev": bytes_accessed,
        "collective_wire_bytes_per_dev": coll.total_wire_bytes,
        "collectives": _stats(step_records),
        "collectives_by_tag": collectives_by_tag(step_records),
        "collective_bw": axis_bandwidth(amesh),
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops_global": model_flops,
        "useful_flops_ratio": model_flops / max(flops * n_dev, 1.0),
        "remat_dot_duplication": duplication(cost.matmuls),
        "memory_analysis": {
            "argument_size_bytes": args_bytes,
            "output_size_bytes": out_bytes,
            "temp_size_bytes": cost.peak_bytes,
            "temp_size_note": temp_note,
            "generated_code_size_bytes": None,
            "generated_code_note": "no compiled code: the port runs eager",
            "param_bytes": param_bytes,
            "opt_state_bytes": opt_bytes if kind == "train" else None,
        },
        "opt": opt_name if kind == "train" else None,
        "remat": remat if kind != "decode" else None,
        "rules": {k: str(v) for k, v in rules.items()},
        "executed_rules": {k: str(v) for k, v in rules.items()},
    }
    if fwd is not None:
        result["forward_collectives"] = fwd
    if keep_hlo:
        result["hlo_text"] = "\n".join(
            f"{r.kind} tag={r.tag} bytes={r.result_bytes} "
            f"group={r.group_size}" for r in step_records if r.ranks)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run launcher")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(SP.SHAPES)} or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="run single-pod AND multi-pod for each cell")
    ap.add_argument("--opt", default="adafactor",
                    choices=["adafactor", "adamw"])
    ap.add_argument("--remat", default="dots",
                    choices=["dots", "full", "none"])
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--override", default="",
                    help='rules merged into rules_for\'s, as JSON: '
                         '\'{"seq": "model"}\' cuts every sequence over '
                         'the model axis')
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    override = json.loads(args.override) if args.override else None
    if override:
        override = {k: tuple(v) if isinstance(v, list) else v
                    for k, v in override.items()}

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SP.SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)

    n_fail = 0
    try:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
                    if override:
                        tag += "__" + "_".join(f"{k}-{v}" for k, v in
                                               sorted(override.items()))
                    try:
                        res = lower_cell(arch, shape, multi_pod=mp,
                                         opt_name=args.opt, remat=args.remat,
                                         rule_overrides=override)
                    except Exception as e:  # a dry-run failure is a bug
                        n_fail += 1
                        res = {"arch": arch, "shape": shape, "error": str(e),
                               "traceback": traceback.format_exc()}
                        print(f"[FAIL] {tag}: {e}", flush=True)
                    with open(os.path.join(args.out, tag + ".json"),
                              "w") as f:
                        json.dump(res, f, indent=2)
                    if "error" not in res:
                        if res.get("skipped"):
                            print(f"[SKIP] {tag}: {res['skipped']}",
                                  flush=True)
                        else:
                            mem = res["memory_analysis"]
                            print(f"[OK]   {tag} compile={res['compile_s']}s "
                                  f"temp={mem['temp_size_bytes']} "
                                  f"dom={res['dominant']} "
                                  f"tc={res['t_compute_s']:.3e} "
                                  f"tm={res['t_memory_s']:.3e} "
                                  f"tx={res['t_collective_s']:.3e}",
                                  flush=True)
                            if args.verbose:
                                print(json.dumps(res, indent=2))
    finally:
        close_world()
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
