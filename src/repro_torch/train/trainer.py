"""Training step and loop on one device (port of
``repro.train.trainer``): microbatch accumulation, remat, the
signature-MMD loss, checkpoint/restart, straggler-aware step timing and
the trainer's instruments.

The step differentiates with ``torch.autograd.grad`` and writes the
optimizer's update into the parameters and its state in place (the
reference donates both buffers to the jitted step).  The signature legs of
the sig-MMD loss and of the heads carry their own autograd Functions: on
the card each is a ``sig_trunc`` (or ``sig_words``) launch forward and a
``sig_sweep`` launch backward, and the Gram products ``sig_gram`` launches.

Data parallelism: run :func:`train_loop` inside ``sharding_ctx(mesh)``
(:mod:`repro_torch.distributed.ctx`) on every rank and it goes SPMD.  The
parameters and optimizer state are replicated (:func:`replicate_tree`
broadcasts them from the mesh's first rank), every batch is placed with
:func:`repro_torch.distributed.sharding.batch_specs` (:func:`place_batch`:
the "batch" logical axis split over the mesh's data axes), and each rank
runs the model on its own rows.  The loss is the global loss on every
rank: the LM loss weights each rank's token mean by its share of the
tokens and sums over the ranks, and the sig-MMD loss runs its signatures
on each rank's rows and its Grams as the cross-rank ring
(:mod:`repro_torch.kernels.ops`).  Each rank's backward yields its own
rows' share of every parameter's gradient, and the step sums the shares
over the ranks (one all-reduce a parameter), so every rank takes the
single-device step.  A placed batch is what makes a step data-parallel;
outside any context nothing changes.

Model parallelism: on a ``("data", "model")`` mesh (``make_dev_mesh``)
:func:`train_loop` lays the model out by ``param_specs``
(:func:`repro_torch.distributed.model_parallel.shard_model`): tensor,
expert and FSDP parallel, the optimizer slots shards too.  The step then
reduces each gradient by its parameter's spec: an FSDP shard's gradient
is already summed over the data ranks by its reduce-scatter, one
replicated over the data axis is all-reduced over the data group, and a
model-axis block is this rank's alone.  The gradient norm (and AdamW's
clip) is the norm of the whole gradient.  The MoE aux loss and dispatch
groups are the global batch's (:func:`repro_torch.distributed.batch.
rows_scope`).  The signature head and sig-MMD run on the data axis: the
hidden states leave the backbone replicated over the model group, every
rank of a model group computes the same head, and the Gram ring runs over
the data subgroup.

Under the reference's ``seq: "model"`` rule (``launch.dryrun.rules_for``'s
train cells whose batch 256 does not divide, or any cell's override) each
rank runs its rows and its block of every sequence, forward and backward,
the blocks exchanging activations differentiably
(``model_parallel.seq_gather``); layers whose heads, ``ff`` or experts
the model axis also splits gather the model group's rows and
reduce-scatter their output (Megatron-LM's sequence parallelism,
``model_parallel.seq_tp``; under ``seq: ("data", "model")``, context
parallelism, the model group's super-block).  The LM loss
weights each rank's token mean over every rank that holds different
tokens (``distributed.batch.shard_group``); the sig-MMD loss projects each
block, gathers the whole path over the sequence's group (each rank keeps
its block's gradient) and only then strides, scales and measures it, so
every rank of the group computes the same MMD.  Each gradient is summed by
:func:`reduce_grads`.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import math
import os
import time
import warnings
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from .. import models as M
from .. import obs
from ..distributed import batch as DB
from ..distributed import collectives as C
from ..distributed import model_parallel as MP
from ..distributed.ctx import axis_names, current_mesh, current_rules
from ..models.config import ModelConfig
from ..optim import Optimizer, global_norm
from ..optim.optimizers import named, norm_scope


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0                 # 0 = only at exit
    ckpt_dir: str = ""
    microbatch: int = 0                 # 0 = no accumulation
    remat: str = "dots"
    grad_compression: bool = False      # int8 EF over cross-pod axis
    straggler_deadline_s: float = 0.0   # 0 = disabled; see train_loop
    sig_backend: str = ""               # "" = honour cfg.sig_head.backend;
    sig_backward: str = ""              # else override the engine dispatch
    loss: str = "lm"                    # "lm" | "sig_mmd" (distribution match)
    run_dir: str = "runs"               # default JSONL run-log dir ("" = no
    run_name: str = ""                  # default sink); "" names by time
    # SLO enforcement (repro_torch.obs.slo): active when slos or
    # slo_callback is set.  Objectives are evaluated over the trailing
    # slo_window steps at the slo_every cadence (0 = log_every); slos=()
    # uses obs.train_slos().  The callback (if any) gets (step, report) at
    # every evaluation; on a breached report a "warn" action warns, while
    # slo_action="abort" (or the callback returning "abort") raises
    # SloBreach.
    slos: tuple = ()
    slo_every: int = 0
    slo_window: int = 64
    slo_action: str = "warn"            # "warn" | "abort"
    slo_callback: Optional[Callable[[int, dict], Any]] = None


def _apply_sig_overrides(cfg: ModelConfig, sig_backend: str,
                         sig_backward: str) -> ModelConfig:
    """Override the sig head's engine-dispatch routing so a launch config
    can pin the trained path to a backend."""
    if cfg.sig_head is None or not (sig_backend or sig_backward):
        return cfg
    sc = cfg.sig_head
    if sig_backend:
        sc = dataclasses.replace(sc, backend=sig_backend)
    if sig_backward:
        sc = dataclasses.replace(sc, backward=sig_backward)
    return dataclasses.replace(cfg, sig_head=sc)


def make_sig_mmd_loss(cfg: ModelConfig):
    """Distribution-matching loss (``TrainLoopConfig.loss="sig_mmd"``): the
    unbiased signature-MMD² between the model's learned hidden-state paths
    and reference paths in ``batch["paths"]`` (B_ref, S'+1, channels).

    The generated sample is the backbone's hidden trajectory projected to
    ``cfg.sig_head.channels`` dims (through ``params["sig_head"]["proj"]``
    when present, else the leading channels) and normalised as
    :func:`repro_torch.models.sig_head._learned_path` does.  Ragged batches:
    ``batch["mask"]`` (B, S right-padded) ends each generated trajectory at
    its true end, ``batch["path_lengths"]`` (B_ref,) makes the reference
    sample ragged.
    """
    sc = cfg.sig_head
    if sc is None:
        raise ValueError("loss='sig_mmd' needs cfg.sig_head (depth/channels/"
                         "backend of the matched path distribution)")
    if cfg.family == "encdec":
        raise ValueError("loss='sig_mmd' matches decoder-style hidden "
                         "trajectories (decoder/rwkv/hybrid families); the "
                         "encdec family has no single backbone trajectory")
    from ..models import transformer as T
    from ..models.sig_head import normalise_path
    from ..sigkernel import sig_mmd

    def loss_fn(params, batch, remat):
        # a placed batch (DTensors): the backbone runs on this rank's rows
        # (and its block of the sequence under the "seq" rule) and the
        # paths go back to the batch layout's rows for the sharded MMD
        placed = batch.get("tokens", batch.get("embeds"))
        # the aux loss over the global batch
        hidden, aux, seq = T.placed_backbone(params, cfg, batch, remat)
        hp = params.get("sig_head")
        if hp is not None and "proj" in hp:
            path = (hidden @ hp["proj"].to(hidden.dtype)).float()
        else:
            path = hidden[..., :sc.channels].float()
        mask = DB.to_local(batch.get("mask"))
        if seq is not None:
            # the whole path on every rank of the group, which computes the
            # same MMD from it: the backward keeps this block's rows
            path = MP.gather_from(path, seq, dim=1, tag="sp_path")
            if mask is not None:
                mask = C.all_gather(mask, seq.group, dim=1, tag="sp_mask")
        lengths = None
        if mask is None:
            path = normalise_path(path, sc)
        else:
            path, lengths = normalise_path(path, sc, mask)
        ref = DB.whole_seq(batch["paths"], tag="sp_paths")
        mmd = sig_mmd(DB.rows_like(path, placed),
                      DB.rows_like(DB.to_local(ref).float(), ref), sc.depth,
                      backend=sc.backend, backward=sc.backward,
                      x_lengths=None if lengths is None
                      else DB.rows_like(lengths, placed),
                      y_lengths=batch.get("path_lengths"),
                      device=path.device)
        loss = mmd + aux
        return loss, {"loss": loss, "sig_mmd": mmd, "aux": aux}

    return loss_fn


def _placed_lm_loss(params, cfg: ModelConfig, batch: dict, remat: str):
    """The LM loss of a placed batch: each rank's token mean (and z-loss)
    weighted by its share of the valid tokens, summed over the ranks that
    hold different tokens (``DB.shard_group``: its rows' axes and, under
    the ``"seq"`` rule, its sequence's), plus the aux loss, which the MoE
    layers already take over the global batch: the loss of the whole batch
    on every rank.  A rank whose tokens are all ignored adds nothing."""
    group = DB.shard_group(_placed(batch))
    total, m = M.loss_fn(params, cfg, batch, remat=remat)
    valid = (DB.to_local(batch["labels"]) >= 0).sum().to(m["ntok"].dtype)
    ntok = torch.clamp(C.all_reduce_(valid, group, tag="loss"), min=1.0)
    share = m["ntok"].detach() / ntok
    aux = torch.as_tensor(m.get("aux", 0.0), dtype=total.dtype,
                          device=total.device)
    total = C.reduce_sum((total - aux) * share, group, tag="loss") + aux
    loss = C.all_reduce_(m["loss"].detach() * share, group, tag="loss")
    return total, {"loss": loss, "aux": aux.detach(), "ntok": ntok}


def _resolve_loss(cfg: ModelConfig, loss: str):
    """loss name -> fn(params, batch, remat) -> (loss, metrics); shared by
    the train and eval steps so both score the trained objective."""
    if loss == "sig_mmd":
        return make_sig_mmd_loss(cfg)
    if loss == "lm":
        def lm(params, batch, remat):
            if _placed(batch) is not None:
                return _placed_lm_loss(params, cfg, batch, remat)
            return M.loss_fn(params, cfg, batch, remat=remat)
        return lm
    raise ValueError(f"unknown loss {loss!r}; expected 'lm' or 'sig_mmd'")


def _placed(batch: dict):
    """The leaf that lays a placed batch out (its tokens or embeds, else
    its first DTensor), None for a plain batch."""
    for v in (batch.get("tokens"), batch.get("embeds"), *batch.values()):
        if DB.is_dtensor(v):
            return v
    return None


def reduce_grads(grads: dict, params, placed) -> dict:
    """Each rank's gradients of a loss of the placed batch whose layout the
    DTensor ``placed`` gives -> the step's gradients of this rank's
    parameter blocks, by :func:`~repro_torch.distributed.model_parallel.
    grad_reduction`: summed over the axes that split the batch (its rows,
    and its sequence under the ``"seq"`` rule), where the parameter's own
    backward has not summed them (an FSDP shard's reduce-scatter, a
    vocabulary block's exchanges), and a sum over ranks that computed the
    same share divided out.  ``placed`` None is a batch whole on every
    rank of the sharded model's mesh (no axis splits it: a rule that
    keeps the rows whole, with a sequence the split does not divide), so
    only the FSDP reduce-scatters' sums of equal shares are divided
    out."""
    layout = MP.placements(params) \
        if isinstance(params, torch.nn.Module) else {}
    if placed is None:
        mesh, axes = MP.model_mesh(params), ()
    else:
        mesh, axes = placed.device_mesh, DB.shard_axes(placed)
    out = {}
    for k, g in grads.items():
        rest, over = MP.grad_reduction(layout.get(k), mesh, axes)
        if over > 1:
            g = g / over
        if rest:
            g = C.all_reduce_(g, DB.batch_mesh(mesh, rest).get_group(),
                              tag="grads")
        out[k] = g
    return out


def replicate_tree(tree, mesh):
    """Make every tensor of ``tree`` (a model, or dicts, lists and tuples
    of tensors) the same on every rank of ``mesh``: each is broadcast in
    place from the mesh's first rank.  Returns ``tree``."""
    group = DB.batch_mesh(mesh, axis_names(mesh)).get_group()   # every rank
    if isinstance(tree, torch.nn.Module):
        tensors = list(named(tree).values())
    else:
        from ..distributed.sharding import _leaves_with_path
        tensors = [t for _, t in _leaves_with_path(tree)
                   if isinstance(t, torch.Tensor)]
    with torch.no_grad():
        for t in tensors:
            C.broadcast_(t, 0, group, tag="replicate")
    return tree


def place_batch(batch, mesh=None, rules=None):
    """Lay a batch (the whole batch, the same on every rank) out over the
    mesh by :func:`repro_torch.distributed.sharding.batch_specs`: the rows
    over the axes of the ``"batch"`` rule (the data axes), and under a
    ``"seq"`` rule (``launch.dryrun.rules_for``'s prefill and train
    cells) the sequence over its axes.  Sharded leaves become DTensors
    holding this rank's block (its rows, and its block of the sequence),
    replicated ones stay as they are (no-op without a mesh).  The prefill
    (``serve.engine.make_prefill_step``) and the train and eval steps run
    a block of a sequence; decoding refuses one.  Defaults come from the
    installed sharding context."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        return batch
    from ..distributed.sharding import batch_specs
    rules = current_rules() if rules is None else rules
    specs = batch_specs(batch, mesh, rules)
    return {k: specs[k].place(v) for k, v in batch.items()}


def _detached(metrics: dict) -> dict:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, opt: Optimizer, *, remat: str = "dots",
                    microbatch: int = 0, sig_backend: str = "",
                    sig_backward: str = "", loss: str = "lm"):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), ``params`` the model, updated in place.  With microbatch > 1
    the gradients are accumulated over ``microbatch`` slices of the batch
    (every batch entry split on its first axis), the loss is their mean
    and the metrics shrink to ``{loss, grad_norm}``.  ``grad_norm`` is the
    norm of the unclipped gradients.  ``sig_backend``/``sig_backward`` pin
    the signature head's engine dispatch; ``loss`` selects ``"lm"`` (token
    NLL) or ``"sig_mmd"`` (:func:`make_sig_mmd_loss`)."""
    cfg = _apply_sig_overrides(cfg, sig_backend, sig_backward)
    base_loss = _resolve_loss(cfg, loss)

    def grads_of(params, batch):
        tensors = named(params)
        loss_val, metrics = base_loss(params, batch, remat)
        grads = torch.autograd.grad(loss_val, list(tensors.values()),
                                    allow_unused=True)
        # a parameter the loss does not read has a zero gradient, as under
        # jax.grad
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(tensors.items(), grads)}
        return loss_val.detach(), _detached(metrics), grads

    def train_step(params, opt_state, batch):
        placed = _placed(batch)
        layout = MP.placements(params) \
            if isinstance(params, torch.nn.Module) else {}
        if microbatch and microbatch > 1:
            # microbatch i is the reference's contiguous slice of the
            # global batch, placed: DB.microbatches
            parts = {k: DB.microbatches(v, microbatch)
                     for k, v in batch.items()}
            acc, loss_sum = None, 0.0
            for i in range(microbatch):
                loss_val, _, grads = grads_of(
                    params, {k: v[i] for k, v in parts.items()})
                acc = grads if acc is None else {
                    k: acc[k] + g for k, g in grads.items()}
                loss_sum = loss_sum + loss_val
            grads = {k: g / microbatch for k, g in acc.items()}
            loss_val = loss_sum / microbatch
            metrics = {"loss": loss_val}
        else:
            loss_val, metrics, grads = grads_of(params, batch)
        if placed is not None or layout:
            # each rank holds its rows' (and block's) share of every
            # gradient; an FSDP shard's was summed by its reduce-scatter
            grads = reduce_grads(grads, params, placed)
        # a sharded model's norm (and AdamW's clip) is the whole gradient's
        with norm_scope((lambda g: MP.sharded_norm(g, params)) if layout
                        else None):
            gnorm = global_norm(grads)
            opt.update(grads, opt_state, params)
        metrics = dict(metrics, grad_norm=gnorm, loss=loss_val)
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, remat: str = "none", *,
                   loss: str = "lm", sig_backend: str = "",
                   sig_backward: str = ""):
    """Eval with the objective (and sig-head dispatch overrides) the model
    was trained with: loss='sig_mmd' evaluates the MMD statistic."""
    cfg = _apply_sig_overrides(cfg, sig_backend, sig_backward)
    base_loss = _resolve_loss(cfg, loss)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = base_loss(params, batch, remat)
        return metrics
    return eval_step


def _batch_key(batch: dict) -> tuple:
    return tuple((k, tuple(v.shape), str(v.dtype))
                 for k, v in sorted(batch.items()))


def train_loop(cfg: ModelConfig, params, opt: Optimizer, data_iter,
               loop: TrainLoopConfig, checkpointer=None, start_step: int = 0,
               on_metrics: Optional[Callable[[int, dict], None]] = None):
    """Reference loop with checkpoint/restart and a straggler guard.

    ``params`` is the model; the loop trains a copy of it, so the caller's
    module survives (the reference copies before its donated steps).
    Returns ``(params, opt_state, history)``.

    Fault tolerance: with a checkpointer, state is saved every
    ``ckpt_every`` steps and in ``finally``; ``start_step`` > 0 restores
    that step's checkpoint first.  The straggler guard flags steps slower
    than ``straggler_deadline_s``.

    Data parallelism: under an installed ``sharding_ctx(mesh)`` every rank
    calls the loop with the same data; the parameters are replicated,
    each batch is placed (:func:`place_batch`) and the gradients summed
    over the ranks (see the module docstring).  Rank 0 alone writes the
    default run log and the checkpoints.  On a mesh with a ``"model"``
    axis the parameters and optimizer slots are laid out by the specs
    instead (the returned model is sharded:
    ``model_parallel.gather_params`` gives its full arrays); checkpoints
    hold the full arrays, gathered on save and cut to the shards on
    restore.

    Observability: every log step goes to ``on_metrics`` (by default a
    JSONL sink under ``loop.run_dir``; ``run_dir=""`` disables).  Each
    step runs inside a ``train.step`` span, ticks the step-time histogram
    and straggler counter and sets the loss and grad-norm gauges; the
    first step of each new batch shape ticks
    ``pathsig_jit_traces_total{site="train_step"}`` (the reference's
    retrace).  SLOs (``loop.slos`` / ``loop.slo_callback``) are evaluated
    at the log cadence over the trailing window: breaches warn, call the
    callback and, with ``slo_action="abort"`` or a callback returning
    ``"abort"``, raise :class:`repro_torch.obs.slo.SloBreach`.  Any
    exception escaping a step dumps the flight recorder before the final
    checkpoint save runs.
    """
    mesh = current_mesh()          # data-parallel when a context is installed
    # one writer of the run log and the replicated state under a mesh
    writer = mesh is None or dist.get_rank() == 0
    if on_metrics is None and loop.run_dir and writer:
        name = loop.run_name or time.strftime("run-%Y%m%d-%H%M%S")
        on_metrics = obs.jsonl_sink(
            os.path.join(loop.run_dir, f"{name}.jsonl"))
    step_fn = make_train_step(cfg, opt, remat=loop.remat,
                              microbatch=loop.microbatch,
                              sig_backend=loop.sig_backend,
                              sig_backward=loop.sig_backward, loss=loop.loss)
    shapes_seen: set = set()
    params = copy.deepcopy(params)
    sharded = mesh is not None and "model" in axis_names(mesh)
    if mesh is not None:
        replicate_tree(params, mesh)
        if sharded:
            MP.shard_model(params, mesh, current_rules())
    opt_state = opt.init(params)
    if checkpointer is not None and start_step:
        if sharded:
            opt_state, _ = MP.restore_sharded(checkpointer, params,
                                              opt_state, start_step)
        else:
            tensors = named(params)
            restored, opt_state, _ = checkpointer.restore(
                tensors, opt_state, start_step)
            with torch.no_grad():
                for k, t in restored.items():
                    tensors[k].copy_(t)

    def save(step):
        if sharded:
            MP.save_sharded(checkpointer, params, opt_state, step,
                            write=writer)
        elif writer:
            checkpointer.save(named(params), opt_state, step)
    slo_active = bool(loop.slos) or loop.slo_callback is not None
    slo_specs = tuple(loop.slos) or obs.train_slos()
    slo_every = loop.slo_every or loop.log_every
    window = collections.deque(maxlen=max(1, loop.slo_window))
    history = []
    try:
        with obs.dump_on_error("train.loop"):
            for step in range(start_step, loop.steps):
                t0 = time.perf_counter()
                with obs.span("train.step", step=step):
                    batch = next(data_iter)
                    obs.compile.count_new_shape(
                        "train_step", shapes_seen, _batch_key(batch), batch)
                    if mesh is not None:
                        batch = place_batch(batch, mesh)
                    params, opt_state, metrics = step_fn(params, opt_state,
                                                         batch)
                    loss_val = float(metrics["loss"])    # honest timing
                dt = time.perf_counter() - t0
                straggler = bool(loop.straggler_deadline_s
                                 and dt > loop.straggler_deadline_s)
                if straggler:
                    metrics = dict(metrics, straggler=True)
                if obs.enabled():
                    obs.histogram("pathsig_train_step_seconds",
                                  "train step wall-clock "
                                  "(to the loss on the host)").observe(dt)
                    if straggler:
                        obs.counter(
                            "pathsig_train_stragglers_total",
                            "steps exceeding straggler_deadline_s").inc()
                    obs.gauge("pathsig_train_loss",
                              "last train-step loss").set(loss_val)
                    if "grad_norm" in metrics:
                        obs.gauge("pathsig_train_grad_norm",
                                  "last train-step global gradient norm"
                                  ).set(float(metrics["grad_norm"]))
                if slo_active:
                    window.append((dt, loss_val,
                                   float(metrics["grad_norm"])
                                   if "grad_norm" in metrics else 0.0))
                    if step % slo_every == 0 or step == loop.steps - 1:
                        _enforce_slos(loop, slo_specs, window, step)
                if step % loop.log_every == 0 or step == loop.steps - 1:
                    m = {k: float(v) if hasattr(v, "shape") else v
                         for k, v in metrics.items()}
                    m["step"], m["sec"] = step, dt
                    history.append(m)
                    if on_metrics:
                        on_metrics(step, m)
                if checkpointer is not None and loop.ckpt_every and step \
                        and step % loop.ckpt_every == 0:
                    save(step)
    finally:
        if checkpointer is not None:
            save(loop.steps)
    return params, opt_state, history


def _slo_window_values(window) -> dict:
    """Trailing-window observations for :func:`repro_torch.obs.slo.
    train_slos`: step-latency percentiles, worst grad norm, loss
    finiteness."""
    secs = sorted(dt for dt, _, _ in window)
    i99 = max(0, min(len(secs) - 1, math.ceil(0.99 * len(secs)) - 1))
    last_loss = window[-1][1]
    return {
        "step_s": window[-1][0],
        "step_p99_s": secs[i99],
        "loss": last_loss,
        "loss_finite": 1.0 if math.isfinite(last_loss) else 0.0,
        "grad_norm_max": max(g for _, _, g in window),
    }


def _enforce_slos(loop: TrainLoopConfig, slo_specs, window,
                  step: int) -> None:
    results = obs.evaluate_values(slo_specs, _slo_window_values(window))
    rep = obs.slo.report(results)
    action = None
    if loop.slo_callback is not None:
        action = loop.slo_callback(step, rep)
    if rep["status"] == "breach":
        msg = (f"train SLO breach at step {step}: "
               f"{', '.join(rep['breaches'])}")
        if loop.slo_action == "abort" or action == "abort":
            raise obs.SloBreach(msg)
        warnings.warn(msg, stacklevel=2)
