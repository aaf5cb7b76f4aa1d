"""Rank bodies of ``tests/test_torch_distributed.py``: gloo CPU worlds of
P ranks running the port's mesh path.

Imported by the spawned ranks, so it imports ``torch`` and ``repro_torch``
only (never ``jax`` or ``repro``).  The parent passes numpy inputs in and
gets numpy results back: gathered values and gradients summed over the
ranks, which it holds against the reference's single-device results.
"""
from __future__ import annotations

import os
import traceback

import numpy as np

B, M, D_IN, DEPTH = 7, 9, 2, 3
WORDS = ((0,), (1, 0), (0, 1, 1))
CELLS = [(bw, st, ln) for bw in ("inverse", "checkpoint", "autodiff")
         for st in (False, True) for ln in (False, True)
         if not (st and bw == "checkpoint")]


def card_patch():
    """Run the dispatch's cuda cells on CPU tensors through the kernels'
    autograd nodes, their launches replaced by the plain versions (the
    ``card`` fixtures of the single-device tests)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import sig_trunc as st
    from repro_torch.kernels import sig_words as sw
    resolve = ops.resolve_backend
    ops.resolve_backend = lambda backend, device: (
        "cuda" if backend == "auto" else resolve(backend, device))

    def trunc_launch(incs, depth, split, stream, stride, precision,
                     plan=None, transform=None, taux=None):
        storage = st._storage_dtype(precision)
        out = st.sig_trunc_plain(incs.detach().to(storage).float(), depth,
                                 stream=stream, stream_stride=stride,
                                 transform=transform, taux=taux)
        return out.to(storage) if stream else out

    def words_launch(incs, tplan, stream, stride, precision, plan=None,
                     transform=None, taux=None):
        return sw.sig_words_plain(incs.detach().float(), tplan,
                                  stream=stream, stream_stride=stride,
                                  transform=transform, taux=taux)

    st._launch, sw._launch = trunc_launch, words_launch

    def sig_trunc(x, depth, *, split=None, stream=False, stream_stride=1,
                  precision="fp32", transform=None, taux=None, **_):
        return st.SigTruncFunction.apply(x, depth, split, stream,
                                         stream_stride, precision, transform,
                                         taux).to(x.dtype)

    def sig_words(x, tplan, *, stream=False, stream_stride=1,
                  precision="fp32", closure=None, transform=None, taux=None):
        return sw.SigWordsFunction.apply(x, tplan, stream, stream_stride,
                                         precision, closure, transform,
                                         taux).to(x.dtype)

    ops.sig_trunc, ops.sig_words = sig_trunc, sig_words


def _value_grad(fn, x, group, *, grad: bool = True):
    """fn(x) under the installed context -> (gathered value, dL/dx) for
    L = Σ fn(x)², the gradient of the replicated input summed over the
    ranks (None with ``grad=False``: the inference-only entry)."""
    import torch
    from repro_torch.distributed import batch as DB
    from repro_torch.distributed import collectives as C
    xs = torch.from_numpy(x).requires_grad_(grad)
    out = fn(xs)
    if not grad:
        return DB.gather_rows(out).numpy(), None
    loss = C.reduce_sum((DB.to_local(out).double() ** 2).sum(), group)
    loss.backward()
    g = C.all_reduce_(xs.grad.clone(), group)
    return DB.gather_rows(out).detach().numpy(), g.numpy()


def dispatch_cases(mesh, inputs: dict) -> dict:
    """Every dispatch cell on the torch engine and on the cuda cells (CPU
    tensors, plain launches), under the context: values and gradients."""
    import torch
    from repro_torch.distributed import sharding_ctx
    from repro_torch.kernels import ops
    x, lens, x0 = inputs["x"], inputs["lens"], inputs["x0"]
    group = mesh.get_group()
    out = {}
    with sharding_ctx(mesh):
        for route in ("torch", "card"):
            be = "torch" if route == "torch" else "auto"
            for bw, st, ln in CELLS:
                kw = dict(backend=be, backward=bw, stream=st,
                          stream_stride=3, device="cpu",
                          lengths=torch.from_numpy(lens) if ln else None)
                out[f"sig/{route}/{bw}/{st}/{ln}"] = _value_grad(
                    lambda a, kw=kw: ops.signature(a, DEPTH, **kw), x, group)
                out[f"proj/{route}/{bw}/{st}/{ln}"] = _value_grad(
                    lambda a, kw=kw: ops.projected(a, WORDS, **kw), x, group)
            tf = dict(transform="time_augment+lead_lag",
                      lengths=torch.from_numpy(lens), backend=be,
                      device="cpu")
            out[f"sig/{route}/transform"] = _value_grad(
                lambda a: ops.signature(a, 2, **tf), x, group)
            bp = dict(transform="basepoint+lead_lag",
                      x0=torch.from_numpy(x0), backend=be, device="cpu")
            out[f"sig/{route}/basepoint"] = _value_grad(
                lambda a: ops.signature(a, 2, **bp), x, group)
            out[f"proj/{route}/transform"] = _value_grad(
                lambda a: ops.projected(a, inputs["tf_words"], **tf), x,
                group)
            out[f"fwd/{route}"] = _value_grad(
                lambda a: ops.projected_forward_only(
                    a, WORDS, backend=be, device="cpu",
                    lengths=torch.from_numpy(lens)), x, group, grad=False)
            out[f"fwd/{route}/transform"] = _value_grad(
                lambda a: ops.projected_forward_only(
                    a, inputs["tf_words"], transform="time_augment+lead_lag",
                    backend=be, device="cpu"), x, group, grad=False)
        out["sig/card/time_chunks"] = _value_grad(
            lambda a: ops.signature(a, DEPTH, backend="auto", time_chunks=2,
                                    device="cpu"), x, group)
        for bw in ("inverse", "checkpoint", "autodiff"):
            out[f"proj/hybrid/{bw}"] = _value_grad(
                lambda a, bw=bw: ops.projected(a, WORDS, backend="hybrid",
                                               backward=bw, device="cpu"),
                x, group)
        out["fwd/hybrid"] = _value_grad(
            lambda a: ops.projected_forward_only(a, WORDS, backend="hybrid",
                                                 device="cpu"), x, group,
            grad=False)
    return out


def gram_cases(mesh, inputs: dict) -> dict:
    """The Gram ring (values, the three gradients, the communication
    record and the analytic counters) and the sharded sig-MMD."""
    import torch
    from repro_torch import obs
    from repro_torch.distributed import batch as DB
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import collective_stats, sharding_ctx
    from repro_torch.distributed.hlo import ring_overlap
    from repro_torch.kernels import ops
    from repro_torch.sigkernel import sig_mmd
    group = mesh.get_group()
    out = {}
    Sx, Sy, w = inputs["Sx"], inputs["Sy"], inputs["w"]
    obs.enable()
    for route in ("torch", "card"):
        be = "torch" if route == "torch" else "auto"
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (Sx, Sy, w)]
        obs.reset()
        C.LOG.reset()
        with sharding_ctx(mesh):
            G = ops.gram(*ts, backend=be, device="cpu")
            stats = collective_stats()
            overlap = ring_overlap()
            C.reduce_sum((DB.to_local(G).double() ** 2).sum(),
                         group).backward()
        grads = [C.all_reduce_(t.grad.clone(), group) for t in ts]
        ctr = obs.counter("pathsig_ring_wire_bytes_total", "", ("ctx",))
        nper = obs.counter("pathsig_ring_ppermute_total", "", ("ctx",))
        out[f"gram/{route}"] = dict(
            value=DB.gather_rows(G).detach().numpy(),
            grads=[g.numpy() for g in grads],
            by_kind={k: list(v) for k, v in stats.by_kind.items()},
            overlap=(overlap.n_permutes, overlap.n_dots, overlap.overlapped),
            wire_counter=ctr.value(ctx="eager"),
            permute_counter=nper.value(ctx="eager"))
    obs.disable()
    X = torch.from_numpy(inputs["X"]).requires_grad_(True)
    Y = torch.from_numpy(inputs["Y"])
    xl = torch.from_numpy(inputs["xl"])
    with sharding_ctx(mesh):
        for route in ("torch", "card"):
            be = "torch" if route == "torch" else "auto"
            X.grad = None
            m = sig_mmd(X, Y, DEPTH, backend=be, x_lengths=xl, device="cpu")
            m.backward()
            out[f"mmd/{route}"] = (float(m), C.all_reduce_(
                X.grad.clone(), group).numpy())
    return out


def checkpoint_cases(mesh, ckpt_dir: str) -> dict:
    """``Checkpointer.restore(shardings=)``: each rank's block of a sharded
    leaf, a replicated leaf whole."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import named_sharding, sharding_ctx
    a = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    b = torch.arange(5, dtype=torch.float32)
    ck = Checkpointer(ckpt_dir, async_save=False)
    if dist.get_rank() == 0:
        ck.save({"a": a, "b": b}, {}, 1)
    dist.barrier()
    with sharding_ctx(mesh):
        sh = {"params": {"a": named_sharding("batch", None),
                         "b": named_sharding(None)}, "opt_state": {}}
    params, _, _ = ck.restore({"a": a, "b": b}, {}, 1, shardings=sh)
    r, P = mesh.get_local_rank(), mesh.size()
    per = 8 // P
    return {"ckpt_block": bool(torch.equal(params["a"].to_local(),
                                           a[r * per:(r + 1) * per])),
            "ckpt_replicated": bool(torch.equal(params["b"], b))}


def batcher_cases(mesh, inputs: dict) -> dict:
    """A mesh-placed ``DynamicBatcher``: answers, rungs and stats."""
    from repro_torch.serve import DynamicBatcher
    out = {}
    for route in ("torch", "card"):
        db = DynamicBatcher.signature_service(
            2, DEPTH, max_len=64, backend="torch" if route == "torch"
            else "auto", min_bucket=8, max_batch=16, device="cpu",
            mesh=mesh)
        tickets = [db.submit(r) for r in inputs["requests"]]
        res = db.flush()
        st = db.stats()
        out[f"batcher/{route}"] = dict(
            answers=np.stack([res[t].numpy() for t in tickets]),
            devices=st["devices"], rows_per_device=st["rows_per_device"],
            occupancy=st["occupancy"], shapes=st["shapes"],
            padded_rows=db.padded_rows)
    return out


def session_script(store, ticks: list, extend: np.ndarray) -> dict:
    """One fixed sequence of pool operations (creates past the initial
    pool, so it grows; ingests, flushes, a streamed block extend, a drop
    and an evict) on either package's ``SessionStore``; -> the features,
    lengths and the streamed block features."""
    sids = [f"u{i}" for i in range(6)]
    store.create_many(sids)
    for i, t in enumerate(ticks):
        store.ingest(sids[i % 6], t)
    store.flush()
    feats = np.asarray(store.extend_block(sids[:4], extend,
                                          return_stream=True))
    store.drop_block(sids[:4], 2)
    store.evict(sids[5])
    store.ingest(sids[0], ticks[0])
    store.flush()
    return {"features": np.stack([np.asarray(store.features(s))
                                  for s in sids[:5]]),
            "block": np.asarray(store.block_features(sids[:5])),
            "lengths": [store.length(s) for s in sids[:5]],
            "stream": feats,
            "stats": {k: store.stats()[k] for k in
                      ("sessions", "pool_size", "flush_shapes")}}


def session_cases(mesh, inputs: dict, ckpt_dir: str,
                  restore_from: str | None) -> dict:
    """The sharded pool against the script, its checkpoint, and a restore
    of another world's checkpoint onto this mesh (and onto no mesh)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.serve import SessionStore
    from repro_torch.distributed import batch as DB
    store = SessionStore(2, DEPTH, ring_capacity=16, initial_sessions=4,
                         backend="torch", device="cpu", mesh=mesh)
    out = {"sessions": session_script(store, inputs["ticks"],
                                      inputs["extend"])}
    out["sessions_devices"] = store.stats()["devices"]
    pool_sig = DB.gather_rows(store.pool.sig).numpy()
    out["sessions_pool_sig"] = pool_sig
    ck = Checkpointer(ckpt_dir, async_save=False)
    store.checkpoint(ck, 1)
    sids = [f"u{i}" for i in range(5)]
    if restore_from is not None:
        back = SessionStore.restore(Checkpointer(restore_from), mesh=mesh,
                                    device="cpu")
        out["restored_here"] = np.stack(
            [back.features(s).numpy() for s in sids])
    single = SessionStore.restore(ck, device="cpu")   # no mesh: P = 1
    out["restored_single"] = np.stack(
        [single.features(s).numpy() for s in sids])
    return out


def trainer_cases(mesh, inputs: dict) -> dict:
    """Three data-parallel steps of each loss through ``make_train_step``
    with placed batches, and the sig-MMD ``train_loop`` under the
    context."""
    import dataclasses
    import torch
    from repro_torch import configs as tconfigs
    from repro_torch import optim as toptim
    from repro_torch import train as ttrain
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.distributed import sharding_ctx
    from repro_torch.optim.optimizers import named
    cfg = tconfigs.with_sig_head(
        tconfigs.reduce_config(tconfigs.get_config("qwen3-4b")),
        channels=inputs["channels"], depth=2)
    out = {}

    def tb(b):
        return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}

    for loss in ("lm", "sig_mmd"):
        model = lm_params_from_reference(inputs["params"], cfg, device="cpu")
        opt = toptim.sgd(lr=0.05)
        state = opt.init(model)
        step = ttrain.make_train_step(cfg, opt, loss=loss)
        hist = []
        with sharding_ctx(mesh):
            for b in inputs["batches"][loss]:
                model, state, m = step(model, state,
                                       ttrain.place_batch(tb(b)))
                hist.append({k: float(v) for k, v in m.items()})
        out[f"train/{loss}"] = dict(
            history=hist, params={k: v.detach().numpy() for k, v in
                                  named(model).items()})
    model = lm_params_from_reference(inputs["params"], cfg, device="cpu")
    loop = ttrain.TrainLoopConfig(steps=3, log_every=1, loss="sig_mmd",
                                  run_dir="")
    with sharding_ctx(mesh):
        trained, _, hist = ttrain.train_loop(
            cfg, model, toptim.sgd(lr=0.05),
            iter([tb(b) for b in inputs["batches"]["sig_mmd"]]), loop)
    out["train_loop/sig_mmd"] = dict(
        history=[h["loss"] for h in hist],
        params={k: v.detach().numpy() for k, v in named(trained).items()})
    del dataclasses
    return out


def launcher_case() -> dict:
    """``launch.train --mesh 2x1`` over this world's two gloo ranks."""
    from repro_torch.launch import train as train_cli
    from repro_torch.optim.optimizers import named
    params, m = train_cli.main(
        ["--arch", "qwen3-4b", "--reduced", "--device", "cpu", "--batch",
         "2", "--seq", "8", "--steps", "2", "--log-every", "1", "--mesh",
         "2x1"])
    return {"launcher": (float(m["loss"]), float(sum(
        v.double().sum() for v in named(params).values())))}


def compression_case(group, inputs: dict, rank: int) -> dict:
    import torch
    from repro_torch.optim import int8_error_feedback_allreduce
    g = {k: torch.from_numpy(v[rank]) for k, v in inputs["ef_grads"].items()}
    e = {k: torch.from_numpy(v[rank]) for k, v in inputs["ef_errors"].items()}
    red, new_e = int8_error_feedback_allreduce(g, e, group)
    return {"ef": ({k: v.numpy() for k, v in red.items()},
                   {k: v.numpy() for k, v in new_e.items()})}


def rank_main(rank: int, world: int, store_path: str, inputs: dict,
              dirs: dict, queue) -> None:
    """One rank of a gloo world: every case, results on ``queue``.  An
    exception goes to the queue as its traceback (the parent fails)."""
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        os.environ.setdefault("PATHSIG_AUTOTUNE", "off")
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        card_patch()
        from repro_torch.launch.mesh import make_sig_mesh
        mesh = make_sig_mesh(device="cpu")
        out = {}
        out.update(dispatch_cases(mesh, inputs))
        out.update(gram_cases(mesh, inputs))
        out.update(checkpoint_cases(mesh, dirs["ckpt"]))
        out.update(batcher_cases(mesh, inputs))
        out.update(session_cases(mesh, inputs, dirs["sessions"],
                                 dirs.get("restore_from")))
        out.update(compression_case(mesh.get_group(), inputs, rank))
        if world == 2:
            out.update(trainer_cases(mesh, inputs))
            out.update(launcher_case())
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
        raise
