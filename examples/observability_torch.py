"""End-to-end observability walkthrough on the PyTorch/CUDA port: trace +
meter every layer.

The port of ``examples/observability.py``.  One run exercises all four
instrumented layers of the stack and leaves two artefacts behind:

- a Chrome-trace JSON (open in ``chrome://tracing`` / ui.perfetto.dev)
  containing spans from **kernel dispatch** (``kernels.signature``),
  the **gram ring** over a world of 2 gloo ranks (``kernels.gram_ring``),
  a **serve flush** (``serve.batcher.flush``, ``serve.sessions.flush``),
  and **train steps** (``train.step``);
- a metrics snapshot (JSON) with nonzero launch-shape / build counts
  (``pathsig_jit_traces_total``, the reference's compile and retrace
  counter), plan-cache accounting, and autotune outcomes.

The reference fakes an 8-device mesh inside one process.  The port has no
such mesh: the ring layer spawns a world of 2 gloo ranks (sharing the card,
or on the CPU under ``--device cpu``), and rank 0's ring spans and counters
are merged into this process's trace and registry.  On the card the
autotuner runs in ``sweep`` mode on a throwaway cache, so the walkthrough
shows sweep -> hit; on the CPU the torch engine has no partition to tune,
and every consultation is counted with the outcome ``torch_engine``.

Run:  PYTHONPATH=src python examples/observability_torch.py [--device cpu]
      PATHSIG_TRACE=trace.json PYTHONPATH=src python \\
          examples/observability_torch.py
      PYTHONPATH=src python examples/observability_torch.py --check

Defaults land under ``runs/`` (gitignored); ``PATHSIG_TRACE`` /
``PATHSIG_METRICS`` override the artefact paths.  ``--check`` asserts the
acceptance conditions (spans from all four layers, nonzero launch-shape /
plan-cache / autotune / ring counters, launch shapes within bound) and
exits nonzero on violation.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import queue
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

LAYER_SPANS = {
    "kernel dispatch": ("kernels.signature",),
    "gram ring": ("kernels.gram_ring",),
    "serve flush": ("serve.batcher.flush", "serve.sessions.flush"),
    "train step": ("train.step",),
}
RING_WORLD = 2
# rank 0's instruments merged into this process's registry
RING_METRICS = ("pathsig_ring_ppermute_total", "pathsig_ring_wire_bytes_total",
                "pathsig_hlo_collectives_total",
                "pathsig_hlo_collective_wire_bytes_total")


def artefact_paths() -> tuple[str, str]:
    trace = os.environ.get("PATHSIG_TRACE", "runs/observability_trace.json")
    snap = os.environ.get("PATHSIG_METRICS", "")
    if snap.lower() in ("", "0", "1", "on", "off", "true", "false", "yes",
                        "no"):
        snap = "runs/observability_metrics.json"
    return trace, snap


@contextlib.contextmanager
def scoped_env(**values):
    """Set environment variables for a block and restore them after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def kernel_layer(rng, dev) -> None:
    """Dispatch cells + autotune + launch-shape accounting."""
    print("== kernel dispatch ==")
    x = torch.as_tensor(rng.normal(size=(8, 12, 2)).astype(np.float32) * 0.1,
                        device=dev)
    # 1st call in sweep mode: autotune measures the cell (outcome="sweep"),
    # 2nd call: outcome="hit"; the shape is counted at its first launch.
    for _ in range(2):
        ops.signature(x, 3, device=dev)
    # a second shape: a new launch shape, labelled with its shape key
    ops.signature(x[:, :7], 3, device=dev)
    # the cost of the route this device runs (the kernels on the card, the
    # torch engine on the CPU) and of the other, counted on meta tensors:
    # nothing is built, launched or run
    routes = ("cuda", "torch") if dev.type == "cuda" else ("torch", "cuda")
    for route in routes:
        cost = obs.record_cost(f"signature.{route}", lambda a: ops.signature(
            a, 3, backend=route), x)
        print(f"  lowered cost ({route} route): {cost['flops']:.0f} flops, "
              f"{cost['bytes']:.0f} bytes")


def _ring_rank(rank: int, store: str, sx: np.ndarray, device,
               results) -> None:
    """One rank of the ring layer: the gram ring under a 1-axis mesh and
    its collective accounting; rank 0 sends its spans and counters."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding_ctx
    from repro_torch.distributed.hlo import collective_stats
    from repro_torch.launch.mesh import make_sig_mesh
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, RING_WORLD),
                            rank=rank, world_size=RING_WORLD)
    try:
        obs.enable()
        t_start = time.perf_counter()
        obs.start_trace()
        mesh = make_sig_mesh(device=dev)
        Sx = torch.as_tensor(sx, device=dev)
        w = torch.ones(sx.shape[1], device=dev)
        C.LOG.reset()
        with sharding_ctx(mesh):
            G = ops.gram(Sx, Sx, w, device=dev)
        stats = collective_stats(tag="gram_ring")
        obs.record_collectives("gram_ring", stats)
        obs.stop_trace()
        mets = obs.snapshot()["metrics"]
        out = {"shape": tuple(G.shape), "t_start": t_start,
               "events": obs.TRACER.events,
               "by_kind": {k: v[0] for k, v in stats.by_kind.items()},
               "metrics": {n: mets[n] for n in RING_METRICS if n in mets}}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        results.put(out)


def ring_layer(rng, dev) -> tuple[float, list]:
    """The gram send/recv ring over a world of 2 gloo ranks + collective
    accounting.  Returns rank 0's trace start and its events."""
    print(f"== gram ring ({RING_WORLD}-rank world) ==")
    sx = rng.normal(size=(16, 15)).astype(np.float32)
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_ring_rank, args=(
            r, os.path.join(tmp, "store"), sx, str(dev), q))
            for r in range(RING_WORLD)]
        for p in procs:
            p.start()
        got = None
        try:
            # drain rank 0's result before joining; stop waiting once a
            # rank has failed
            while got is None and not any(p.exitcode for p in procs):
                try:
                    got = q.get(timeout=5)
                except queue.Empty:
                    pass
        finally:
            for p in procs:
                p.join(timeout=120)
    codes = [p.exitcode for p in procs]
    if got is None or codes != [0] * RING_WORLD:
        raise SystemExit(f"ring ranks exited {codes}")
    for name, m in got["metrics"].items():
        for row in m["values"]:
            labels = row["labels"]
            obs.counter(name, m["help"], tuple(labels)).inc(row["value"],
                                                           **labels)
    print(f"  ring G shape {got['shape']}; collectives: {got['by_kind']}")
    return got["t_start"], got["events"]


def serve_layer(rng, dev) -> None:
    """A batcher flush and a session-pool flush."""
    print("== serve ==")
    from repro_torch.serve import DynamicBatcher
    from repro_torch.serve.sessions import SessionStore
    db = DynamicBatcher.signature_service(2, 3, max_len=32, min_bucket=8,
                                          device=dev)
    for L in (3, 9, 17, 5, 30):
        db.submit(np.cumsum(rng.normal(size=(L + 1, 2)).astype(np.float32),
                            axis=0))
    res = db.flush()
    st = db.stats()
    print(f"  batcher: {len(res)} requests, {st['compiled_shapes']} shapes, "
          f"occupancy {st['occupancy']:.0%}")

    store = SessionStore(2, 3, initial_sessions=8, device=dev)
    handles = [store.create() for _ in range(5)]
    for h in handles:
        store.ingest(h, rng.normal(size=(4, 2)).astype(np.float32))
    store.flush()
    store.evict(handles[0])
    ss = store.stats()
    print(f"  sessions: {ss['sessions']} live, "
          f"p50 staleness {ss['p50_staleness_s'] * 1e3:.2f} ms, "
          f"evictions {ss['evictions']}")


def train_layer(dev) -> None:
    """A traced mini train loop (sig-MMD loss through the dispatch)."""
    print("== train ==")
    import repro_torch.models as M
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models.sig_head import SigHeadConfig
    from repro_torch.optim import adamw
    from repro_torch.train import TrainLoopConfig, train_loop

    cfg = reduce_config(get_config("qwen3-4b"))
    cfg = dataclasses.replace(cfg, sig_head=SigHeadConfig(depth=3,
                                                          channels=2))
    loop = TrainLoopConfig(steps=3, log_every=1, loss="sig_mmd",
                           run_name="observability",
                           straggler_deadline_s=60.0)

    def make_iter(seed=0):
        rng = np.random.default_rng(seed)
        while True:
            yield {"tokens": torch.as_tensor(rng.integers(
                       1, cfg.vocab_size, (8, 16)), dtype=torch.int32,
                       device=dev),
                   "paths": torch.as_tensor(np.cumsum(rng.normal(
                       size=(8, 17, 2)).astype(np.float32), 1) * 0.3,
                       device=dev)}

    params = M.init_params(0, cfg, torch.float32, device=dev)
    _, _, hist = train_loop(cfg, params, adamw(lr=1e-3), make_iter(), loop)
    print(f"  {len(hist)} logged steps; loss {hist[-1]['loss']:.4f}; "
          f"run log under runs/observability.jsonl")


def merge_rank_trace(trace_path: str, t_main: float, t_rank: float,
                     events: list) -> None:
    """Append a rank's events to the written trace, on this process's
    clock (``perf_counter`` is one monotonic clock across processes)."""
    with open(trace_path) as f:
        doc = json.load(f)
    shift = (t_rank - t_main) * 1e6
    doc["traceEvents"] += [dict(ev, ts=ev["ts"] + shift) for ev in events]
    with open(trace_path, "w") as f:
        json.dump(doc, f)
        f.write("\n")


def check(trace_path: str, snap_path: str, on_card: bool) -> int:
    """CI smoke assertions over the two artefacts; returns an exit code."""
    doc = json.load(open(trace_path))
    names = {e["name"] for e in doc["traceEvents"]}
    failures = []
    for layer, spans in LAYER_SPANS.items():
        if not any(s in names for s in spans):
            failures.append(f"no {layer} span ({spans}) in {trace_path}")
    for ev in doc["traceEvents"]:
        if ev["ph"] == "X" and not ({"name", "ts", "dur", "pid", "tid"}
                                    <= set(ev)):
            failures.append(f"malformed trace event {ev}")
            break

    snap = json.load(open(snap_path))
    mets = snap["metrics"]

    def total(name, pred=lambda v: True):
        return sum(row["value"] for row in mets.get(
            name, {"values": []})["values"] if pred(row))

    if total("pathsig_jit_traces_total") <= 0:
        failures.append("zero launch-shape / build count")
    # the mini run must not launch any one site at more than 8 new shapes
    # (a storm means shape keys leak into the cells)
    for row in mets.get("pathsig_jit_traces_total", {"values": []})["values"]:
        if row["value"] > 8:
            failures.append(f"retrace storm: {row}")
    if total("pathsig_plan_cache",
             lambda r: r["labels"]["stat"] in ("hits", "misses")) <= 0:
        failures.append("zero plan-cache hit/miss accounting")
    outcomes = ("hit", "miss", "sweep") if on_card else ("torch_engine",)
    if total("pathsig_autotune_lookups_total",
             lambda r: r["labels"]["outcome"] in outcomes) <= 0:
        failures.append(f"zero autotune {'/'.join(outcomes)} outcomes")
    if total("pathsig_ring_ppermute_total") <= 0:
        failures.append("zero gram-ring ppermute count")
    for f in failures:
        print(f"CHECK FAIL: {f}", file=sys.stderr)
    print("check:", "FAIL" if failures else "OK")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--check", action="store_true",
                    help="assert the acceptance conditions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    trace_path, snap_path = artefact_paths()
    # a throwaway autotune cache, so the walkthrough shows sweep -> hit
    # without touching (or depending on) the repo-level cache
    with tempfile.TemporaryDirectory(prefix="pathsig_obs_") as tmp, \
            scoped_env(PATHSIG_AUTOTUNE="sweep",
                       PATHSIG_AUTOTUNE_CACHE=os.path.join(
                           tmp, "autotune.json")):
        was_enabled = obs.enabled()
        obs.enable()
        obs.reset()                     # this walkthrough's counts only
        t_main = time.perf_counter()
        if not obs.trace_active():      # PATHSIG_TRACE already started one
            obs.start_trace(trace_path)
        rng = np.random.default_rng(0)
        try:
            kernel_layer(rng, dev)
            t_rank, rank_events = ring_layer(rng, dev)
            serve_layer(rng, dev)
            train_layer(dev)
        finally:
            trace_path = obs.stop_trace(trace_path) or trace_path
        merge_rank_trace(trace_path, t_main, t_rank, rank_events)
        snap_path = obs.write_snapshot(snap_path)
        n_traces = sum(
            row["value"] for row in obs.snapshot()["metrics"]
            ["pathsig_jit_traces_total"]["values"])
        if not was_enabled:
            obs.disable()
    print(f"trace  -> {trace_path}\nmetrics -> {snap_path}")
    print(f"total launch shapes and builds this run: {n_traces:.0f}")
    if args.check:
        return check(trace_path, snap_path, dev.type == "cuda")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
