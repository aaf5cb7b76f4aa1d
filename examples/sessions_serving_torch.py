"""Multi-tenant session serving demo on the PyTorch/CUDA port: pooled
streams end to end.

The port of ``examples/sessions_serving.py``: the same traffic, pool and
printed lines.  On the card (the default) every flush bucket is one
``sig_trunc`` launch and the scoring block one ``sig_gram`` launch;
``--device cpu`` runs the plain PyTorch engine.

One `repro_torch.serve.SessionStore` holds every tenant's running window
signature as a row of a single struct-of-arrays device pool.  This demo
walks the full serving lifecycle:

1. bursty multi-tenant ingest (`repro_torch.data.session_tick_stream`
   traffic: heavy-tailed per-session rates + arrival/churn) delivered
   through continuous-batching `flush()` rounds — a bounded set of launch
   shapes no matter what the traffic does;
2. scoring live sessions against cached references (gather a block of
   session signatures, one Gram call);
3. checkpoint -> "restart" (a fresh process would do the same) ->
   restore -> resume: the pool comes back bit-identical and the replayed
   traffic continues as if the restart never happened.

The two bit-identity checks fail the run when they do not hold.

Run:  PYTHONPATH=src python examples/sessions_serving_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.core import tensor_ops as tops
from repro_torch.data import session_tick_stream
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.serve import SessionStore
from repro_torch.sigkernel import word_weights

D, DEPTH = 3, 3


def identical(a: SessionStore, b: SessionStore) -> bool:
    """Every live session's signature, bit for bit."""
    return all(torch.equal(a.features(s), b.features(s)) for s in a._ids)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1) pooled ingest: sessions auto-admitted on first tick ---------------
    store = SessionStore(D, DEPTH, initial_sessions=16, ttl=50.0, device=dev)
    traffic = session_tick_stream(40, D, seed=0, arrival_rate=1.5,
                                  churn_prob=0.02)
    for _ in range(6):
        r = next(traffic)
        store.ingest_many(r["sids"], r["counts"], r["ticks"],
                          auto_create=True)
        store.flush()
        for sid in r["departures"]:
            if sid in store:
                store.evict(sid)
    st = store.stats()
    print(f"pool: {st['sessions']} live sessions in {st['pool_size']} slots "
          f"(occupancy {st['occupancy']:.2f}), {st['updates']} ticks "
          f"applied in {st['flushes']} flushes")
    print(f"   compiled shapes: {st['compiled_shapes']} "
          f"(flush rungs {st['flush_shapes']}), "
          f"p99 staleness {st['p99_staleness_s']*1e3:.2f} ms, "
          f"evictions {st['evictions']}")

    # 2) score a block of live sessions against cached references ----------
    refs = np.cumsum(np.random.default_rng(7).standard_normal(
        (6, 33, D)).astype(np.float32) * 0.18, axis=1)
    ref_sigs = ops.signature(tops.path_increments(torch.as_tensor(
        refs, device=dev)), DEPTH, device=dev)
    w = torch.as_tensor(word_weights(D, DEPTH), device=dev)
    some = list(store._ids)[:5]
    K = ops.gram(store.block_features(some), ref_sigs, w, device=dev)
    nearest = torch.argmax(K, dim=-1).tolist()
    print(f"scored {len(some)} sessions x {refs.shape[0]} references: "
          f"nearest = {nearest}")

    # 3) checkpoint -> restart -> resume -----------------------------------
    with tempfile.TemporaryDirectory() as ckpt_dir:
        ck = Checkpointer(ckpt_dir, async_save=False)
        store.checkpoint(ck, step=1)
        resume_state = traffic.state()       # data pipeline state rides along

        restored = SessionStore.restore(ck, device=dev)  # a fresh process
    replay = session_tick_stream(40, D, seed=0, arrival_rate=1.5,
                                 churn_prob=0.02)
    replay.restore(resume_state)
    same_restored = identical(store, restored)
    print(f"restored {len(restored)} sessions bit-identical: "
          f"{same_restored}")

    for src, st_ in ((traffic, store), (replay, restored)):
        r = next(src)
        live = [s for s in r["sids"] if s in st_]
        keep = [i for i, s in enumerate(r["sids"]) if s in st_]
        chunks = np.split(r["ticks"], np.cumsum(r["counts"])[:-1])
        if live:
            st_.ingest_many(live, r["counts"][keep],
                            np.concatenate([chunks[i] for i in keep]))
            st_.flush()
    same_resumed = identical(store, restored)
    print(f"resumed both sides with the replayed round; still identical: "
          f"{same_resumed}")
    if not (same_restored and same_resumed):
        raise SystemExit(f"the restored pool is not bit-identical: restore "
                         f"{same_restored}, resume {same_resumed}")
    print("\nsessions serving OK — examples/ragged_serving_torch.py is the "
          "per-request (stateless) serving path")


if __name__ == "__main__":
    main()
