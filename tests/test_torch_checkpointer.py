"""The port's ``Checkpointer`` and session-pool checkpoints against the
reference's.

Mirrors the checkpoint cases of ``tests/test_sessions.py``: carries, ragged
batches and whole session pools round-trip bit-identically through
``repro_torch.checkpoint``; the on-disk format is the reference's
(``manifest.json`` + ``shard_0.npz`` with arrays ``a0..``, leaves in the
order ``jax.tree_util`` flattens ``{"params": tree, "opt_state": {}}``),
checked against ``jax.tree_util.tree_leaves`` and by saving in one package
and restoring in the other.  A pool the reference saved restores into the
port with equal lanes, and both stores then agree on the same further
traffic (values rtol 2e-4, atol 2e-5; host metadata exactly).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.core import stream as js
from repro.data import session_tick_stream as j_ticks
from repro.ragged import RaggedPaths as JRagged
from repro.serve import SessionStore as JStore
from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.checkpoint.checkpointer import _flatten
from repro_torch.convert import (backend_from_reference,
                                 dtype_from_reference,
                                 stream_carry_from_reference)
from repro_torch.core import stream as ts
from repro_torch.data import session_tick_stream
from repro_torch.ragged import RaggedPaths
from repro_torch.serve import SessionStore

TOL = dict(rtol=2e-4, atol=2e-5)
LANES = ("sig", "ring", "length", "end", "valid")


def _pools(seed=0, d=3, depth=3, n=5, R=8):
    """The same pooled carry in both packages: per-row counts, one row
    dead."""
    x = (np.random.default_rng(seed).normal(size=(n, 3, d)) * 0.3).astype(
        np.float32)
    counts = np.array([3, 0, 2, 3, 1][:n], np.int32)
    ours = ts.stream_init(n, d, depth, capacity=R, valid=True, device="cpu")
    ours = ts.stream_extend(ours, torch.from_numpy(x),
                            counts=torch.from_numpy(counts), backend="torch")
    ref = js.stream_extend(js.stream_init(n, d, depth, capacity=R,
                                          valid=True),
                           jnp.asarray(x), counts=jnp.asarray(counts))
    return ours, ref


def test_flatten_order_is_the_references():
    ours, ref = _pools()
    view = ts.signature_stream_init(2, 3, 3, capacity=4, device="cpu")
    jview = js.signature_stream_init(2, 3, 3, capacity=4)
    tree = {"params": {"pool": ours, "view": view, "w": [torch.ones(2),
                                                        None]},
            "opt_state": {"b": torch.zeros(1), "a": (torch.ones(3),)}}
    jtree = {"params": {"pool": ref, "view": jview, "w": [jnp.ones(2),
                                                          None]},
             "opt_state": {"b": jnp.zeros(1), "a": (jnp.ones(3),)}}
    leaves, _ = _flatten(tree)
    jleaves = jax.tree_util.tree_leaves(jtree)
    assert [tuple(x.shape) for x in leaves] == \
        [tuple(x.shape) for x in jleaves]
    # a StreamCarry flattens as sig, ring, length, end, valid
    names = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p[0].name for p, _ in names] == list(LANES)
    for got, want in zip(_flatten(ours)[0], jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_format_is_shared(writer, tmp_path):
    ours, ref = _pools()
    extra = {"kind": "model", "note": [1, 2]}
    if writer == "port":
        Checkpointer(str(tmp_path), async_save=False).save(
            {"pool": ours, "step": torch.tensor(7)}, {}, 3, extra=extra)
        got, _, got_extra = JCheckpointer(str(tmp_path)).restore(
            {"pool": js.stream_init(5, 3, 3, capacity=8),
             "step": jnp.zeros((), jnp.int32)}, {})
        want = ours
        got_lanes = {k: np.asarray(getattr(got["pool"], k)) for k in LANES}
        want_lanes = {k: getattr(want, k).numpy() for k in LANES}
    else:
        JCheckpointer(str(tmp_path), async_save=False).save(
            {"pool": ref, "step": jnp.asarray(7)}, {}, 3, extra=extra)
        got, _, got_extra = Checkpointer(str(tmp_path)).restore(
            {"pool": ts.stream_init(5, 3, 3, capacity=8, device="cpu"),
             "step": torch.zeros((), dtype=torch.int64)}, {})
        assert isinstance(got["pool"], ts.StreamCarry)
        assert got["pool"].length.dtype == torch.int32
        assert got["pool"].valid.dtype == torch.bool
        got_lanes = {k: getattr(got["pool"], k).numpy() for k in LANES}
        want_lanes = {k: np.asarray(getattr(ref, k)) for k in LANES}
    for k in LANES:
        np.testing.assert_array_equal(got_lanes[k], want_lanes[k],
                                      err_msg=k)
    assert int(got["step"]) == 7 and got_extra == extra
    manifest = json.loads((tmp_path / "step_3" / "manifest.json")
                          .read_text())
    assert manifest["n_leaves"] == 6
    assert sorted(np.load(tmp_path / "step_3" / "shard_0.npz").files) == \
        sorted(f"a{i}" for i in range(6))


def test_stream_carry_checkpoint_roundtrip(tmp_path):
    d, depth = 3, 3
    rng = np.random.default_rng(0)
    ck = Checkpointer(str(tmp_path), async_save=False)
    state = ts.signature_stream_init(4, d, depth, capacity=8, device="cpu")
    state = state.extend(torch.from_numpy(
        rng.normal(size=(4, 6, d)).astype(np.float32)), backend="torch")
    pooled, _ = _pools()
    ck.save({"view": state, "pool": pooled}, {}, 1)
    like = {"view": ts.signature_stream_init(4, d, depth, capacity=8,
                                             device="cpu"),
            "pool": ts.stream_init(5, d, depth, capacity=8, device="cpu")}
    got, _, _ = ck.restore(like, {})
    for lane in ("sig", "ring"):
        assert torch.equal(getattr(got["view"], lane), getattr(state, lane))
    for lane in LANES:
        assert torch.equal(getattr(got["pool"], lane),
                           getattr(pooled, lane)), lane
    assert (got["pool"].d, got["pool"].depth) == (d, depth)
    # host-int occupancy is static: it comes from the template
    assert got["view"].length == 0


def test_ragged_paths_checkpoint_roundtrip_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    paths = [rng.normal(size=(L + 1, 2)).astype(np.float32)
             for L in (3, 7, 5)]
    rp = JRagged.from_list(paths, pad_to=8)
    JCheckpointer(str(tmp_path), async_save=False).save(rp, {}, 3)
    like = RaggedPaths.from_list(paths, pad_to=8, device="cpu")
    got, _, _ = Checkpointer(str(tmp_path)).restore(
        RaggedPaths(torch.zeros_like(like.values),
                    torch.zeros_like(like.lengths)), {})
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(rp.values))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(rp.lengths))


def test_async_save_keep_and_template_checks(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for step in (1, 2, 5):
        ck.save({"w": torch.full((2,), float(step))}, {}, step)
    ck.wait()
    assert latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_5"]
    got, _, _ = ck.restore({"w": torch.zeros(2)}, {})
    assert got["w"].tolist() == [5.0, 5.0]
    got, _, _ = ck.restore({"w": torch.zeros(2)}, {}, step=2)
    assert got["w"].tolist() == [2.0, 2.0]
    with pytest.raises(ValueError, match="template shape"):
        ck.restore({"w": torch.zeros(3)}, {})
    with pytest.raises(ValueError, match="template has 2 leaves"):
        ck.restore({"w": torch.zeros(2), "v": torch.zeros(1)}, {})
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).peek_extra()
    assert latest_step(str(tmp_path / "none")) is None


def test_converters():
    _, ref = _pools()
    carry = stream_carry_from_reference(ref, 3, 3, device="cpu")
    lanes = stream_carry_from_reference(
        {k: np.asarray(getattr(ref, k)) for k in LANES}, 3, 3, device="cpu")
    for k in LANES:
        np.testing.assert_array_equal(getattr(carry, k).numpy(),
                                      np.asarray(getattr(ref, k)))
        assert torch.equal(getattr(carry, k), getattr(lanes, k))
    assert carry.length.dtype == torch.int32 and carry.valid.dtype == \
        torch.bool
    assert [backend_from_reference(b) for b in ("jax", "pallas", "auto",
                                                "torch")] == \
        ["torch", "auto", "auto", "torch"]
    assert dtype_from_reference(str(np.dtype(jnp.float32))) == torch.float32
    assert dtype_from_reference("bfloat16") == torch.bfloat16
    with pytest.raises(ValueError, match="unknown dtype"):
        dtype_from_reference("float33")


# ---------------------------------------------------------------------------
# session pools
# ---------------------------------------------------------------------------

def _play(store, traffic, rounds):
    for _ in range(rounds):
        r = next(traffic)
        store.ingest_many(r["sids"], r["counts"], r["ticks"],
                          auto_create=True)
        store.flush()


def _resume(store, traffic, d):
    """One more round of ``traffic`` for the sessions ``store`` holds."""
    r = next(traffic)
    keep = [i for i, s in enumerate(r["sids"]) if s in store]
    chunks = np.split(r["ticks"], np.cumsum(r["counts"])[:-1])
    if keep:
        store.ingest_many([r["sids"][i] for i in keep], r["counts"][keep],
                          np.concatenate([chunks[i] for i in keep]))
        store.flush()


def _same(ours, ref, exact=False):
    for lane in LANES:
        got = getattr(ours.pool, lane).numpy()
        want = np.asarray(getattr(ref.pool, lane))
        if lane == "sig" and not exact:
            np.testing.assert_allclose(got, want, **TOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=lane)
    assert ours._ids == ref._ids and ours._free == ref._free
    assert ours.now == ref.now
    for arr in ("_generation", "_length", "_end", "_valid"):
        np.testing.assert_array_equal(getattr(ours, arr), getattr(ref, arr))
    for k in ("evictions", "created", "updates", "flushes", "pool_sizes",
              "flush_shapes", "dropped_ticks"):
        assert ours.stats()[k] == ref.stats()[k], k


def test_session_store_checkpoint_restart_resume(tmp_path):
    d, depth = 3, 3
    ck = Checkpointer(str(tmp_path), async_save=False)
    store = SessionStore(d, depth, ring_capacity=512, initial_sessions=4,
                         ttl=100.0, backend="torch", device="cpu")
    traffic = session_tick_stream(12, d, seed=3)
    _play(store, traffic, 3)
    store.evict(next(iter(store._ids)))      # a freed slot must round-trip
    store.ingest(next(iter(store._ids)), np.ones((2, d), np.float32))
    store.checkpoint(ck, step=5)             # flushes the pending ticks
    assert store.pending_ticks == 0

    restored = SessionStore.restore(ck, device="cpu")
    _same(restored, store, exact=True)
    assert restored.backend == "torch" and restored.dtype == torch.float32
    for sid in store._ids:
        assert store.lookup(sid) == restored.lookup(sid)

    tr2 = session_tick_stream(12, d, seed=3)
    tr2.restore(traffic.state())
    _resume(store, traffic, d)
    _resume(restored, tr2, d)
    _same(restored, store, exact=True)
    h = restored.create("fresh")
    assert h.sid in restored
    restored.evict("fresh")


def test_session_store_restore_rejects_non_pool_checkpoint(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save({"w": torch.zeros((2, 2))}, {}, 1, extra={"kind": "model"})
    with pytest.raises(ValueError, match="not a session pool"):
        SessionStore.restore(ck, device="cpu")


@pytest.mark.parametrize("ring", [0, 64])
def test_reference_pool_restores_into_the_port(ring, tmp_path):
    d, depth = 3, 3
    kw = dict(ring_capacity=ring, initial_sessions=4, ttl=50.0)
    ref = JStore(d, depth, backend="jax", **kw)
    traffic = j_ticks(16, d, seed=5, arrival_rate=1.0, churn_prob=0.05,
                      max_ticks=16)
    for _ in range(3):
        r = next(traffic)
        ref.ingest_many(r["sids"], r["counts"], r["ticks"],
                        auto_create=True)
        for sid in r["departures"]:
            if sid in ref:
                ref.evict(sid)
        ref.flush()
    ref.checkpoint(JCheckpointer(str(tmp_path), async_save=False), step=9)

    ours = SessionStore.restore(Checkpointer(str(tmp_path)), device="cpu")
    assert ours.backend == "torch"           # the reference's "jax" engine
    _same(ours, ref, exact=True)
    assert ours.stats()["evictions"]["explicit"] > 0

    # both stores agree on the same further traffic
    ours_traffic = session_tick_stream(16, d, seed=5, arrival_rate=1.0,
                                       churn_prob=0.05, max_ticks=16)
    ours_traffic.restore(traffic.state())
    for _ in range(2):
        for store, tr in ((ref, traffic), (ours, ours_traffic)):
            r = next(tr)
            if ring:             # keep every ring within its capacity
                for sid, c in zip(r["sids"], r["counts"]):
                    if sid in store and store.length(sid) + c > ring:
                        store.drop_block([sid], store.length(sid) + int(c)
                                         - ring)
            store.ingest_many(r["sids"], r["counts"], r["ticks"],
                              auto_create=True)
            store.flush()
    _same(ours, ref)
