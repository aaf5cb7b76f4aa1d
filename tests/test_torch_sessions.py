"""The port's ``SessionStore`` and ``SessionTickStream`` against the
reference's.

Mirrors ``tests/test_sessions.py`` (all but its 8-device subprocess twin):
the same numpy ticks go through ``repro.serve.SessionStore`` (its ``jax``
engine) and ``repro_torch.serve.SessionStore`` (the torch engine on the
CPU), and on ``card`` through the port's ``cuda`` route on CPU tensors
with the ``sig_trunc`` launch replaced by its plain version and counted
(one launch a flush bucket).  Pool values rtol 2e-4, atol 2e-5; rings,
lengths, ends, liveness and the host metadata (ids, generations, free
list, evictions, flush shapes, launch-shape counts) must equal the
reference's exactly; errors must match in type and message.  The tick
stream is numpy only and must be bit-identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.signature import signature_from_increments as j_sig
from repro.data import session_tick_stream as j_ticks
from repro.serve import SessionStore as JStore
from repro_torch.core.signature import signature_from_increments
from repro_torch.data import SessionTickStream, session_tick_stream
from repro_torch.kernels import ops
from repro_torch.kernels import sig_trunc as st
from repro_torch.serve import SessionHandle, SessionStore

TOL = dict(rtol=2e-4, atol=2e-5)
LANES = ("sig", "ring", "length", "end", "valid")
STATS = ("sessions", "pool_size", "occupancy", "pool_sizes", "created",
         "evictions", "dropped_ticks", "updates", "flushes",
         "pending_sessions", "pending_ticks", "flush_shapes",
         "compiled_shapes", "devices", "now")


@pytest.fixture
def card(monkeypatch):
    """The dispatch's sig_trunc cells on CPU tensors, the launch replaced
    by the plain version; returns the launch counts."""
    n = dict(trunc=0, stream=0)
    resolve = ops.resolve_backend
    monkeypatch.setattr(ops, "resolve_backend", lambda backend, device:
                        "cuda" if backend == "auto" else resolve(backend,
                                                                 device))

    def launch(incs, depth, split, stream, stride, precision, plan=None,
               transform=None, taux=None):
        n["stream" if stream else "trunc"] += 1
        return st.sig_trunc_plain(incs.detach().float(), depth,
                                  stream=stream, stream_stride=stride)

    monkeypatch.setattr(st, "_launch", launch)
    monkeypatch.setattr(ops, "sig_trunc", lambda x, depth, *, split=None,
                        stream=False, stream_stride=1, precision="fp32",
                        transform=None, taux=None: st.SigTruncFunction.apply(
                            x, depth, split, stream, stream_stride,
                            precision, transform, taux).to(x.dtype))
    return n


def _pair(backend="torch", **kw):
    return (SessionStore(backend=backend, device="cpu", **kw),
            JStore(backend="jax", **kw))


def _same(ours, ref):
    """Pool lanes within tolerance (sig) or equal (the rest), host state
    equal."""
    for lane in LANES:
        got = getattr(ours.pool, lane).numpy()
        want = np.asarray(getattr(ref.pool, lane))
        if lane == "sig":
            np.testing.assert_allclose(got, want, **TOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=lane)
    assert ours._ids == ref._ids
    assert ours._free == ref._free
    for arr in ("_valid", "_length", "_end", "_generation", "_last_seen"):
        np.testing.assert_array_equal(getattr(ours, arr), getattr(ref, arr),
                                      err_msg=arr)
    so, sr = ours.stats(), ref.stats()
    for k in STATS:
        assert so[k] == sr[k], (k, so[k], sr[k])


def _oracle(chunks, depth):
    return signature_from_increments(
        torch.from_numpy(np.concatenate(chunks))[None], depth,
        backend="torch", device="cpu")[0].numpy()


def _play(store, rng, handles, rounds=3, top=12):
    truth = {h: [] for h in handles}
    for _ in range(rounds):
        for h in handles:
            if rng.random() < 0.3:
                continue                      # bursty: not everyone ticks
            inc = rng.normal(size=(int(rng.integers(1, top)), store.d)) \
                .astype(np.float32)
            store.ingest(h, inc)
            truth[h].append(inc)
        store.flush()
    return truth


# ---------------------------------------------------------------------------
# pool semantics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["torch", "card"])
def test_session_pool_matches_reference_and_per_row_oracle(route, request):
    d, depth = 3, 3
    n = request.getfixturevalue("card") if route == "card" else None
    ours, ref = _pair("auto" if n else "torch", d=d, depth=depth,
                      ring_capacity=64, initial_sessions=4, max_ticks=8)
    for store in (ours, ref):
        sids = [store.create(f"u{i}").sid for i in range(10)]
        truth = _play(store, np.random.default_rng(0), sids)
    _same(ours, ref)
    for sid in sids:
        if not truth[sid]:
            assert ours.length(sid) == 0
            continue
        np.testing.assert_allclose(ours.features(sid).numpy(),
                                   _oracle(truth[sid], depth), **TOL)
    st_ = ours.stats()
    assert st_["pending_ticks"] == 0
    for rung, B in st_["flush_shapes"]:
        assert rung & (rung - 1) == 0 and rung <= ours.max_ticks
        assert B & (B - 1) == 0
    if n is not None:           # one sig_trunc launch a flush bucket
        buckets = sum(1 for key in ours._shape_keys if key[0] == "flush")
        assert n["trunc"] >= buckets and n["stream"] == 0


def test_flush_launches_one_sig_trunc_a_bucket(card):
    store = SessionStore(2, 3, initial_sessions=8, max_ticks=8, max_rows=4,
                         backend="auto", device="cpu")
    store.create_many([f"u{i}" for i in range(9)])
    rng = np.random.default_rng(1)
    # rungs: 1 (x5 -> buckets of 4 and 1), 4 (x3), 8 (x1, a 20-tick
    # session drains over three waves: 8, 8, 4)
    counts = [1, 1, 1, 1, 1, 3, 4, 4, 20]
    for i, m in enumerate(counts):
        store.ingest(f"u{i}", rng.normal(size=(m, 2)).astype(np.float32))
    card["trunc"] = 0
    store.flush()
    # wave 1: rung 1 (5 rows: 4 + 1), rung 4 (3), rung 8 (1); wave 2:
    # rung 8; wave 3: rung 4
    assert card == dict(trunc=6, stream=0)
    assert store.stats()["updates"] == sum(counts)


def test_session_ingest_many_matches_ingest():
    d, depth = 2, 3
    rng = np.random.default_rng(0)
    sids = [f"s{i}" for i in range(6)]
    counts = rng.integers(1, 9, size=6)
    ticks = rng.normal(size=(int(counts.sum()), d)).astype(np.float32)
    a, ref = _pair(d=d, depth=depth, initial_sessions=4)
    b = SessionStore(d, depth, initial_sessions=4, backend="torch",
                     device="cpu")
    b.create_many(sids)
    for store in (a, ref):
        store.ingest_many(sids, counts, ticks, auto_create=True)
    for sid, chunk in zip(sids, np.split(ticks, np.cumsum(counts)[:-1])):
        b.ingest(sid, chunk)
    for store in (a, b, ref):
        store.flush()
    for sid in sids:
        assert torch.equal(a.features(sid), b.features(sid))
    _same(a, ref)


def _raises(store, case, rng):
    d = store.d
    store.create("u")
    if case == "double_create":
        store.create("u")
    elif case == "unknown_sid":
        store.lookup("nope")
    elif case == "bad_shape":
        store.ingest("u", np.zeros((3, 5), np.float32))
    elif case == "counts_sum":
        store.ingest_many(["u"], [3], np.zeros((2, d), np.float32))
    elif case == "stale_handle":
        h = store.lookup("u")
        store.evict("u")
        store.ingest(h, np.zeros((1, d), np.float32))
    elif case == "ring_overflow":
        store.ingest("u", rng.normal(size=(3, d)).astype(np.float32))
        store.flush()
        store.ingest("u", rng.normal(size=(2, d)).astype(np.float32))
        store.flush()
    elif case == "bad_config":
        type(store)(d, 0)


@pytest.mark.parametrize("case", ["double_create", "unknown_sid",
                                  "bad_shape", "counts_sum", "stale_handle",
                                  "ring_overflow", "bad_config"])
def test_session_validation_errors_match_reference(case):
    ours, ref = _pair(d=2, depth=2, ring_capacity=4, initial_sessions=2)
    errors = []
    for store in (ours, ref):
        with pytest.raises((ValueError, KeyError)) as e:
            _raises(store, case, np.random.default_rng(0))
        errors.append((type(e.value), str(e.value)))
    assert errors[0][0] is errors[1][0]
    assert errors[0][1] == errors[1][1]
    if case == "ring_overflow":     # raised before any device work
        _same(ours, ref)
        assert ours.length("u") == 3


def test_ring_overflow_leaves_the_pool_untouched():
    store = SessionStore(2, 2, ring_capacity=4, initial_sessions=2,
                         backend="torch", device="cpu")
    store.create("v")
    rng = np.random.default_rng(0)
    store.ingest("v", rng.normal(size=(3, 2)).astype(np.float32))
    store.flush()
    before = store.pool.sig.clone()
    store.ingest("v", rng.normal(size=(2, 2)).astype(np.float32))
    with pytest.raises(ValueError, match="rolling_drop at least 1"):
        store.flush()
    assert torch.equal(store.pool.sig, before)


def _evictions(store, case, rng):
    if case == "ttl":
        store.create("x", now=0.0)
        store.create("y", now=0.0)
        store.ingest("y", rng.normal(size=(2, 2)).astype(np.float32),
                     now=3.0)
        store.flush(now=3.5)                 # sweeps: x idle > ttl
    elif case == "lru":
        store.create("p", now=0.0)
        store.create("q", now=1.0)
        store.ingest("p", rng.normal(size=(1, 2)).astype(np.float32),
                     now=2.0)
        store.create("r", now=3.0)           # full: evicts q (oldest seen)
    elif case == "create_many_lru":
        store.create_many([f"u{i}" for i in range(6)])
    elif case == "lru_prefers_idle":
        store.create("a", now=0.0)
        store.create("b", now=1.0)
        store.ingest("a", rng.normal(size=(3, 2)).astype(np.float32),
                     now=0.5)
        store.create("c", now=2.0)           # the idle "b" goes, not "a"
        store.flush()
    elif case == "lru_all_pending":
        store.create("p", now=0.0)
        store.create("q", now=1.0)
        store.ingest("p", rng.normal(size=(4, 2)).astype(np.float32),
                     now=0.0)
        store.ingest("q", rng.normal(size=(2, 2)).astype(np.float32),
                     now=1.0)
        store.create("r", now=2.0)           # drops p's 4 queued ticks


EVICTIONS = {
    "ttl": (dict(initial_sessions=4, ttl=2.0), {"y"}, "ttl", 1, 0),
    "lru": (dict(initial_sessions=2, max_sessions=2), {"p", "r"}, "lru", 1,
            0),
    "create_many_lru": (dict(initial_sessions=4, max_sessions=4),
                        {"u2", "u3", "u4", "u5"}, "lru", 2, 0),
    "lru_prefers_idle": (dict(initial_sessions=2, max_sessions=2),
                         {"a", "c"}, "lru", 1, 0),
    "lru_all_pending": (dict(initial_sessions=2, max_sessions=2),
                        {"q", "r"}, "lru", 1, 4),
}


@pytest.mark.parametrize("case", sorted(EVICTIONS))
def test_session_ttl_and_lru_eviction_match_reference(case):
    kw, live, reason, n, dropped = EVICTIONS[case]
    ours, ref = _pair(d=2, depth=2, **kw)
    for store in (ours, ref):
        _evictions(store, case, np.random.default_rng(0))
    assert set(ours._ids) == live
    assert ours.evictions[reason] == n
    assert ours.stats()["dropped_ticks"] == dropped
    _same(ours, ref)


@pytest.mark.parametrize("sids", [["c", "d", "e"], ["c", "c"], ["a"]])
def test_strict_pool_refuses_atomically(sids):
    ours, ref = _pair(d=2, depth=2, initial_sessions=4, max_sessions=4,
                      lru_evict=False)
    errors = []
    for store in (ours, ref):
        store.create_many(["a", "b"])
        with pytest.raises((RuntimeError, ValueError)) as e:
            store.create_many(sids)
        errors.append((type(e.value), str(e.value)))
        assert len(store) == 2               # no partial admission
    assert errors[0] == errors[1]
    _same(ours, ref)


def test_empty_pool_stats_percentiles_are_zero_not_nan():
    store = SessionStore(2, 2, initial_sessions=2, backend="torch",
                         device="cpu")
    st_ = store.stats()
    assert st_["sessions"] == 0
    assert st_["p50_staleness_s"] == 0.0 and st_["p99_staleness_s"] == 0.0
    store.flush()
    st_ = store.stats()
    assert st_["p50_staleness_s"] == 0.0 and st_["p99_staleness_s"] == 0.0
    assert set(st_) == set(JStore(2, 2, initial_sessions=2).stats())
    assert store.health()["status"] == "ok"


def test_session_flush_rung_wider_than_ring_stays_exact():
    d, depth, R = 2, 3, 5
    rng = np.random.default_rng(0)
    inc = rng.normal(size=(R, d)).astype(np.float32)
    ours, ref = _pair(d=d, depth=depth, ring_capacity=R, initial_sessions=2)
    for store in (ours, ref):
        h = store.create("u")
        store.ingest(h, inc)
        store.flush()                        # 5 ticks pad to rung 8 > R
        store.drop_block([h], 2)
    _same(ours, ref)
    want = np.asarray(j_sig(jnp.asarray(inc[2:])[None], depth)[0])
    np.testing.assert_allclose(ours.features("u").numpy(), want, **TOL)
    assert ours.length("u") == R - 2


def test_session_slot_reuse_bumps_generation():
    rng = np.random.default_rng(0)
    ours, ref = _pair(d=2, depth=2, initial_sessions=2, max_sessions=2)
    inc = rng.normal(size=(4, 2)).astype(np.float32)
    for store in (ours, ref):
        h_old = store.create("old")
        store.ingest("old", inc)
        store.flush()
        store.evict("old")
        h_new = store.create("new")          # reuses the freed slot
        assert h_new.slot == h_old.slot
        assert h_new.generation == h_old.generation + 1
        assert store.length("new") == 0
        with pytest.raises(ValueError, match="stale session handle"):
            store.lookup(h_old)
    assert isinstance(ours.lookup("new"), SessionHandle)
    assert not ours.features("new").any()
    _same(ours, ref)


def test_session_pool_growth_preserves_rows():
    d, depth = 3, 2
    inc = np.random.default_rng(0).normal(size=(5, d)).astype(np.float32)
    ours, ref = _pair(d=d, depth=depth, initial_sessions=2)
    for store in (ours, ref):
        store.create("keep")
        store.ingest("keep", inc)
        store.flush()
    before = ours.features("keep")
    for store in (ours, ref):
        store.create_many([f"g{i}" for i in range(40)])   # doublings
    assert ours.pool_size >= 41 and len(ours.stats()["pool_sizes"]) >= 3
    assert torch.equal(ours.features("keep"), before)
    assert ours.length("keep") == 5
    _same(ours, ref)


def test_session_flush_shapes_stay_bounded():
    d, depth = 2, 2
    ours, ref = _pair(d=d, depth=depth, initial_sessions=32, max_ticks=16)
    for store in (ours, ref):
        rng = np.random.default_rng(0)
        store.create_many([f"u{i}" for i in range(30)])
        for _ in range(8):
            k = int(rng.integers(1, 30))
            for sid in rng.choice(30, size=k, replace=False):
                m = int(rng.integers(1, 17))
                store.ingest(f"u{sid}",
                             rng.normal(size=(m, d)).astype(np.float32))
            store.flush()
    st_ = ours.stats()
    bound = (int(np.log2(ours.max_ticks)) + 1) \
        * (int(np.log2(ours.max_rows)) + 1) * len(st_["pool_sizes"])
    assert st_["compiled_shapes"] <= bound
    assert set(st_["compute_cache"]) >= {"hits", "misses", "maxsize",
                                         "currsize"}
    _same(ours, ref)


# ---------------------------------------------------------------------------
# traffic generator: numpy only, bit-identical to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(seed=11, arrival_rate=2.0,
                                     churn_prob=0.05),
                                dict(seed=1), dict(seed=3, tick_prob=0.9,
                                                   max_ticks=8)])
def test_session_tick_stream_is_bit_identical_and_seekable(kw):
    a = session_tick_stream(40, 3, **kw)
    ref = j_ticks(40, 3, **kw)
    for _ in range(4):
        ra, rr = next(a), next(ref)
        assert ra["sids"] == rr["sids"]
        assert ra["counts"].dtype == rr["counts"].dtype
        np.testing.assert_array_equal(ra["counts"], rr["counts"])
        assert ra["ticks"].dtype == rr["ticks"].dtype
        np.testing.assert_array_equal(ra["ticks"], rr["ticks"])
        assert ra["departures"] == rr["departures"]
    assert a.state() == ref.state()
    state = a.state()
    r1 = next(a)
    c = SessionTickStream(40, 3, **kw)
    c.restore(state)
    r2 = next(c)
    assert r1["sids"] == r2["sids"]
    np.testing.assert_array_equal(r1["ticks"], r2["ticks"])
    assert r1["departures"] == r2["departures"]


def test_session_tick_stream_is_heavy_tailed_and_feeds_store():
    totals = {}
    s = session_tick_stream(150, 2, seed=1)
    ours, ref = _pair(d=2, depth=2, initial_sessions=8)
    for _ in range(8):
        r = next(s)
        assert r["ticks"].shape == (int(r["counts"].sum()), 2)
        assert (r["counts"] >= 1).all() and \
            (r["counts"] <= s.max_ticks).all()
        for store in (ours, ref):
            store.ingest_many(r["sids"], r["counts"], r["ticks"],
                              auto_create=True)
            store.flush()
        for sid, cnt in zip(r["sids"], r["counts"]):
            totals[sid] = totals.get(sid, 0) + int(cnt)
    v = np.asarray(sorted(totals.values()))
    assert v.max() / max(np.percentile(v, 50), 1) > 4   # whales exist
    assert ours.stats()["updates"] == int(v.sum())
    _same(ours, ref)


def test_session_store_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SessionStore(2, 2)
