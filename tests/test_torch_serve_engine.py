"""The port's ``SigStreamEngine`` against the reference's, and both engines
on a shared session pool.

Mirrors the engine cases of ``tests/test_sessions.py`` and
``tests/test_stream.py``: the same numpy chunks are pushed through
``repro.serve.SigStreamEngine`` (its ``jax`` engine) and
``repro_torch.serve.SigStreamEngine`` (the torch engine on the CPU), and
on ``card`` through the port's ``cuda`` route on CPU tensors with the
launches replaced by the plain versions and counted: one streamed
``sig_trunc`` launch a ``SigStreamEngine.push``, one ``sig_trunc`` and one
``sig_gram`` launch a ``SigScoreEngine.push`` (scores, predict and nearest
share its cross-Gram).  Values rtol 2e-4, atol 2e-5; lengths, ends, ids
and errors exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import SessionStore as JStore
from repro.serve import SigStreamEngine as JStream
from repro_torch.core.stream import signature_stream_init
from repro_torch.kernels import ops
from repro_torch.kernels import sig_gram as sg
from repro_torch.kernels import sig_trunc as st
from repro_torch.serve import SessionStore, SigScoreEngine, SigStreamEngine

TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def card(monkeypatch):
    """The dispatch's sig_trunc and sig_gram cells on CPU tensors, the
    launches replaced by the plain versions; returns the launch counts."""
    n = dict(trunc=0, stream=0, gram=0)
    resolve = ops.resolve_backend
    monkeypatch.setattr(ops, "resolve_backend", lambda backend, device:
                        "cuda" if backend == "auto" else resolve(backend,
                                                                 device))

    def launch(incs, depth, split, stream, stride, precision, plan=None,
               transform=None, taux=None):
        n["stream" if stream else "trunc"] += 1
        return st.sig_trunc_plain(incs.detach().float(), depth,
                                  stream=stream, stream_stride=stride)

    def gram(Sx, Sy, w):
        n["gram"] += 1
        return sg.sig_gram_plain(Sx.float(), Sy.float(), w.float())

    monkeypatch.setattr(st, "_launch", launch)
    monkeypatch.setattr(ops, "sig_trunc", lambda x, depth, *, split=None,
                        stream=False, stream_stride=1, precision="fp32",
                        transform=None, taux=None: st.SigTruncFunction.apply(
                            x, depth, split, stream, stream_stride,
                            precision, transform, taux).to(x.dtype))
    monkeypatch.setattr(ops, "sig_gram", gram)
    return n


def _chunks(seed, B, M, d, scale=0.3):
    return (np.random.default_rng(seed).normal(size=(B, M, d))
            * scale).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# SigStreamEngine
# ---------------------------------------------------------------------------

STREAMS = {
    "expanding": dict(window=0, stream_stride=1, hop=4),
    "hopping": dict(window=12, stream_stride=1, hop=5),
    "strided": dict(window=16, stream_stride=3, hop=7),
    "wider_than_window": dict(window=6, stream_stride=2, hop=9),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_engine_push_matches_reference(name):
    cfg = dict(STREAMS[name])
    hop = cfg.pop("hop")
    d, depth, B = 2, 3, 3
    ours = SigStreamEngine(d=d, depth=depth, batch=B, backend="torch",
                           device="cpu", **cfg)
    ref = JStream(d=d, depth=depth, batch=B, backend="jax", **cfg)
    x = _chunks(0, B, 5 * hop, d)
    for k in range(5):
        chunk = x[:, hop * k:hop * (k + 1)]
        _close(ours.push(chunk), ref.push(jnp.asarray(chunk)))
        a, b = ours.state, ref.state
        assert (a.length, a.end) == (b.length, b.end)
        _close(a.sig, b.sig)
        np.testing.assert_array_equal(a.ring.numpy(), np.asarray(b.ring))
    _close(ours.features, ref.features)
    assert [h.sid for h in ours.handles] == [h.sid for h in ref.handles]


def test_stream_engine_state_roundtrip_and_reset():
    d, depth, B = 2, 3, 2
    ours = SigStreamEngine(d=d, depth=depth, batch=B, window=8,
                           backend="torch", device="cpu")
    ref = JStream(d=d, depth=depth, batch=B, window=8, backend="jax")
    x = _chunks(1, B, 12, d)
    for eng in (ours, ref):
        eng.push(x[:, :5])
    saved, jsaved = ours.state, ref.state
    for eng in (ours, ref):
        eng.push(x[:, 5:12])
    ours.state, ref.state = saved, jsaved      # install the older carry
    assert ours.state.length == ref.state.length == 5
    _close(ours.features, ref.features)
    _close(ours.push(x[:, :3]), ref.push(jnp.asarray(x[:, :3])))
    ours.reset()
    ref.reset()
    assert ours.state.length == 0 and not ours.features.any()
    with pytest.raises(ValueError, match="carry batch"):
        ours.state = signature_stream_init(B + 1, d, depth, capacity=8,
                                           device="cpu")
    with pytest.raises(ValueError, match="ring capacity"):
        ours.state = signature_stream_init(B, d, depth, capacity=4,
                                           device="cpu")


def test_stream_engine_occupancy_errors_match_reference():
    ours = SigStreamEngine(d=2, depth=2, batch=2, window=8, backend="torch",
                           device="cpu")
    ref = JStream(d=2, depth=2, batch=2, window=8, backend="jax")
    msgs = []
    for eng in (ours, ref):
        with pytest.raises(ValueError, match="rolling_drop at least") as e1:
            eng.store.extend_block(eng.handles,
                                   np.zeros((2, 9, 2), np.float32))
        with pytest.raises(ValueError, match="cannot drop") as e2:
            eng.store.drop_block(eng.handles, 1)
        msgs.append((str(e1.value), str(e2.value)))
    assert msgs[0] == msgs[1]
    nowin = SessionStore(2, 2, initial_sessions=2, backend="torch",
                         device="cpu")
    blk = nowin.create_block(2)
    with pytest.raises(ValueError, match="ring_capacity > 0"):
        nowin.drop_block(blk, 1)


def test_stream_engine_launches_one_streamed_sig_trunc_a_push(card):
    d, depth, B = 2, 3, 3
    ours = SigStreamEngine(d=d, depth=depth, batch=B, window=8,
                           stream_stride=2, backend="auto", device="cpu")
    ref = JStream(d=d, depth=depth, batch=B, window=8, stream_stride=2,
                  backend="jax")
    x = _chunks(2, B, 24, d)
    for k in range(4):                       # pushes 3 and 4 drop first
        before = dict(card)
        got = ours.push(x[:, 6 * k:6 * (k + 1)])
        assert card["stream"] == before["stream"] + 1
        assert (card["trunc"], card["gram"]) == (before["trunc"], 0)
        _close(got, ref.push(jnp.asarray(x[:, 6 * k:6 * (k + 1)])))


# ---------------------------------------------------------------------------
# shared multi-tenant pools
# ---------------------------------------------------------------------------

def test_engine_validates_shared_store():
    store = SessionStore(2, 2, ring_capacity=8, initial_sessions=4,
                         backend="torch", device="cpu")
    jstore = JStore(2, 2, ring_capacity=8, initial_sessions=4)
    for bad, jbad, match in (
            (dict(dtype=torch.float16), dict(dtype=jnp.float16), "dtype"),
            (dict(backend="cuda"), dict(backend="pallas_interpret"),
             "backend"),
            (dict(window=32), dict(window=32), "needs >= "),
            (dict(depth=3), dict(depth=3), "but the engine needs")):
        kw = dict(d=2, depth=2, batch=2, window=4)
        with pytest.raises(ValueError, match=match):
            SigStreamEngine(**{**kw, **bad}, store=store)
        with pytest.raises(ValueError, match=match):
            JStream(**{**kw, **jbad}, store=jstore)
    with pytest.raises(ValueError, match="lives on"):
        SigStreamEngine(d=2, depth=2, batch=2, window=4, store=store,
                        device="meta")
    assert len(store) == 0 == len(jstore)    # failed joins leave no slots
    eng = SigStreamEngine(d=2, depth=2, batch=2, window=4, store=store)
    assert eng.device == store.device        # the store's device by default


def _tenant_then_engines(Store, Stream, kind, chunks, tenant):
    d, depth = 2, 3
    kw = dict(device="cpu") if kind == "port" else {}
    bk = "torch" if kind == "port" else "jax"
    pool = Store(d, depth, ring_capacity=16, initial_sessions=8,
                 backend=bk, **kw)
    pool.create("tenant")
    pool.ingest("tenant", tenant)
    pool.flush()
    shared = Stream(d=d, depth=depth, batch=3, window=12, backend=bk,
                    store=pool, **kw)
    private = Stream(d=d, depth=depth, batch=3, window=12, backend=bk, **kw)
    out = []
    for k in range(5):
        fa = shared.push(chunks[:, 4 * k:4 * (k + 1)])
        fb = private.push(chunks[:, 4 * k:4 * (k + 1)])
        np.testing.assert_allclose(np.asarray(fa), np.asarray(fb),
                                   atol=1e-6)
        out.append(np.asarray(fa))
    return pool, shared, out


def test_engine_joins_shared_multi_tenant_pool():
    rng = np.random.default_rng(0)
    tenant = rng.normal(size=(4, 2)).astype(np.float32)
    x = rng.normal(size=(3, 20, 2)).astype(np.float32) * 0.3
    pool, shared, got = _tenant_then_engines(SessionStore, SigStreamEngine,
                                             "port", x, tenant)
    jpool, _, want = _tenant_then_engines(JStore, JStream, "ref", x, tenant)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
    assert shared.store is pool and shared.state.length <= 12
    # the tenant's state survived the engine traffic in the same pool
    _close(pool.features("tenant"), jpool.features("tenant"))
    assert pool._ids == jpool._ids


def test_stream_and_score_engines_share_one_store(card):
    d, depth, B = 2, 3, 2
    refs = np.cumsum(_chunks(3, 5, 10, d, 0.2), axis=1)
    pool = SessionStore(d, depth, ring_capacity=8, initial_sessions=4,
                        backend="auto", device="cpu")
    stream = SigStreamEngine(d=d, depth=depth, batch=B, window=8,
                             store=pool)
    targets = np.linspace(-1.0, 1.0, 5, dtype=np.float32)
    score = SigScoreEngine(d=d, depth=depth, batch=B, references=refs,
                           targets=targets, window=8, store=pool)
    alone = SigScoreEngine(d=d, depth=depth, batch=B, references=refs,
                           targets=targets, window=8, backend="torch",
                           device="cpu")
    assert len(pool) == 2 * B and pool.pool_size == 4
    x = _chunks(4, B, 15, d)
    for k in range(3):
        stream.push(x[:, 5 * k:5 * (k + 1)])
        n = dict(card)
        s = score.push(x[:, 5 * k:5 * (k + 1)])
        p, i = score.predict(), score.nearest()
        assert p.shape == (B,) and i.shape == (B,)
        assert (card["trunc"] - n["trunc"], card["gram"] - n["gram"],
                card["stream"] - n["stream"]) == (1, 1, 0)
        _close(s, alone.push(x[:, 5 * k:5 * (k + 1)]))
    _close(stream.features, score._terminal_sigs())
