"""The scoring slice as a whole: ``SigScoreEngine``'s cached reference
state, its session-pool members (``handles``, ``state``, ``push``,
``scores``, ``predict``, ``nearest``, ``reset``, a shared ``store=``) and
``DynamicBatcher.scoring_service`` against the reference's, on the same
references, chunks and requests (mirrors ``tests/test_ragged.py``'s
scoring test).  The reference runs its ``jax`` engine, the port its
``torch`` engine on the CPU.  Tolerance: 1e-5·max|ref| in fp32, as the
reference's Gram acceptance.  The KRR duals come from a solve and are held
to 1e-4·max|ref|, so a prediction Σ_j K_j α_j is held to 1e-4·Σ_j |K_j α_j|
with the reference's cross-Gram row K.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tensor_ops as jtops
from repro.kernels import ops as jops
from repro.serve import DynamicBatcher as JaxBatcher
from repro.serve import SigScoreEngine as JaxEngine
from repro_torch.serve import DynamicBatcher, SigScoreEngine


def _paths(seed, B, M, d, scale=0.2):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(size=(B, M + 1, d)) * scale,
                     axis=1).astype(np.float32)


def _requests(seed, n, d, max_len):
    rng = np.random.default_rng(seed)
    return [np.cumsum(rng.normal(size=(L + 1, d)) * 0.2, axis=0).astype(
        np.float32) for L in rng.integers(1, max_len + 1, size=n)]


def _close(got, want, scale=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=scale * max(np.abs(want).max(), 1e-30))


def _prediction_scale(ref, path):
    """Σ_j |K_j α_j| of one request against the reference engine."""
    S = jops.signature(jtops.path_increments(jnp.asarray(path))[None],
                       ref.depth, backend="jax", precision=ref.precision)
    K = jops.gram(S, ref.ref_sigs, ref.weights, backend="jax",
                  precision=ref.precision)
    return float((np.abs(np.asarray(K)) @ np.abs(np.asarray(ref.alpha)))[0])


ENGINES = {
    "plain": dict(),
    "weighted": dict(gamma=(0.5, 2.0), level_weights=(1.0, 0.5, 0.25)),
    "raw": dict(normalize=False, reg=1e-2),
    "bf16": dict(precision="bf16_fp32"),
}


def _engines(name, targets=True):
    refs = _paths(1, 6, 16, 2)
    kw = dict(d=2, depth=3, batch=2, references=refs, **ENGINES[name])
    if targets:
        kw["targets"] = np.linspace(-1.0, 1.0, 6, dtype=np.float32)
    return (SigScoreEngine(backend="torch", device="cpu", **kw),
            JaxEngine(backend="jax", **kw))


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_reference_state_matches(name):
    ours, ref = _engines(name)
    for attr in ("weights", "ref_sigs", "ref_gram"):
        _close(getattr(ours, attr), getattr(ref, attr))
    _close(ours.alpha, ref.alpha, 1e-4)
    assert ours.ref_sigs.device.type == "cpu"


@pytest.mark.parametrize("mode", ["scores", "nearest", "predict"])
@pytest.mark.parametrize("name", sorted(ENGINES))
def test_scoring_service_matches_reference(name, mode):
    ours, ref = _engines(name)
    reqs = _requests(len(name), 11, 2, 30)
    a = DynamicBatcher.scoring_service(ours, max_len=32, mode=mode,
                                       min_bucket=8, max_batch=4)
    b = JaxBatcher.scoring_service(ref, max_len=32, mode=mode, min_bucket=8,
                                   max_batch=4)
    tickets = [(a.submit(p), b.submit(p)) for p in reqs]
    got, want = a.flush(), b.flush()
    assert a.stats()["batches"] > 1
    for p, (t, u) in zip(reqs, tickets):
        if mode == "nearest":
            assert int(got[t]) == int(want[u])
        elif mode == "predict":
            assert abs(float(got[t]) - float(want[u])) \
                <= 1e-4 * _prediction_scale(ref, p)
        else:
            _close(got[t], want[u])
    for key in ("shapes", "padded_steps", "true_steps", "occupancy"):
        assert a.stats()[key] == b.stats()[key], key


def test_scoring_service_scores_equal_the_engine_on_its_references():
    ours, _ = _engines("plain")
    svc = DynamicBatcher.scoring_service(ours, max_len=16)
    assert svc.device == ours.device
    tickets = [svc.submit(p) for p in ours.references]
    out = svc.flush()
    scores = torch.stack([out[t] for t in tickets])
    _close(torch.diagonal(scores), np.ones(6, np.float32))
    nearest = DynamicBatcher.scoring_service(ours, max_len=16, mode="nearest")
    tickets = [nearest.submit(p) for p in ours.references]
    out = nearest.flush()
    assert [int(out[t]) for t in tickets] == list(range(6))


def test_scoring_service_validation():
    ours, _ = _engines("plain", targets=False)
    assert ours.alpha is None
    with pytest.raises(ValueError, match="unknown mode"):
        DynamicBatcher.scoring_service(ours, max_len=16, mode="nope")
    with pytest.raises(ValueError, match="targets="):
        DynamicBatcher.scoring_service(ours, max_len=16, mode="predict")
    with pytest.raises(ValueError, match="references must be"):
        SigScoreEngine(d=3, depth=2, batch=1, references=_paths(2, 2, 4, 2),
                       backend="torch", device="cpu")


def _pool_engines(store=None, jstore=None):
    """The "plain" engines with targets and an 8-step hopping window, on a
    private pool or on ``store`` / ``jstore``."""
    kw = dict(d=2, depth=3, batch=2, references=_paths(1, 6, 16, 2),
              targets=np.linspace(-1.0, 1.0, 6, dtype=np.float32), window=8)
    return (SigScoreEngine(backend="torch", device="cpu", store=store, **kw),
            JaxEngine(backend="jax", store=jstore, **kw))


def _push_both(ours, ref, seed=4, pushes=3, hop=5):
    x = (np.random.default_rng(seed).normal(size=(2, pushes * hop, 2))
         * 0.3).astype(np.float32)
    out = []
    for k in range(pushes):      # the third push drops the oldest two
        chunk = x[:, hop * k:hop * (k + 1)]
        out.append((ours.push(chunk), ref.push(jnp.asarray(chunk))))
    return out


def _check_member(ours, ref, member):
    if member == "handles":
        assert [(h.sid, h.slot, h.generation) for h in ours.handles] == [
            (h.sid, h.slot, h.generation) for h in ref.handles]
    elif member == "state":
        a, b = ours.state, ref.state
        assert (a.length, a.end, a.d, a.depth) == (b.length, b.end, b.d,
                                                   b.depth)
        _close(a.sig, b.sig)
        _close(a.ring, b.ring)
        ours.push(np.zeros((2, 1, 2), np.float32))
        ours.state = a                   # installing a carry drops the cache
        _close(ours.scores(), ref.scores())
    elif member == "scores":
        _close(ours.scores(), ref.scores())
    elif member == "predict":
        K, alpha = np.asarray(ref._cross_gram()), np.asarray(ref.alpha)
        scale = np.abs(K) @ np.abs(alpha)
        assert (np.abs(ours.predict().numpy() - np.asarray(ref.predict()))
                <= 1e-4 * scale).all()
    elif member == "nearest":
        assert ours.nearest().tolist() == np.asarray(ref.nearest()).tolist()
    elif member == "reset":
        ours.reset()
        ref.reset()
        assert ours.state.length == ref.state.length == 0
        _close(ours.scores(), ref.scores())
        assert ours._cross is not None   # one cross-Gram a state, cached


@pytest.mark.parametrize("member", ["handles", "state", "push", "scores",
                                    "predict", "nearest", "reset"])
def test_session_pool_members_match_reference(member):
    ours, ref = _pool_engines()
    for got, want in _push_both(ours, ref):
        if member == "push":
            _close(got, want)
    _check_member(ours, ref, member)


def test_shared_store_matches_reference():
    from repro.serve import SessionStore as JaxStore
    from repro_torch.serve import SessionStore
    store = SessionStore(2, 3, ring_capacity=8, initial_sessions=2,
                         backend="torch", device="cpu")
    jstore = JaxStore(2, 3, ring_capacity=8, initial_sessions=2)
    for s in (store, jstore):
        s.create("tenant")
        s.ingest("tenant", np.full((3, 2), 0.1, np.float32))
        s.flush()
    ours, ref = _pool_engines(store, jstore)
    assert ours.store is store and ours.device == store.device
    for got, want in _push_both(ours, ref):
        _close(got, want)
    for member in ("handles", "predict", "nearest"):
        _check_member(ours, ref, member)
    assert store._ids == jstore._ids and store.pool_size == 4
    _close(store.features("tenant"), jstore.features("tenant"))
