"""Online signature streams of the port against the reference.

Mirrors the ``SignatureStream`` and pooled cases of ``tests/test_stream.py``:
the same numpy increments through ``repro.core.stream`` (its ``jax``
engine; its streamed Pallas cells fail here, ROADMAP queue 3) and through
``repro_torch.core.stream`` on the torch engine, and on ``card``: the
``cuda`` cells of the dispatch on CPU tensors with the launch replaced by
the kernel's plain version and counted (one ``sig_trunc`` launch an
extend).  Rings, lengths and ends must equal the reference's exactly;
dead lanes and zero-count rows come back bit-identical.  Values rtol
2e-4, atol 2e-5; gradients rtol 1e-3, atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stream as js
from repro_torch.core import stream as ts
from repro_torch.core.signature import signature_from_increments
from repro_torch.kernels import ops
from repro_torch.kernels import sig_trunc as st

TOL = dict(rtol=2e-4, atol=2e-5)
GTOL = dict(rtol=1e-3, atol=1e-5)
ROUTES = ["torch", "card"]


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


@pytest.fixture
def route(request):
    if request.param == "card":
        return request.getfixturevalue("card")
    return None


def _incs(seed, B, M, d):
    return (np.random.default_rng(seed).normal(size=(B, M, d))
            * 0.3).astype(np.float32)


def _sig(x, N=3):
    return signature_from_increments(torch.from_numpy(np.ascontiguousarray(
        x)), N, backend="torch", device="cpu").numpy()


def _backend(route):
    return "torch" if route is None else "auto"


# ---------------------------------------------------------------------------
# the shared update math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("stride", [None, 1, 3])
def test_extend_sig_matches_reference(stride, route):
    sig0 = _sig(_incs(1, 3, 4, 2))
    x = _incs(2, 3, 7, 2)
    kw = {} if stride is None else dict(return_stream=True,
                                        stream_stride=stride)
    got, feats = ts.extend_sig(torch.from_numpy(sig0), torch.from_numpy(x),
                               2, 3, backend=_backend(route), **kw)
    want, jfeats = js.extend_sig(jnp.asarray(sig0), jnp.asarray(x), 2, 3,
                                 **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if stride is None:
        assert feats is None and jfeats is None
    else:
        np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), **TOL)
    if route is not None:
        assert route == (dict(trunc=0, stream=1) if stride
                         else dict(trunc=1, stream=0))


def test_drop_sig_matches_reference():
    x = _incs(3, 2, 9, 3)
    sig = _sig(x)
    dropped = np.concatenate([x[:, :4], np.zeros((2, 2, 3), np.float32)], 1)
    got = ts.drop_sig(torch.from_numpy(sig), torch.from_numpy(dropped), 3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(js.drop_sig(
        jnp.asarray(sig), jnp.asarray(dropped), 3, 3)), **TOL)
    np.testing.assert_allclose(got.numpy(), _sig(x[:, 4:]), **TOL)


# ---------------------------------------------------------------------------
# SignatureStream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_stream_state_extend_matches_one_shot(route):
    x = _incs(10, 2, 20, 3)
    s = ts.signature_stream_init(2, 3, 3, capacity=32, device="cpu")
    for lo, hi in ((0, 7), (7, 12), (12, 20)):
        s = s.extend(torch.from_numpy(x[:, lo:hi]), backend=_backend(route))
    np.testing.assert_allclose(s.sig.numpy(), _sig(x), **TOL)
    np.testing.assert_array_equal(s.ring[:, :20].numpy(), x)
    assert (s.length, s.end) == (20, 20)
    if route is not None:
        assert route["trunc"] == 3


def test_stream_state_rolling_drop_matches_reference():
    x = _incs(11, 2, 18, 3)
    s = ts.signature_stream_init(2, 3, 3, capacity=18, device="cpu")
    s = s.extend(torch.from_numpy(x), backend="torch").rolling_drop(6)
    j = js.signature_stream_init(2, 3, 3, capacity=18).extend(
        jnp.asarray(x)).rolling_drop(6)
    np.testing.assert_allclose(s.sig.numpy(), np.asarray(j.sig), **TOL)
    np.testing.assert_allclose(s.sig.numpy(), _sig(x[:, 6:]), **TOL)
    assert (s.length, s.end) == (j.length, j.end) == (12, 0)


def test_stream_state_ring_wraparound():
    x = _incs(12, 1, 30, 2)
    s = ts.signature_stream_init(1, 2, 3, capacity=10, device="cpu")
    j = js.signature_stream_init(1, 2, 3, capacity=10)
    pos = 0
    for k in range(6):  # hop 5: drop as needed, extend 5
        need = max(0, s.length + 5 - 10)
        chunk = x[:, 5 * k:5 * (k + 1)]
        s = s.rolling_drop(need).extend(torch.from_numpy(chunk),
                                        backend="torch")
        j = j.rolling_drop(need).extend(jnp.asarray(chunk))
        pos += need
    np.testing.assert_allclose(s.sig.numpy(), _sig(x[:, pos:]), **TOL)
    np.testing.assert_allclose(s.sig.numpy(), np.asarray(j.sig), **TOL)
    np.testing.assert_array_equal(s.ring.numpy(), np.asarray(j.ring))
    assert (s.length, s.end) == (j.length, j.end)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("stride", [1, 2])
def test_stream_state_return_stream_features(stride, route):
    x = _incs(13, 2, 12, 3)
    s = ts.signature_stream_init(2, 3, 3, device="cpu").extend(
        torch.from_numpy(x[:, :5]), backend="torch")
    s, feats = s.extend(torch.from_numpy(x[:, 5:]), return_stream=True,
                        stream_stride=stride, backend=_backend(route))
    j = js.signature_stream_init(2, 3, 3).extend(jnp.asarray(x[:, :5]))
    _, jfeats = j.extend(jnp.asarray(x[:, 5:]), return_stream=True,
                         stream_stride=stride)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), **TOL)
    np.testing.assert_allclose(s.sig.numpy(), feats[:, -1].numpy(),
                               rtol=1e-6, atol=1e-7)
    if route is not None:
        assert route == dict(trunc=0, stream=1)


def test_rolling_drop_everything_resets_exactly():
    x = torch.from_numpy(_incs(30, 2, 8, 3))
    s = ts.signature_stream_init(2, 3, 3, capacity=8, device="cpu").extend(
        x, backend="torch").rolling_drop(8)
    assert s.length == 0 and not s.sig.any()


def test_stream_state_guards():
    s = ts.signature_stream_init(1, 2, 2, capacity=4, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        s.extend(torch.from_numpy(_incs(14, 1, 5, 2)))
    with pytest.raises(ValueError, match="drop"):
        s.extend(torch.from_numpy(_incs(15, 1, 3, 2)),
                 backend="torch").rolling_drop(4)
    with pytest.raises(ValueError, match="ring"):
        ts.signature_stream_init(1, 2, 2, device="cpu").rolling_drop(1)
    with pytest.raises(ValueError, match="dim"):
        s.extend(torch.from_numpy(_incs(16, 1, 2, 3)))
    with pytest.raises(ValueError, match="batch"):
        s.extend(torch.from_numpy(_incs(16, 2, 2, 2)))
    for init in (ts.signature_stream_init, ts.stream_init):
        with pytest.raises(ValueError, match="depth"):
            init(1, 2, 0, device="cpu")
        with pytest.raises(ValueError, match="capacity"):
            init(1, 2, 2, capacity=-1, device="cpu")


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_stream_state_gradient_matches_reference(route):
    x = _incs(17, 2, 10, 3)

    def loss_torch(z):
        s = ts.signature_stream_init(2, 3, 3, capacity=16, device="cpu")
        s = s.extend(z, backend=_backend(route)).rolling_drop(3)
        return (s.sig ** 2).sum()

    def loss_jax(z):
        s = js.signature_stream_init(2, 3, 3, capacity=16)
        return jnp.sum(s.extend(z).rolling_drop(3).sig ** 2)

    z = torch.from_numpy(x).requires_grad_()
    g, = torch.autograd.grad(loss_torch(z), z)
    want = np.asarray(jax.grad(loss_jax)(jnp.asarray(x)))
    # dropped steps carry ~1e-6 float32 cancellation residue on both sides
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-3, atol=5e-6)


# ---------------------------------------------------------------------------
# the pooled StreamCarry
# ---------------------------------------------------------------------------

def _pair(n, d, depth, capacity, valid):
    return (ts.stream_init(n, d, depth, capacity=capacity, valid=valid,
                           device="cpu"),
            js.stream_init(n, d, depth, capacity=capacity, valid=valid))


def _assert_carries(got, want, exact_sig=False):
    check = np.testing.assert_array_equal if exact_sig else (
        lambda a, b: np.testing.assert_allclose(a, b, **TOL))
    check(got.sig.numpy(), np.asarray(want.sig))
    for f in ("ring", "length", "end", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_pool_extend_and_drop_match_reference(route):
    """Per-row counts, a dead lane, zero-count rows, wrapping rings and
    per-row drops, step by step against the reference; one kernel launch
    an extend."""
    N, d, depth, R, m = 6, 2, 3, 8, 5
    ours, theirs = _pair(N, d, depth, R, True)
    valid = np.array([1, 1, 1, 0, 1, 1], bool)
    ours = ts.dataclasses.replace(ours, valid=torch.from_numpy(valid))
    theirs = js.dataclasses.replace(theirs, valid=jnp.asarray(valid))
    rng = np.random.default_rng(0)
    length = np.zeros(N, int)
    for r in range(6):
        drop = np.minimum(length, rng.integers(0, 4, size=N)) * valid
        before = ours
        ours = ts.stream_rolling_drop(ours, torch.from_numpy(drop),
                                      max_drop=4)
        theirs = js.stream_rolling_drop(theirs, jnp.asarray(drop),
                                        max_drop=4)
        length -= drop
        counts = np.minimum(rng.integers(0, m + 1, size=N), R - length)
        counts[r % N] = 0
        x = _incs(r, N, m, d)
        mid = ours
        ours = ts.stream_extend(ours, torch.from_numpy(x),
                                counts=torch.from_numpy(counts),
                                backend=_backend(route))
        theirs = js.stream_extend(theirs, jnp.asarray(x),
                                  counts=jnp.asarray(counts))
        length += counts * valid
        _assert_carries(ours, theirs)
        for i in np.flatnonzero((counts == 0) | ~valid):   # bit-identical
            assert torch.equal(ours.sig[i], mid.sig[i])
            assert torch.equal(ours.ring[i], mid.ring[i])
        assert torch.equal(ours.sig[3], before.sig[3])
    np.testing.assert_array_equal(ours.length.numpy(), length)
    if route is not None:
        assert route == dict(trunc=6, stream=0)


def test_pool_window_is_the_signature_of_its_ring():
    N, d, depth, R = 4, 3, 3, 6
    pool = ts.stream_init(N, d, depth, capacity=R, valid=True, device="cpu")
    rng = np.random.default_rng(1)
    for r in range(5):
        pool = ts.stream_rolling_drop(pool, torch.clamp(
            pool.length - 2, min=0), max_drop=R)
        counts = rng.integers(0, R - 1, size=N).clip(
            max=R - pool.length.numpy())
        pool = ts.stream_extend(pool, torch.from_numpy(_incs(r, N, 4, d)),
                                counts=torch.from_numpy(counts),
                                backend="torch")
    for i in range(N):
        L, e = int(pool.length[i]), int(pool.end[i])
        window = pool.ring[i, (e - L + np.arange(L)) % R].numpy()
        np.testing.assert_allclose(pool.sig[i].numpy(),
                                   _sig(window[None])[0], **TOL)


def test_pool_extend_padded_chunk_wider_than_ring():
    """A zero-padded chunk with m > capacity: masked positions never write
    back into the ring, so the next drop sees the true oldest
    increments."""
    R = 5
    x = _incs(42, 1, R, 2)
    padded = np.concatenate([x, np.zeros((1, 3, 2), np.float32)], axis=1)
    carry = ts.stream_init(1, 2, 3, capacity=R, valid=True, device="cpu")
    carry = ts.stream_extend(carry, torch.from_numpy(padded),
                             counts=torch.tensor([R]), backend="torch")
    np.testing.assert_array_equal(carry.ring[0].numpy(), x[0])
    carry = ts.stream_rolling_drop(carry, 2, max_drop=2)
    np.testing.assert_allclose(carry.sig.numpy(), _sig(x[:, 2:]), **TOL)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_pool_return_stream_matches_reference(route):
    ours, theirs = _pair(3, 2, 3, 0, True)
    x = _incs(5, 3, 6, 2)
    ours, feats = ts.stream_extend(ours, torch.from_numpy(x),
                                   return_stream=True, stream_stride=2,
                                   backend=_backend(route))
    theirs, jfeats = js.stream_extend(theirs, jnp.asarray(x),
                                      return_stream=True, stream_stride=2)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), **TOL)
    _assert_carries(ours, theirs)
    with pytest.raises(ValueError, match="uniform"):
        ts.stream_extend(ours, torch.from_numpy(x), counts=torch.ones(3),
                         return_stream=True)
    if route is not None:
        assert route == dict(trunc=0, stream=1)


def test_pool_take_and_scatter_match_reference():
    ours, theirs = _pair(5, 2, 2, 4, True)
    x = _incs(7, 5, 3, 2)
    counts = np.array([3, 1, 0, 2, 3])
    ours = ts.stream_extend(ours, torch.from_numpy(x),
                            counts=torch.from_numpy(counts), backend="torch")
    theirs = js.stream_extend(theirs, jnp.asarray(x),
                              counts=jnp.asarray(counts))
    slots = np.array([4, 0, 2])
    sub, jsub = ts.stream_take(ours, slots), js.stream_take(theirs, slots)
    _assert_carries(sub, jsub)
    y = _incs(8, 3, 1, 2)
    sub = ts.stream_extend(sub, torch.from_numpy(y), backend="torch")
    jsub = js.stream_extend(jsub, jnp.asarray(y))
    for put in (slots, np.array([4, 9, -1])):   # 9 is dropped, -1 wraps
        _assert_carries(ts.stream_scatter(ours, put, sub),
                        js.stream_scatter(theirs, jnp.asarray(put), jsub))
    # an out-of-range slot clamps on take; its write-back is dropped
    far = ts.stream_take(ours, [7])
    assert torch.equal(far.sig[0], ours.sig[4])
    assert torch.equal(ts.stream_scatter(ours, [7], far).sig, ours.sig)


def test_pool_guards():
    pool = ts.stream_init(2, 2, 2, capacity=4, device="cpu")
    with pytest.raises(ValueError, match="dim"):
        ts.stream_extend(pool, torch.zeros(2, 1, 3))
    with pytest.raises(ValueError, match="pool size"):
        ts.stream_extend(pool, torch.zeros(3, 1, 2))
    with pytest.raises(ValueError, match="max_drop"):
        ts.stream_rolling_drop(pool, torch.tensor([1, 0]))
    with pytest.raises(ValueError, match="ring"):
        ts.stream_rolling_drop(ts.stream_init(2, 2, 2, device="cpu"), 1)
    assert ts.stream_rolling_drop(pool, 0) is pool
    assert (pool.capacity, pool.size) == (4, 2)
