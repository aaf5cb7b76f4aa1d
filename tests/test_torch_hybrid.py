"""The hybrid dense + top-word engine (repro_torch.core.hybrid) and the
``backend="hybrid"`` dispatch cell against the reference's, on the same
numpy inputs (mirrors tests/test_dispatch.py's hybrid cases and
tests/test_logsig.py's hybrid engine test).

Values within rtol 2e-4, atol 2e-5; gradients within the reference's
rtol 1e-3, atol 1e-5.  The ``inverse`` backward saves only the increments
and the output (the §4.2 memory law, by ``saved_tensors_hooks``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import hybrid as jhybrid
from repro.kernels import ops as jops
from repro_torch.core import hybrid, logsignature as tlog
from repro_torch.core import projection as tproj
from repro_torch.core.words import all_words, lyndon_words, make_plan
from repro_torch.kernels import ops

CPU = "cpu"
TOL = dict(rtol=2e-4, atol=2e-5)
GTOL = dict(rtol=1e-3, atol=1e-5)


def _incs(seed, B, M, d, scale=0.3):
    return (np.random.default_rng(seed).normal(size=(B, M, d))
            * scale).astype(np.float32)


def _logsig_words(d, N):
    """The §3.3 set: every word below N, then the Lyndon words at N."""
    return tuple(all_words(d, N - 1)
                 + [w for w in lyndon_words(d, N) if len(w) == N])


def _top(d, N):
    return [w for w in lyndon_words(d, N) if len(w) == N]


def _value_and_grad(fn, x: np.ndarray, w: np.ndarray):
    xt = torch.tensor(x, requires_grad=True)
    out = fn(xt)
    (out * torch.tensor(w)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy()


def _ref_value_and_grad(fn, x: np.ndarray, w: np.ndarray):
    out, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(w))[0])


@pytest.mark.parametrize("backward", ["inverse", "autodiff"])
@pytest.mark.parametrize("d,N,M", [(2, 2, 16), (2, 3, 9), (2, 4, 12),
                                   (3, 2, 7), (3, 3, 16), (3, 4, 5)])
def test_low_plus_top_matches_the_reference(d, N, M, backward):
    x = _incs(N * 10 + d, 3, M, d)
    top = _top(d, N) + [tuple([d - 1] * N)]
    w = np.random.default_rng(1).normal(
        size=(3, len(all_words(d, N - 1)) + len(top))).astype(np.float32)
    got = _value_and_grad(lambda t: hybrid.hybrid_low_plus_top(
        t, top, N, backward=backward), x, w)
    want = _ref_value_and_grad(lambda z: jhybrid.hybrid_low_plus_top(
        z, top, N, backward=backward), x, w)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **GTOL)


def test_low_plus_top_checks():
    with pytest.raises(ValueError, match="depth >= 2"):
        hybrid.hybrid_low_plus_top(torch.zeros(1, 3, 2), [(0,)], 1)
    with pytest.raises(ValueError, match="not of length"):
        hybrid.hybrid_low_plus_top(torch.zeros(1, 3, 2), [(0, 1)], 3)
    out = hybrid.hybrid_low_plus_top(torch.zeros(2, 0, 2), [(0, 1)], 2)
    assert torch.equal(out, torch.zeros(2, 3))


def test_inverse_backward_saves_only_increments_and_output():
    d, N, M = 2, 4, 64
    top = _top(d, N)
    x = torch.tensor(_incs(0, 2, M, d), requires_grad=True)
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = hybrid.hybrid_low_plus_top(x, top, N)
    assert len(saved) == 2
    assert saved[0] is x and saved[1].shape == out.shape
    sizes = {}
    for M in (16, 256):
        x = torch.zeros(1, M, d, requires_grad=True)
        for bw in ("inverse", "autodiff"):
            total = 0

            def count(t):
                nonlocal total
                total += t.numel() * t.element_size()
                return t

            with torch.autograd.graph.saved_tensors_hooks(count,
                                                          lambda t: t):
                hybrid.hybrid_low_plus_top(x, top, N, backward=bw)
            sizes[bw, M] = total
    grow = (256 - 16) * d * 4
    assert sizes["inverse", 256] - sizes["inverse", 16] <= grow
    assert sizes["autodiff", 256] - sizes["autodiff", 16] > 10 * grow


MIXED = ((1, 0, 2), (0,), (2, 1), (0, 0, 0), (1,), (1, 0, 2))


@pytest.mark.parametrize("words", ["logsig", "mixed"])
@pytest.mark.parametrize("fn", ["projected", "projected_forward_only"])
def test_projected_hybrid_matches_the_reference(fn, words):
    d = 3
    ws = _logsig_words(d, 4) if words == "logsig" else MIXED
    x = _incs(4, 3, 15, d)
    got = getattr(ops, fn)(torch.tensor(x), make_plan(ws, d),
                           backend="hybrid", device=CPU)
    want = np.asarray(getattr(jops, fn)(jnp.asarray(x), jcore.make_plan(
        ws, d), backend="hybrid"))
    assert got.shape == (3, len(ws))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    torch_engine = getattr(ops, fn)(torch.tensor(x), ws, backend="torch",
                                    device=CPU)
    np.testing.assert_allclose(got.numpy(), torch_engine.numpy(), **TOL)


@pytest.mark.parametrize("backward", ["inverse", "autodiff", "checkpoint"])
def test_projected_hybrid_gradients_match_the_reference(backward):
    ws, d = _logsig_words(3, 3), 3
    x = _incs(5, 2, 12, d)
    w = np.random.default_rng(2).normal(size=(2, len(ws))).astype(
        np.float32)
    got = _value_and_grad(lambda t: ops.projected(
        t, ws, backend="hybrid", backward=backward, device=CPU), x, w)
    want = _ref_value_and_grad(lambda z: jops.projected(
        z, jcore.make_plan(ws, d), backend="hybrid", backward=backward),
        x, w)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **GTOL)


def test_depth1_fall_through_stream_raise_and_signature_error():
    x = torch.tensor(_incs(6, 2, 9, 3))
    plan1 = ((0,), (2,))
    a = ops.projected(x, plan1, backend="hybrid", device=CPU)
    b = ops.projected(x, plan1, backend="torch", device=CPU)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    with pytest.raises(NotImplementedError, match="streamed"):
        ops.projected(x, MIXED, backend="hybrid", stream=True, device=CPU)
    with pytest.raises(NotImplementedError):
        jops.projected(jnp.asarray(x.numpy()), jcore.make_plan(MIXED, 3),
                       backend="hybrid", stream=True)
    with pytest.raises(ValueError, match="only applies to projected"):
        ops.signature(x, 3, backend="hybrid", device=CPU)


@pytest.mark.parametrize("spec", ["lead_lag", "time_augment+basepoint"])
def test_projected_hybrid_with_a_transform(spec):
    """The transform is materialised, then the hybrid engine runs."""
    from repro_torch.core.transforms import transform_dim
    d_raw = 2
    d = transform_dim(spec, d_raw)
    ws = _logsig_words(d, 3)
    x = _incs(8, 3, 7, d_raw)
    x0 = np.random.default_rng(9).normal(size=(3, d_raw)).astype(np.float32)
    lengths = np.asarray([7, 3, 5])
    bp = "basepoint" in spec
    want = np.asarray(jops.projected(
        jnp.asarray(x), jcore.make_plan(ws, d), backend="hybrid",
        transform=spec, lengths=jnp.asarray(lengths),
        x0=jnp.asarray(x0) if bp else None))
    kw = dict(backend="hybrid", transform=spec, device=CPU,
              lengths=torch.tensor(lengths),
              x0=torch.tensor(x0) if bp else None)
    for fn in (ops.projected, ops.projected_forward_only):
        got = fn(torch.tensor(x), ws, **kw)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


WORDS = ((0,), (1,), (0, 1), (1, 0, 1))


def test_core_projected_signature_and_logsignature_hybrid():
    d, N = 3, 3
    rng = np.random.default_rng(11)
    path = np.cumsum(rng.normal(size=(2, 14, d)) * 0.3, axis=1).astype(
        np.float32)
    a = tproj.projected_signature(torch.tensor(path), WORDS, d,
                                  backend="hybrid", device=CPU)
    b = np.asarray(jcore.projected_signature(jnp.asarray(path), WORDS, d,
                                             backend="hybrid"))
    np.testing.assert_allclose(a.numpy(), b, **TOL)
    la = tlog.logsignature_projected(torch.tensor(path), N,
                                     backend="hybrid", device=CPU)
    lb = np.asarray(jcore.logsignature(jnp.asarray(path), N))
    np.testing.assert_allclose(la.numpy(), lb,
                               atol=1e-4 * max(np.abs(lb).max(), 1.0))


@pytest.mark.parametrize("N", [1, 2, 4])
def test_torch_engine_logsignature_runs_the_hybrid(N, monkeypatch):
    d = 3
    rng = np.random.default_rng(12)
    path = np.cumsum(rng.normal(size=(2, 10, d)) * 0.3, axis=1).astype(
        np.float32)
    calls = []
    real = hybrid.hybrid_low_plus_top

    def counted(*a, **kw):
        calls.append(a[2])
        return real(*a, **kw)

    monkeypatch.setattr(hybrid, "hybrid_low_plus_top", counted)
    w = np.random.default_rng(3).normal(
        size=(2, tlog.logsig_dim(d, N))).astype(np.float32)
    got = _value_and_grad(lambda t: tlog.logsignature_projected(
        t, N, backend="torch", device=CPU), path, w)
    want = _ref_value_and_grad(lambda z: jcore.logsignature_projected(
        z, N, backend="jax"), path, w)
    assert calls == ([N] if N >= 2 else [])
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **GTOL)
