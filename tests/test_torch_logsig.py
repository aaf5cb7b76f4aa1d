"""Parity of ``repro_torch.core.logsignature`` with the reference: the
dense and projected routes at d <= 4, N <= 5, the factorisation tables,
and the torch engine's gradients.  Tolerances: rtol 2e-4, atol 2e-5."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import logsignature as tl
from repro_torch.kernels import ops

jl = importlib.import_module("repro.core.logsignature")

TOL = dict(rtol=2e-4, atol=2e-5)
CELLS = [(2, 1), (2, 5), (3, 2), (3, 4), (4, 3), (4, 5)]


def _path(seed, B, M, d):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(size=(B, M + 1, d)) * 0.3, axis=1).astype(
        np.float32)


@pytest.mark.parametrize("d,N", CELLS)
def test_logsignature_routes_match_reference(d, N):
    path = _path(d * 10 + N, 2, 6, d)
    tpath = torch.from_numpy(path)
    want = np.asarray(jl.logsignature(jnp.asarray(path), N))
    dense = tl.logsignature(tpath, N, device="cpu").numpy()
    proj = tl.logsignature_projected(tpath, N, device="cpu").numpy()
    assert dense.shape == proj.shape == (2, tl.logsig_dim(d, N))
    assert tl.logsig_dim(d, N) == jl.logsig_dim(d, N)
    np.testing.assert_allclose(dense, want, **TOL)
    np.testing.assert_allclose(proj, np.asarray(
        jl.logsignature_projected(jnp.asarray(path), N)), **TOL)
    np.testing.assert_allclose(proj, dense, **TOL)


@pytest.mark.parametrize("d,N", [(2, 4), (3, 3)])
def test_basepoint_unbatched_and_cuda_engine_route(d, N, monkeypatch):
    path = _path(N, 1, 5, d)[0]
    want = np.asarray(jl.logsignature_projected(jnp.asarray(path), N,
                                                basepoint=True))
    got = tl.logsignature_projected(torch.from_numpy(path), N,
                                    basepoint=True, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the cuda engine's route (ops.projected over the §3.3 word set), with
    # sig_words running its plain version on the CPU tensor
    real = ops.resolve_backend
    monkeypatch.setattr(ops, "resolve_backend",
                        lambda b, dev: "cuda" if b == "auto" else real(b, dev))
    got = tl.logsignature_projected(torch.from_numpy(path), N,
                                    basepoint=True, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("d,N", [(2, 4), (3, 3), (4, 2)])
def test_projected_tables_match_reference(d, N):
    plan, idx, coef, tgt, top_rows, lown = tl._projected_tables(d, N)
    jplan, jidx, jcoef, jtgt, jtop, _, jlown = jl._projected_tables(d, N)
    assert plan.words == jplan.words
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(coef, jcoef)
    np.testing.assert_array_equal(tgt, jtgt)
    np.testing.assert_array_equal(top_rows, jtop)
    assert lown == jlown
    np.testing.assert_array_equal(tl._lyndon_flat_indices(d, N),
                                  jl._lyndon_flat_indices(d, N))


@pytest.mark.parametrize("route", ["logsignature", "logsignature_projected"])
def test_torch_engine_gradients_match_reference(route):
    d, N = 3, 3
    path = _path(5, 2, 5, d)
    co = np.random.default_rng(6).normal(
        size=(2, tl.logsig_dim(d, N))).astype(np.float32)
    gj = jax.grad(lambda p: jnp.vdot(getattr(jl, route)(p, N), co))(
        jnp.asarray(path))
    tpath = torch.from_numpy(path).requires_grad_()
    torch.vdot(getattr(tl, route)(tpath, N, device="cpu").flatten(),
               torch.from_numpy(co).flatten()).backward()
    np.testing.assert_allclose(tpath.grad.numpy(), np.asarray(gj), **TOL)
