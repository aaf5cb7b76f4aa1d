"""Parity of the port's level-list algebra with ``repro.core.tensor_ops``.

The same seeded numpy inputs go through both packages; fp32 tolerance
rtol 2e-4, atol 2e-5 (the reference's kernel tolerance).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tensor_ops as jt
from repro_torch.convert import from_numpy
from repro_torch.core import tensor_ops as tt

TOL = dict(rtol=2e-4, atol=2e-5)


def _levels(rng, B, d, N, scale=0.3):
    return [(rng.normal(size=(B, d**n)) * scale).astype(np.float32)
            for n in range(1, N + 1)]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("d,N", [(2, 4), (3, 3), (4, 2)])
def test_chen_mul_exp_inverse_and_horner(d, N):
    rng = np.random.default_rng(d * 10 + N)
    a, b = _levels(rng, 3, d, N), _levels(rng, 3, d, N)
    dx = (rng.normal(size=(3, d)) * 0.3).astype(np.float32)
    ta, tb, tdx = from_numpy((a, b, dx), device="cpu")
    ja, jb, jdx = [jnp.asarray(x) for x in a], [jnp.asarray(x) for x in b], \
        jnp.asarray(dx)
    for g, w in zip(tt.chen_mul(list(ta), list(tb)), jt.chen_mul(ja, jb)):
        _close(g, w)
    for g, w in zip(tt.tensor_exp(tdx, N), jt.tensor_exp(jdx, N)):
        _close(g, w)
    for g, w in zip(tt.tensor_inverse(list(ta)), jt.tensor_inverse(ja)):
        _close(g, w)
    for g, w in zip(tt.horner_step(list(ta), tdx), jt.horner_step(ja, jdx)):
        _close(g, w)
    flat = tt.levels_to_flat(list(ta))
    _close(flat, jt.levels_to_flat(ja))
    for g, w in zip(tt.flat_to_levels(flat, d, N), ta):
        assert torch.equal(g, w)


@pytest.mark.parametrize("B,M,d,N", [(2, 7, 2, 4), (3, 5, 3, 3)])
def test_oracles_match_reference(B, M, d, N):
    rng = np.random.default_rng(B * M)
    path = np.cumsum(rng.normal(size=(B, M + 1, d)) * 0.3, axis=1).astype(
        np.float32)
    tp = from_numpy(path, device="cpu")
    incs = tt.path_increments(tp)
    _close(incs, jt.path_increments(jnp.asarray(path)))
    _close(tt.signature_exp_chen(incs, N),
           jt.signature_exp_chen(jnp.asarray(incs.numpy()), N))
    _close(tt.signature_cumulative(incs, N),
           jt.signature_cumulative(jnp.asarray(incs.numpy()), N))


def test_flat_to_levels_rejects_wrong_width():
    with pytest.raises(ValueError):
        tt.flat_to_levels(torch.zeros(2, 5), 2, 2)


@pytest.mark.parametrize("d,N", [(2, 5), (3, 3), (4, 2)])
def test_tensor_log_matches_reference_and_inverts_exp(d, N):
    rng = np.random.default_rng(d + N)
    a = _levels(rng, 3, d, N)
    ta = from_numpy(a, device="cpu")
    for g, w in zip(tt.tensor_log(list(ta)),
                    jt.tensor_log([jnp.asarray(x) for x in a])):
        _close(g, w)
    # log(exp(dx)) = dx at level 1 and 0 above
    dx = torch.from_numpy((rng.normal(size=(3, d)) * 0.3).astype(np.float32))
    logs = tt.tensor_log(tt.tensor_exp(dx, N))
    _close(logs[0], dx.numpy())
    for lvl in logs[1:]:
        _close(lvl, np.zeros(lvl.shape, np.float32))


@pytest.mark.parametrize("d,N", [(2, 4), (3, 3), (4, 2)])
def test_inverse_horner_step_matches_reference_and_undoes_the_step(d, N):
    """S ⊗ exp(-dx) (paper Prop. 4.6): the reference's values, and the
    exact inverse of horner_step."""
    rng = np.random.default_rng(d + N)
    a = _levels(rng, 3, d, N)
    dx = (rng.normal(size=(3, d)) * 0.3).astype(np.float32)
    ta, tdx = from_numpy((a, dx), device="cpu")
    got = tt.inverse_horner_step(list(ta), tdx)
    want = jt.inverse_horner_step([jnp.asarray(x) for x in a],
                                  jnp.asarray(dx))
    for g, w in zip(got, want):
        _close(g, w)
    back = tt.inverse_horner_step(tt.horner_step(
        [x.double() for x in ta], tdx.double()), tdx.double())
    for g, w in zip(back, ta):
        torch.testing.assert_close(g, w.double(), rtol=1e-12, atol=1e-12)
