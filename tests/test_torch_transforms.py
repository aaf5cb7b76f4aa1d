"""Parity of ``repro_torch.core.transforms`` with ``repro.core.transforms``.

Every function of the module on the same numpy inputs from a seed, with
and without ``lengths``, on 2-D and 3-D paths; ``as_transform``'s parsing
and errors; ``fused_adjoint`` as the adjoint of ``fused_augment``
(<A x, y> = <x, Aᵀ y>).  Tolerances rtol 2e-4, atol 2e-5 (fp32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transforms as jt
from repro_torch.core import transforms as tt

TOL = dict(rtol=2e-4, atol=2e-5)
LENGTHS = np.array([6, 3, 1, 0])
SPECS = ["time_augment", "lead_lag", "basepoint", "time_augment+lead_lag",
         "basepoint+lead_lag+time_augment", "basepoint,time"]


def _path(seed, B=4, M=6, d=3):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(size=(B, M + 1, d)) * 0.3, axis=1).astype(
        np.float32)


def _close(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def test_freeze_tail_matches_reference():
    p = _path(1)
    _close(tt.freeze_tail(torch.from_numpy(p), LENGTHS),
           jt.freeze_tail(jnp.asarray(p), LENGTHS))


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("name", ["lead_lag", "time_augment",
                                  "basepoint_augment"])
def test_path_transforms_match_reference(name, ragged, ndim):
    p = _path(1)
    lens = LENGTHS if ragged else None
    if ndim == 2:
        p, lens = p[0], (None if lens is None else int(LENGTHS[0]))
    got = getattr(tt, name)(torch.from_numpy(p), lengths=lens)
    want = getattr(jt, name)(jnp.asarray(p), lengths=lens)
    _close(got, want)


@pytest.mark.parametrize("t0,t1", [(0.0, 1.0), (-2.0, 3.5)])
@pytest.mark.parametrize("ragged", [False, True])
def test_time_augment_span(ragged, t0, t1):
    p = _path(2)
    lens = LENGTHS if ragged else None
    _close(tt.time_augment(torch.from_numpy(p), t0, t1, lengths=lens),
           jt.time_augment(jnp.asarray(p), t0, t1, lengths=lens))


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("spec", SPECS)
def test_apply_transform_matches_reference(spec, ragged, ndim):
    p = _path(3)
    lens = LENGTHS if ragged else None
    if ndim == 2:
        p, lens = p[0], (None if lens is None else int(LENGTHS[0]))
    _close(tt.apply_transform(torch.from_numpy(p), spec, lengths=lens),
           jt.apply_transform(jnp.asarray(p), spec, lengths=lens))


def test_as_transform_parses_like_the_reference():
    cases = [None, "time_augment", "lead_lag", "leadlag", "basepoint",
             "basepoint_augment", "time", "time_augment+lead_lag",
             "lead_lag,basepoint", " Lead_Lag ", ["time", "leadlag"], (),
             "", "+"]
    for c in cases:
        want = jt.as_transform(c)
        got = tt.as_transform(c)
        if want is None:
            assert got is None, c
            continue
        assert (got.basepoint, got.lead_lag, got.time, got.t0, got.t1) == (
            want.basepoint, want.lead_lag, want.time, want.t0, want.t1), c
        assert got.sub_steps == want.sub_steps
        assert bool(got)
    spec = tt.Transform(time=True, t0=1.0, t1=2.0)
    assert tt.as_transform(spec) is spec
    assert tt.as_transform(tt.Transform()) is None
    assert hash(spec) == hash(tt.Transform(time=True, t0=1.0, t1=2.0))
    for bad in ("lead-lag", "time_augment+wavelet", ["basepoint", 3]):
        with pytest.raises(ValueError, match="unknown transform"):
            jt.as_transform(bad)
        with pytest.raises(ValueError, match="unknown transform"):
            tt.as_transform(bad)


@pytest.mark.parametrize("spec", SPECS + [None])
def test_counts_match_reference(spec):
    for d in (1, 3, 5):
        assert tt.transform_dim(spec, d) == jt.transform_dim(spec, d)
    for M in (0, 1, 7):
        assert tt.transform_steps(spec, M) == jt.transform_steps(spec, M)
    got = tt.transform_lengths(spec, torch.from_numpy(LENGTHS))
    want = jt.transform_lengths(spec, jnp.asarray(LENGTHS))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert tt.transform_lengths(spec, None) is None


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("spec", SPECS + [None])
def test_time_aux_matches_reference(spec, ragged):
    lens = LENGTHS if ragged else None
    got = tt.transform_time_aux(spec, 4, 7, lens)
    want = jt.transform_time_aux(spec, 4, 7, lens)
    assert got.dtype == torch.float32 and got.shape == (4, 2)
    _close(got, want)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("spec", ["time_augment", "lead_lag",
                                  "time_augment+lead_lag"])
def test_fused_augment_and_adjoint_match_reference(spec, ragged):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 5, 3)).astype(np.float32)
    lens = LENGTHS.clip(max=5) if ragged else None
    taux_j = jt.transform_time_aux(spec, 4, 5, lens)
    taux_t = tt.transform_time_aux(spec, 4, 5, lens)
    aug = tt.fused_augment(torch.from_numpy(x), taux_t, spec)
    _close(aug, jt.fused_augment(jnp.asarray(x), taux_j, spec))
    g = rng.normal(size=tuple(aug.shape)).astype(np.float32)
    _close(tt.fused_adjoint(torch.from_numpy(g), spec, 3),
           jt.fused_adjoint(jnp.asarray(g), spec, 3))


@pytest.mark.parametrize("spec", ["time_augment", "lead_lag",
                                  "time_augment+lead_lag"])
def test_fused_adjoint_is_the_adjoint(spec):
    """<A x, y> = <x, Aᵀ y> for the linear part of fused_augment: the time
    channel does not depend on x, so it is held at zero (taux = 0)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(3, 6, 2)))
    taux = torch.zeros(3, 2, dtype=torch.float64)
    ax = tt.fused_augment(x, taux, spec)
    y = torch.from_numpy(rng.normal(size=tuple(ax.shape)))
    lhs = (ax * y).sum()
    rhs = (x * tt.fused_adjoint(y, spec, 2)).sum()
    torch.testing.assert_close(lhs, rhs, rtol=1e-12, atol=1e-12)
    assert tt.fused_augment(x, taux, None) is x
    assert tt.fused_adjoint(y, None, 2) is y


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("spec", SPECS + [None])
def test_augment_increments_matches_reference(spec, ragged):
    p = _path(6)
    x, x0 = np.diff(p, axis=1), p[:, 0]
    lens = LENGTHS if ragged else None
    got = tt.augment_increments(torch.from_numpy(x), spec,
                                x0=torch.from_numpy(x0), lengths=lens)
    want = jt.augment_increments(jnp.asarray(x), spec, x0=jnp.asarray(x0),
                                 lengths=lens)
    _close(got, want)
    # and the increments of the materialised path, as its docstring says
    # (the identity transform leaves the padded tail as it is)
    if spec is None:
        return
    mat = tt.apply_transform(torch.from_numpy(p), spec, lengths=lens)
    mat = mat[0] if isinstance(mat, tuple) else mat
    aug = got[0] if isinstance(got, tuple) else got
    _close(aug, np.diff(mat.numpy(), axis=1))


@pytest.mark.parametrize("spec", SPECS)
def test_augment_adjoint_matches_reference(spec):
    rng = np.random.default_rng(7)
    M, d = 5, 3
    n = tt.transform_steps(spec, M)
    g = rng.normal(size=(2, n, tt.transform_dim(spec, d))).astype(np.float32)
    got = tt.augment_adjoint(torch.from_numpy(g), spec, d)
    want = jt.augment_adjoint(jnp.asarray(g), spec, d)
    _close(got[0], want[0])
    assert (got[1] is None) == (want[1] is None)
    if want[1] is not None:
        _close(got[1], want[1])


def test_basepoint_without_x0_raises():
    with pytest.raises(ValueError, match="x0"):
        tt.augment_increments(torch.zeros(1, 3, 2), "basepoint")


def test_sparse_leadlag_generators_match_reference():
    for d in (1, 2, 5):
        assert tt.sparse_leadlag_generators(d) == \
            jt.sparse_leadlag_generators(d)
