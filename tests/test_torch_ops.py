"""Parity of ``repro_torch.kernels.ops.signature`` with the reference
dispatch, and the support matrix of ``signature`` and ``projected``:
backends, the ✗ and not-ported cells, the device rule, the plan caches.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.convert import from_numpy
from repro_torch.core import words as tw
from repro_torch.kernels import cache, ops

TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _autotune_off(monkeypatch):
    monkeypatch.setenv("PATHSIG_AUTOTUNE", "off")


def _incs(seed, B, M, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, M, d)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32"])
@pytest.mark.parametrize("split", [None, 1])
def test_dispatch_matches_pallas_interpret(precision, split):
    x = _incs(11, 3, 8, 3)
    lengths = np.array([8, 5, 2])
    want = jops.signature(jnp.asarray(x), 3, backend="pallas_interpret",
                          batch_tile=8, split=split, lengths=lengths,
                          precision=precision)
    got = ops.signature(from_numpy(x, device="cpu"), 3, split=split,
                        lengths=lengths, precision=precision, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32"])
def test_streamed_dispatch_matches_jax_engine(stride, precision):
    x = _incs(stride, 3, 7, 2)
    lengths = np.array([7, 3, 1])
    want = jops.signature(jnp.asarray(x), 4, backend="jax", stream=True,
                          stream_stride=stride, lengths=lengths,
                          precision=precision)
    got = ops.signature(from_numpy(x, device="cpu"), 4, stream=True,
                        stream_stride=stride, lengths=lengths,
                        precision=precision, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_autodiff_and_zero_steps():
    x = from_numpy(_incs(2, 2, 5, 2), device="cpu")
    np.testing.assert_allclose(
        ops.signature(x, 3, backward="autodiff", device="cpu").numpy(),
        ops.signature(x, 3, device="cpu").numpy(), **TOL)
    out = ops.signature(torch.zeros(2, 0, 2), 3, stream=True, device="cpu")
    assert out.shape == (2, 0, 14)


def test_backend_resolution():
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    assert ops.resolve_backend("auto", cpu) == "torch"
    assert ops.resolve_backend("auto", gpu) == "cuda"
    assert ops.resolve_backend("torch", gpu) == "torch"
    assert ops.resolve_backend("cuda", gpu) == "cuda"
    with pytest.raises(ValueError, match="CUDA device"):
        ops.resolve_backend("cuda", cpu)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.resolve_backend("pallas", cpu)


def test_unsupported_cells_raise_like_the_reference():
    x = torch.zeros(1, 3, 2)
    jx = jnp.zeros((1, 3, 2))
    cells = [
        (dict(backend="hybrid"), ValueError),
        (dict(stream=True, backward="checkpoint"), NotImplementedError),
        (dict(stream=True, time_chunks=2), NotImplementedError),
    ]
    for kw, exc in cells:
        with pytest.raises(exc):
            jops.signature(jx, 2, **kw)
        with pytest.raises(exc):
            ops.signature(x, 2, device="cpu", **kw)
    for kw in (dict(backward="nope"), dict(stream=True, stream_stride=0)):
        with pytest.raises(ValueError):
            ops.signature(x, 2, device="cpu", **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.signature(x, 2, backend="cuda", device="cpu")


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.signature(torch.zeros(1, 3, 2), 2)


def test_plan_cache_counts_and_clears():
    @cache.plan_cache
    def square(n):
        return n * n

    assert [square(3), square(3), square(4)] == [9, 9, 16]
    info = square.cache_info()
    assert (info.hits, info.misses, info.maxsize, info.currsize) == (
        1, 2, cache.PLAN_CACHE_MAXSIZE, 2)
    square.cache_clear()
    assert square.cache_info().currsize == 0


# ---------------------------------------------------------------------------
# projected / projected_forward_only: the new support-matrix cells
# ---------------------------------------------------------------------------

WORDS = [(0,), (1, 0), (1, 1, 0)]


@pytest.mark.parametrize("fn", ["projected", "projected_forward_only"])
def test_projected_rejects_a_missing_card_and_a_wrong_alphabet(fn):
    x = torch.zeros(1, 3, 2)
    call = getattr(ops, fn)
    with pytest.raises(ValueError, match="CUDA device"):
        call(x, WORDS, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="letters"):
        call(torch.zeros(1, 3, 4), tw.make_plan(WORDS, 2), device="cpu")


def test_projected_stream_cells_raise_like_the_reference():
    x = torch.zeros(1, 3, 2)
    jx = jnp.zeros((1, 3, 2))
    with pytest.raises(NotImplementedError, match="stream=True"):
        ops.projected(x, WORDS, stream=True, backward="checkpoint",
                      device="cpu")
    with pytest.raises(NotImplementedError):
        jops.projected(jx, WORDS, stream=True, backward="checkpoint")
    for kw in (dict(backward="nope"), dict(stream=True, stream_stride=0)):
        with pytest.raises(ValueError):
            ops.projected(x, WORDS, device="cpu", **kw)


def test_projected_default_device_without_gpu_raises(monkeypatch):
    from repro_torch.core.logsignature import logsignature_projected
    from repro_torch.core.projection import projected_signature
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ops.projected(torch.zeros(1, 3, 2), WORDS),
                 lambda: ops.projected_forward_only(torch.zeros(1, 3, 2),
                                                    WORDS),
                 lambda: projected_signature(torch.zeros(1, 4, 2), WORDS),
                 lambda: logsignature_projected(torch.zeros(1, 4, 2), 3)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_plan_caches_intern_by_content():
    a = ops._normalise_plans(tw.make_plan(WORDS, 2), 2)[0]
    b = ops._normalise_plans(WORDS, 2)[0]
    assert a is b
    tp = tw.make_tiled_plan(WORDS, 2, max_rows=2)
    wplan, tplan = ops._normalise_plans(tp, 2)
    assert wplan is a and tplan is tp
    assert ops._closure_tiled_plan(tuple(WORDS), 2, 8).words == \
        tuple(tw.prefix_closure(WORDS))
    assert ops._tiled_for_words(tuple(WORDS), 2, 8) is \
        ops._tiled_for_words(tuple(WORDS), 2, 8)
