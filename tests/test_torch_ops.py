"""Parity of ``repro_torch.kernels.ops.signature`` with the reference
dispatch, and its support matrix: backends, the ✗ cells, the device rule.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.convert import from_numpy
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
    for kw in (dict(backward="checkpoint"), dict(time_chunks=2),
               dict(transform="time_augment")):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
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
