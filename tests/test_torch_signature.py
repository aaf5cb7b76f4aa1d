"""Parity of ``repro_torch.core.signature`` with ``repro.core.signature``.

Values and gradients of the public path API (basepoint, ragged lengths,
streamed strides, bf16_fp32), the Chen combine / inverse, and the ragged
helpers; tolerances rtol 2e-4, atol 2e-5 (fp32).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.convert import from_numpy
from repro_torch.core import signature as ts

# the module, not the function that repro.core re-exports under its name
js = importlib.import_module("repro.core.signature")

TOL = dict(rtol=2e-4, atol=2e-5)


def _path(seed, B, M, d):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(size=(B, M + 1, d)) * 0.3, axis=1).astype(
        np.float32)


@pytest.mark.parametrize("stream,stride", [(False, 1), (True, 1), (True, 2),
                                           (True, 3)])
@pytest.mark.parametrize("ragged", [False, True])
def test_signature_values_match_reference(stream, stride, ragged):
    path = _path(stride + 7 * ragged, 3, 9, 3)
    lengths = np.array([9, 4, 6]) if ragged else None
    want = js.signature(jnp.asarray(path), 3, stream=stream,
                        stream_stride=stride, lengths=lengths)
    got = ts.signature(from_numpy(path, device="cpu"), 3, stream=stream,
                       stream_stride=stride, lengths=lengths, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32"])
def test_basepoint_and_precision_match_reference(precision):
    path = _path(1, 2, 7, 2)
    want = js.signature(jnp.asarray(path), 4, basepoint=True,
                        lengths=np.array([7, 3]), precision=precision)
    got = ts.signature(from_numpy(path, device="cpu"), 4, basepoint=True,
                       lengths=np.array([7, 3]), precision=precision,
                       device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("backward", ["inverse", "autodiff"])
@pytest.mark.parametrize("stream", [False, True])
def test_torch_engine_gradients_match_reference(backward, stream):
    """The torch engine differentiates by autograd; the reference by its
    §4.2 custom VJP (inverse) or scan AD — the gradients must agree."""
    path = _path(3, 2, 6, 2)
    D = 2 + 4 + 8
    co = np.random.default_rng(4).normal(
        size=(2, 3, D) if stream else (2, D)).astype(np.float32)
    kw = dict(stream=stream, stream_stride=2, backward=backward,
              lengths=np.array([6, 4]))
    gj = jax.grad(lambda p: jnp.vdot(js.signature(p, 3, **kw), co))(
        jnp.asarray(path))
    tp = from_numpy(path, device="cpu").requires_grad_()
    torch.vdot(ts.signature(tp, 3, device="cpu", **kw).flatten(),
               from_numpy(co, device="cpu").flatten()).backward()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gj), **TOL)


def test_unbatched_path_and_ragged_container():
    path = _path(5, 1, 5, 2)
    got = ts.signature(from_numpy(path[0], device="cpu"), 3, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(
        js.signature(jnp.asarray(path[0]), 3)), **TOL)
    from repro_torch.ragged import RaggedPaths
    rp = RaggedPaths.from_list([path[0], path[0][:3]], device="cpu")
    got = ts.signature(rp, 3, device="cpu")
    np.testing.assert_allclose(got[1].numpy(), np.asarray(
        js.signature(jnp.asarray(path[0][:3]), 3)), **TOL)


def test_combine_and_inverse_match_reference():
    a, b = _path(6, 2, 4, 3), _path(7, 2, 5, 3)
    ja, jb = js.signature(jnp.asarray(a), 3), js.signature(jnp.asarray(b), 3)
    ta = ts.signature(from_numpy(a, device="cpu"), 3, device="cpu")
    tb = ts.signature(from_numpy(b, device="cpu"), 3, device="cpu")
    np.testing.assert_allclose(
        ts.signature_combine(ta, tb, 3, 3).numpy(),
        np.asarray(js.signature_combine(ja, jb, 3, 3)), **TOL)
    np.testing.assert_allclose(
        ts.signature_inverse(ta, 3, 3).numpy(),
        np.asarray(js.signature_inverse(ja, 3, 3)), **TOL)


@pytest.mark.parametrize("M,stride", [(0, 1), (1, 1), (7, 1), (7, 3),
                                      (9, 3), (5, 8)])
def test_stream_emission_helpers_match_reference(M, stride):
    np.testing.assert_array_equal(ts.stream_emit_steps(M, stride),
                                  js.stream_emit_steps(M, stride))
    lengths = np.array([0, 1, M, max(M - 2, 0)], np.int32)
    if M:
        np.testing.assert_array_equal(
            ts.stream_emit_mask(M, stride, torch.from_numpy(lengths)).numpy(),
            np.asarray(js.stream_emit_mask(M, stride, jnp.asarray(lengths))))
    np.testing.assert_array_equal(
        ts.length_mask(torch.from_numpy(lengths), M).numpy(),
        np.asarray(js.length_mask(jnp.asarray(lengths), M)))


def test_quantise_rounds_values_and_passes_gradients_straight():
    x = torch.tensor([1.0 + 2**-10, -3.3, 0.1], requires_grad=True)
    q = ts.quantise_increments(x, "bf16")
    np.testing.assert_array_equal(
        q.detach().numpy(),
        np.asarray(js.quantise_increments(jnp.asarray(x.detach().numpy()),
                                          "bf16")))
    q.sum().backward()
    assert torch.equal(x.grad, torch.ones(3))
    with pytest.raises(ValueError):
        ts.canon_precision("fp8")


def test_unported_cells_raise_naming_the_roadmap():
    x = torch.zeros(1, 3, 2)
    with pytest.raises(NotImplementedError, match="stream=True"):
        ts.signature_from_increments(x, 2, backward="checkpoint",
                                     stream=True, backend="torch",
                                     device="cpu")


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.signature(torch.zeros(1, 4, 2), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.signature_from_increments(torch.zeros(1, 4, 2), 2,
                                     backend="torch")
