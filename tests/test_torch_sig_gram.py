"""The port's ``sig_gram`` module and ``ops.gram`` against the reference.

On the CPU the wrapper runs its plain version (the word-blocked product);
it is held against the JAX Pallas kernel ``sig_gram_tiles`` in interpret
mode over ragged edges, and ``ops.gram``'s values and its three gradients
against the reference dispatch on the ``jax`` and ``pallas_interpret``
engines.  Tolerances: the reference's Gram acceptance |G − G_ref| <=
1e-5·max|G_ref| for values, and rtol 2e-4, atol 2e-4 for the gradients
(``tests/test_sigkernel.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.sig_gram import sig_gram_tiles
from repro_torch.kernels import ops
from repro_torch.kernels import sig_gram as sg


def _operands(seed, Bx, By, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(Bx, D)).astype(np.float32),
            rng.normal(size=(By, D)).astype(np.float32),
            rng.uniform(0.2, 2.0, D).astype(np.float32))


def _close(got, want, scale=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=scale * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("D", [1, 37, 130])
@pytest.mark.parametrize("Bx,By", [(1, 1), (1, 9), (5, 5), (9, 1), (9, 5)])
def test_plain_matches_pallas_interpret_on_ragged_edges(Bx, By, D):
    x, y, w = _operands(Bx * 100 + By * 10 + D, Bx, By, D)
    for block in (16, 512):
        want = sig_gram_tiles(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                              k_tile=block, interpret=True)
        got = sg.sig_gram_plain(torch.from_numpy(x), torch.from_numpy(y),
                                torch.from_numpy(w), block)
        assert got.shape == (Bx, By) and got.dtype == torch.float32
        _close(got.numpy(), want)


def test_wrapper_runs_the_plain_version_on_cpu():
    x, y, w = _operands(1, 6, 4, 70)
    tx, ty, tw = map(torch.from_numpy, (x, y, w))
    before = sg.launches
    got = sg.sig_gram(tx.double(), ty, tw)
    assert got.dtype == torch.float32 and sg.launches == before
    _close(got.numpy(), sg.sig_gram_plain(tx.double(), ty.double(),
                                          tw.double()).numpy())
    _close(got.numpy(), (x * w) @ y.T)


@pytest.mark.parametrize("shapes", [((3, 5), (4, 6), (5,)),
                                    ((3, 5), (4, 5), (4,)),
                                    ((5,), (4, 5), (5,))])
def test_wrapper_shape_checks(shapes):
    a, b, c = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match="shape mismatch"):
        sg.sig_gram(a, b, c)


def _jax_grads(fn, x, y, w):
    return jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) ** 2),
                    argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(w))


def _torch_grads(fn, x, y, w):
    tx, ty, tw = (torch.tensor(a, requires_grad=True) for a in (x, y, w))
    out = fn(tx, ty, tw)
    (out ** 2).sum().backward()
    return out, (tx.grad, ty.grad, tw.grad)


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32"])
@pytest.mark.parametrize("backend", ["jax", "pallas_interpret"])
def test_gram_values_and_grads_match_reference(backend, precision):
    x, y, w = _operands(7, 5, 4, 37)

    def ref(a, b, c):
        return jops.gram(a, b, c, backend=backend, block_words=16,
                         precision=precision)

    def ours(a, b, c):
        return ops.gram(a, b, c, backend="torch", block_words=16,
                        precision=precision, device="cpu")

    out, g = _torch_grads(ours, x, y, w)
    _close(out.detach().numpy(), ref(*map(jnp.asarray, (x, y, w))))
    for got, want in zip(g, _jax_grads(ref, x, y, w)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)


def test_gram_of_one_operand_sums_both_gradients():
    x, _, w = _operands(8, 6, 1, 20)
    ref = _jax_grads(lambda a, b, c: jops.gram(a, a, c, backend="jax"),
                     x, x, w)
    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(
        w, requires_grad=True)
    (ops.gram(tx, tx, tw, device="cpu") ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref[0]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(ref[2]),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("block", [1, 7, 512, None])
def test_gram_block_width_and_hybrid_do_not_change_values(block):
    x, y, w = _operands(9, 3, 8, 45)
    want = (x.astype(np.float64) * w) @ y.T.astype(np.float64)
    for backend in ("auto", "torch", "hybrid"):
        got = ops.gram(torch.from_numpy(x), torch.from_numpy(y),
                       torch.from_numpy(w), backend=backend,
                       block_words=block, device="cpu")
        _close(got.numpy(), want)


@pytest.mark.parametrize("kw,err", [
    (dict(block_words=0), "block_words"), (dict(bx_tile=0), "bx_tile"),
    (dict(by_tile=-1), "by_tile"), (dict(backend="cuda"), "CUDA device"),
    (dict(backend="nope"), "unknown backend"),
    (dict(precision="fp8"), "unknown precision")])
def test_gram_argument_errors(kw, err):
    x, y, w = map(torch.from_numpy, _operands(10, 2, 2, 4))
    with pytest.raises(ValueError, match=err):
        ops.gram(x, y, w, device="cpu", **kw)


def test_gram_shape_errors():
    x, y, w = map(torch.from_numpy, _operands(11, 2, 2, 4))
    with pytest.raises(ValueError, match="gram needs"):
        ops.gram(x, y[:, :3], w, device="cpu")
    with pytest.raises(ValueError, match="gram needs"):
        ops.gram(x, y, w[:3], device="cpu")
