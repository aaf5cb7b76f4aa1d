"""Parity of the port's §8 Hurst training with the reference example.

``examples/hurst_fbm.py`` (JAX, loaded by file path) and
``examples/hurst_fbm_torch.py`` run the same model on the same numpy
batch: the reference's parameters are carried across by
``convert.hurst_params_from_reference`` and the port takes its whitening
on the same batch.  The port runs on the CPU, where the signature's
backward is the plain §4.2 sweep; the reference runs its jax engine and
its inverse VJP.  Tolerances: the loss to 1e-5 relative, each gradient to
1e-4·max|g|, parameters after three Adam steps to 1e-4, and the loss
curve of 20 full-batch Adam steps to 1e-4 relative.
"""
import importlib.util
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch.convert import hurst_params_from_reference
from repro_torch.core import words as tw
from repro_torch.core.transforms import sparse_leadlag_generators
from repro_torch.data import pipeline as tpipe

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load("hurst_fbm")
port = _load("hurst_fbm_torch")


def test_fbm_paths_and_dataset_equal_the_reference():
    X, H = tpipe.hurst_dataset(seed=3, n_paths=7, n_steps=16, d=2)
    Xr, Hr = jpipe.hurst_dataset(seed=3, n_paths=7, n_steps=16, d=2)
    np.testing.assert_array_equal(X, Xr)
    np.testing.assert_array_equal(H, Hr)
    a = tpipe.fbm_paths(np.random.default_rng(5), 4, 9, 0.3, d=3)
    b = jpipe.fbm_paths(np.random.default_rng(5), 4, 9, 0.3, d=3)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.float32 and a.shape == (4, 10, 3)
    assert not a[:, 0].any()


def _leaves(params):
    """(name, array) of a reference pytree, in the port's state-dict
    names."""
    out = [] if "scale" not in params else [("scale", params["scale"])]
    for i, layer in enumerate(params["mlp"]):
        out += [(f"mlp.{i}.w", layer["w"]), (f"mlp.{i}.b", layer["b"])]
    return out


def _models(kind, depth, B=8, M=20, d=2):
    X, H = tpipe.hurst_dataset(seed=1, n_paths=B, n_steps=M, d=d)
    params, apply, feat_dim = ref.make_model(
        kind, d, depth, M, jax.random.PRNGKey(0), jnp.asarray(X))
    model = port.HurstModel(kind, d, depth, M, device="cpu")
    model.load_state_dict(hurst_params_from_reference(params, "cpu"))
    model.whiten(torch.from_numpy(X))
    assert model.feat_dim == feat_dim
    return X, H, params, apply, model


def _ref_loss(apply):
    return lambda p, x, y: jnp.mean((apply(p, x) - y) ** 2)


@pytest.mark.parametrize("kind,depth", [("truncated", 2), ("truncated", 3),
                                        ("sparse", 2), ("sparse", 3),
                                        ("fnn", 2)])
def test_loss_and_gradients_match_the_reference(kind, depth):
    X, H, params, apply, model = _models(kind, depth)
    # the whitening: the reference keeps it in its apply closure
    closure = inspect.getclosurevars(apply).nonlocals
    np.testing.assert_allclose(model.mu.numpy(), np.asarray(closure["mu"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(model.sd.numpy(), np.asarray(closure["sd"]),
                               rtol=1e-5, atol=1e-6)
    loss_r, g_r = jax.value_and_grad(_ref_loss(apply))(
        params, jnp.asarray(X), jnp.asarray(H))
    loss = port.mse(model, torch.from_numpy(X), torch.from_numpy(H))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_r), rtol=1e-5)
    got = dict(model.named_parameters())
    for name, want in _leaves(g_r):
        want = np.asarray(want)
        np.testing.assert_allclose(got[name].grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["truncated", "sparse"])
def test_three_adam_steps_match_the_reference(kind):
    X, H, params, apply, model = _models(kind, 3)
    lr = 1e-2
    vg = jax.jit(jax.value_and_grad(_ref_loss(apply)))
    m = jax.tree.map(jnp.zeros_like, params)
    v = jax.tree.map(jnp.zeros_like, params)
    opt = port.adam(model, lr)
    x, y = torch.from_numpy(X), torch.from_numpy(H)
    for t in range(1, 4):   # examples/hurst_fbm.py's step, written out
        _, g = vg(params, jnp.asarray(X), jnp.asarray(H))
        m = jax.tree.map(lambda a, b: 0.9 * a + 0.1 * b, m, g)
        v = jax.tree.map(lambda a, b: 0.999 * a + 0.001 * b * b, v, g)
        mh = jax.tree.map(lambda a: a / (1 - 0.9 ** t), m)
        vh = jax.tree.map(lambda a: a / (1 - 0.999 ** t), v)
        params = jax.tree.map(
            lambda p, a, b: p - lr * a / (jnp.sqrt(b) + 1e-8), params, mh,
            vh)
        opt.zero_grad()
        port.mse(model, x, y).backward()
        opt.step()
    got = dict(model.named_parameters())
    for name, want in _leaves(params):
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   np.asarray(want), rtol=0, atol=1e-4,
                                   err_msg=name)


def _ref_adam_curve(params, apply, X, H, lr, steps, dtype):
    """The reference's full-batch Adam (examples/hurst_fbm.py's step,
    written out): the loss before each step."""
    vg = jax.jit(jax.value_and_grad(_ref_loss(apply)))
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    m = jax.tree.map(jnp.zeros_like, params)
    v = jax.tree.map(jnp.zeros_like, params)
    x, y = jnp.asarray(X, dtype), jnp.asarray(H, dtype)
    curve = []
    for t in range(1, steps + 1):
        loss, g = vg(params, x, y)
        curve.append(float(loss))
        m = jax.tree.map(lambda a, b: 0.9 * a + 0.1 * b, m, g)
        v = jax.tree.map(lambda a, b: 0.999 * a + 0.001 * b * b, v, g)
        mh = jax.tree.map(lambda a: a / (1 - 0.9 ** t), m)
        vh = jax.tree.map(lambda a: a / (1 - 0.999 ** t), v)
        params = jax.tree.map(
            lambda p, a, b: p - lr * a / (jnp.sqrt(b) + 1e-8), params, mh,
            vh)
    return np.asarray(curve)


def _port_adam_curve(model, X, H, lr, steps):
    dtype = next(model.parameters()).dtype
    x, y = torch.from_numpy(X).to(dtype), torch.from_numpy(H).to(dtype)
    opt = port.adam(model, lr)
    curve = []
    for _ in range(steps):
        opt.zero_grad()
        loss = port.mse(model, x, y)
        loss.backward()
        opt.step()
        curve.append(float(loss.detach()))
    return np.asarray(curve)


@pytest.mark.parametrize("kind", ["truncated", "sparse"])
def test_twenty_adam_steps_follow_the_references_curve(kind):
    """The §8 loss curves over 20 full-batch Adam steps at lr 1e-2, held
    at 1e-4 relative: the two part by float32's own spread, each about as
    far from its own float64 run (tools/hurst_curves.py)."""
    X, H, params, apply, model = _models(kind, 3)
    want = _ref_adam_curve(params, apply, X, H, 1e-2, 20, jnp.float32)
    got = _port_adam_curve(model, X, H, 1e-2, 20)
    assert want[-1] < 0.1 * want[0]              # the curve does descend
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def test_train_runs_an_epoch_on_the_cpu():
    X, H = tpipe.hurst_dataset(seed=2, n_paths=40, n_steps=10, d=2)
    X, H = torch.from_numpy(X), torch.from_numpy(H)
    out = port.train("sparse", X[:32], H[:32], X[32:], H[32:], depth=2,
                     epochs=2, batch=16, lr=1e-2)
    words = tw.generated_words(sparse_leadlag_generators(2), 2)
    assert out["feat_dim"] == len(words) and len(out["curve"]) == 2
    assert all(np.isfinite(out["curve"]))
