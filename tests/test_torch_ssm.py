"""Parity of the port's state-space blocks with ``repro.models.ssm``.

Mamba2: ``mamba_block`` with chunk 8 over S = 20 (so the padding and
several chunks run) and with the default chunk, values and every
gradient; the decode cache step by step against the reference's cached
path (conv ring and SSM state); the chunked SSD scan at S = 256 with the
decay that overflows float32 above the diagonal (same values, finite
gradients).  RWKV6: ``rwkv_block`` values and gradients, and its decode
cache step by step.  The reference's parameters are perturbed so no
zero-initialised leaf stays zero.  Values rtol 2e-4, atol 2e-5;
gradients rtol 1e-3, atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ssm as JS

from repro_torch import configs as tconfigs
from repro_torch.models import ssm as TS

VALUE = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)


def cfgs(arch, **kw):
    return (dataclasses.replace(
                tconfigs.reduce_config(tconfigs.get_config(arch)), **kw),
            dataclasses.replace(
                jconfigs.reduce_config(jconfigs.get_config(arch)), **kw))


def params(init, jcfg, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + scale * rng.normal(
        size=x.shape)).astype(np.float32), init(jax.random.PRNGKey(seed),
                                                jcfg))


def normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def block_both(block, init, arch, S, seed=0, **kw):
    """Value and gradients of sum(block(x) · w) / (B·S) (a per-token mean,
    as the LM loss is) in both packages."""
    cfg, jcfg = cfgs(arch)
    p = params(init, jcfg, seed)
    x = normal((2, S, cfg.d_model), seed, 0.5)
    w = normal((2, S, cfg.d_model), seed + 1) / (2 * S)
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, none = getattr(TS, block)(tp, tx, cfg, **kw)
    assert none is None
    names, tensors = zip(*tp.items())
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                (tx,) + tensors)

    def jloss(pp, xx):
        o, _ = getattr(JS, block)(pp, xx, jcfg, **kw)
        return jnp.sum(o * w), o

    (_, want), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jax.tree.map(jnp.asarray, p),
                                              jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **VALUE)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg[1]), **GRAD)
    for k, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[0][k]), **GRAD,
                                   err_msg=k)


@pytest.mark.parametrize("S,chunk", [(20, 8), (16, 8), (7, 128)])
def test_mamba_block_values_and_gradients(S, chunk):
    block_both("mamba_block", JS.init_mamba, "zamba2-7b", S, chunk=chunk)


def test_rwkv_block_values_and_gradients():
    block_both("rwkv_block", JS.init_rwkv, "rwkv6-1.6b", 9, seed=3)


def cache_steps(block, init, cache_fn, arch, steps, seed=0):
    """Feed chunks of ``steps`` tokens through the cached block in both
    packages, comparing outputs and caches after each."""
    cfg, jcfg = cfgs(arch)
    p = params(init, jcfg, seed)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    jp = jax.tree.map(jnp.asarray, p)
    tc = getattr(TS, cache_fn)(cfg, 2, torch.float32, device="cpu")
    jc = getattr(JS, cache_fn)(jcfg, 2, jnp.float32)
    x = normal((2, sum(steps), cfg.d_model), seed, 0.5)
    done = 0
    for n in steps:
        xs = x[:, done:done + n]
        done += n
        out, tc = getattr(TS, block)(tp, torch.from_numpy(xs), cfg, cache=tc)
        want, jc = getattr(JS, block)(jp, jnp.asarray(xs), jcfg, cache=jc)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **VALUE)
        assert sorted(tc) == sorted(jc)
        for k in tc:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       **VALUE, err_msg=k)
    assert tc["ssm" if "ssm" in tc else "wkv"].dtype == torch.float32
    # the cached path over the whole sequence is the uncached block
    full, _ = getattr(TS, block)(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), full[:, -steps[-1]:].numpy(),
                               **VALUE)


def test_mamba_decode_cache_steps():
    cache_steps("mamba_block", JS.init_mamba, "mamba_cache", "zamba2-7b",
                [1, 1, 3, 1])


def test_rwkv_decode_cache_steps():
    cache_steps("rwkv_block", JS.init_rwkv, "rwkv_cache", "rwkv6-1.6b",
                [1, 2, 1, 1], seed=1)


def test_ssd_chunked_overflowing_decay_has_finite_gradients():
    """With a step's decay near 1 (softplus(0) = 0.69 at init), the
    exponent above the diagonal of a 128-step chunk reaches ~127 times it,
    past float32's range (88.7): the values equal the reference's and the
    gradient is finite."""
    B, S, nh, hd, ds = 1, 256, 2, 4, 8
    xh = normal((B, S, nh, hd), 0)
    dt = np.full((B, S, nh), 1.0, np.float32)
    a_log = -dt
    Bc, Cc = normal((B, S, ds), 1, 0.3), normal((B, S, ds), 2, 0.3)
    assert float(-a_log[0, :127, 0].sum()) > 88.8  # exp overflows float32
    want = JS._ssd_chunked(*map(jnp.asarray, (xh, dt, a_log, Bc, Cc)), 128)
    args = [torch.from_numpy(a).requires_grad_()
            for a in (xh, dt, a_log, Bc, Cc)]
    got = TS._ssd_chunked(*args, 128)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **VALUE)
    grads = torch.autograd.grad((got * torch.from_numpy(
        normal(got.shape, 3))).sum(), args)
    for g in grads:
        assert torch.isfinite(g).all()


def test_token_shift_and_causal_conv():
    x = normal((2, 5, 6), 4)
    prev = normal((2, 6), 5)
    np.testing.assert_array_equal(
        TS._token_shift(torch.from_numpy(x), torch.from_numpy(prev)).numpy(),
        np.asarray(JS._token_shift(jnp.asarray(x), jnp.asarray(prev))))
    w, b = normal((4, 6), 6), normal((6,), 7)
    np.testing.assert_allclose(
        TS._causal_conv(*map(torch.from_numpy, (x, w, b))).numpy(),
        np.asarray(JS._causal_conv(*map(jnp.asarray, (x, w, b)))), **VALUE)
