"""Parity of the port's signature heads with ``repro.models.sig_head``.

``sig_pool`` on each route (truncated, strided, log-signature, projected
``plan=``, fused ``transform=``, the kernel-feature head),
``sig_kernel_pool`` and ``sig_stream_features`` (strides, ``plan=``,
``time_augment``), each with and without a ragged ``mask``: values and
the gradients with respect to the hidden states and the head's
parameters, the port's torch engine on the CPU against the reference's
jax engine on the same numpy inputs.  Values rtol 2e-4, atol 2e-5;
gradients rtol 1e-3, atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import words as jwords
from repro.models import sig_head as JS

from repro_torch import configs as tconfigs
from repro_torch.core import words as twords
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import sig_head as TS

VALUE = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
B, S, N_OUT = 3, 10, 5
LENGTHS = (10, 6, 2)

POOL = {
    "truncated": dict(channels=3, depth=3),
    "strided": dict(channels=3, depth=2, stride=3),
    "logsig": dict(channels=3, depth=3, use_logsig=True),
    "projected": dict(channels=3, depth=3),
    "time_augment": dict(channels=2, depth=3, transform="time_augment"),
    "lead_lag": dict(channels=2, depth=2, transform="lead_lag"),
    "projected_lead_lag": dict(channels=2, depth=3, transform="lead_lag"),
    "kernel": dict(channels=3, depth=3, kernel_landmarks=4,
                   landmark_steps=5),
    "kernel_time_augment": dict(channels=2, depth=2, kernel_landmarks=3,
                                transform="time_augment",
                                kernel_normalize=False),
}
STREAM = {
    "stride1": dict(channels=3, depth=3, stream_stride=1),
    "stride3": dict(channels=3, depth=2, stream_stride=3),
    "projected": dict(channels=3, depth=3, stream_stride=2),
    "time_augment": dict(channels=2, depth=2, stream_stride=2,
                         transform="time_augment"),
}
# word sets of the projected cases, over the (augmented) alphabet
WORDS = {"projected": [(0,), (1, 2), (2, 0, 1), (1, 1), (0, 2, 2)],
         "projected_lead_lag": [(0, 2), (3,), (1, 3, 0), (2, 2)]}


def cfgs(kw):
    base_t = tconfigs.reduce_config(tconfigs.get_config("qwen3-4b"))
    base_j = jconfigs.reduce_config(jconfigs.get_config("qwen3-4b"))
    return (tconfigs.with_sig_head(base_t, backend="auto", **kw),
            jconfigs.with_sig_head(base_j, backend="jax", **kw))


def head(cfg, jcfg, seed, n_features=None):
    """The reference's head as numpy and the port's leaves; a projected
    readout reads ``n_features`` (its words and the displacement)."""
    ref = jax.tree.map(np.asarray, JS.init_sig_head(
        jax.random.PRNGKey(seed), jcfg, N_OUT))
    if n_features is not None:
        ref["out"] = np.random.default_rng(seed).normal(
            size=(n_features, N_OUT)).astype(np.float32)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in ref.items()}
    return tp, ref


def inputs(seed, masked):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(B, S, 64)).astype(np.float32)
    mask = (np.arange(S)[None] < np.asarray(LENGTHS)[:, None]).astype(
        np.int32) if masked else None
    return hidden, mask, rng.normal(size=(B, N_OUT)).astype(np.float32)


def plans(name, cfg):
    if name not in WORDS:
        return None, None
    d = TS._sig_channels(cfg.sig_head)
    return (twords.make_plan(WORDS[name], d),
            jwords.make_plan(WORDS[name], d))


def compare(tfn, jfn, tp, ref, hidden, mask, seed):
    """Value and gradients (hidden and every head parameter) of
    sum(out · w) through both packages."""
    th = torch.tensor(hidden, requires_grad=True)
    tm = None if mask is None else torch.from_numpy(mask)
    out = tfn(tp, th, tm)
    w = np.random.default_rng(seed + 1).normal(size=out.shape).astype(
        np.float32)
    jm = None if mask is None else jnp.asarray(mask)

    def jloss(p, h):
        o = jfn(p, h, jm)
        return jnp.sum(o * w), o

    (_, jout), (jgp, jgh) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jax.tree.map(jnp.asarray, ref), jnp.asarray(hidden))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **VALUE)
    names = sorted(tp)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                [th] + [tp[k] for k in names])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgh), **GRAD)
    for k, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[k]), **GRAD,
                                   err_msg=k)
    return out


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "mask"])
@pytest.mark.parametrize("name", list(POOL))
def test_sig_pool_routes(name, masked):
    cfg, jcfg = cfgs(POOL[name])
    if masked and cfg.sig_head.use_logsig:
        hidden, mask, _ = inputs(0, True)
        tp, _ = head(cfg, jcfg, 0)
        with pytest.raises(NotImplementedError, match="ragged"):
            TS.sig_pool(tp, torch.from_numpy(hidden), cfg,
                        mask=torch.from_numpy(mask))
        return
    plan, jplan = plans(name, cfg)
    tp, ref = head(cfg, jcfg, 0, None if plan is None else
                   len(plan.words) + cfg.sig_head.channels)
    hidden, mask, _ = inputs(1, masked)
    out = compare(
        lambda p, h, m: TS.sig_pool(p, h, cfg, plan=plan, mask=m),
        lambda p, h, m: JS.sig_pool(p, h, jcfg, plan=jplan, mask=m),
        tp, ref, hidden, mask, 2)
    assert out.shape == (B, N_OUT)
    assert TS.feature_dim(cfg.sig_head) == JS.feature_dim(jcfg.sig_head)


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "mask"])
@pytest.mark.parametrize("name", list(STREAM))
def test_sig_stream_features(name, masked):
    cfg, jcfg = cfgs(STREAM[name])
    words = [(0,), (1, 2), (2, 0, 1), (1, 1)] if name == "projected" \
        else None
    plan = jplan = None
    if words is not None:
        plan, jplan = twords.make_plan(words, 3), jwords.make_plan(words, 3)
    tp, ref = head(cfg, jcfg, 3, None if words is None else
                   len(words) + cfg.sig_head.channels)
    hidden, mask, _ = inputs(4, masked)
    out = compare(
        lambda p, h, m: TS.sig_stream_features(p, h, cfg, plan=plan, mask=m),
        lambda p, h, m: JS.sig_stream_features(p, h, jcfg, plan=jplan,
                                               mask=m),
        tp, ref, hidden, mask, 5)
    assert out.shape == (B, -(-(S - 1) // cfg.sig_head.stream_stride), N_OUT)


def test_sig_kernel_pool_is_the_kernel_route():
    cfg, jcfg = cfgs(POOL["kernel"])
    tp, ref = head(cfg, jcfg, 6)
    hidden, mask, _ = inputs(7, True)
    compare(lambda p, h, m: TS.sig_kernel_pool(p, h, cfg, mask=m),
            lambda p, h, m: JS.sig_kernel_pool(p, h, jcfg, mask=m),
            tp, ref, hidden, mask, 8)
    th, tm = torch.from_numpy(hidden), torch.from_numpy(mask)
    torch.testing.assert_close(TS.sig_kernel_pool(tp, th, cfg, mask=tm),
                               TS.sig_pool(tp, th, cfg, mask=tm))


def test_mask_path_lengths_and_ragged_disp():
    mask = (np.arange(9)[None] < np.array([9, 4, 1, 0])[:, None]).astype(
        np.int32)
    for stride in (1, 2, 4):
        lengths, norm = TS.mask_path_lengths(torch.from_numpy(mask), stride)
        jl, jn = JS.mask_path_lengths(jnp.asarray(mask), stride)
        np.testing.assert_array_equal(lengths.numpy(), np.asarray(jl))
        np.testing.assert_allclose(norm.numpy(), np.asarray(jn), rtol=1e-7)
    path = np.random.default_rng(0).normal(size=(4, 9, 3)).astype(np.float32)
    lens = np.array([8, 3, 0, 5], np.int32)
    np.testing.assert_allclose(
        TS._ragged_disp(torch.from_numpy(path), torch.from_numpy(lens)),
        JS._ragged_disp(jnp.asarray(path), jnp.asarray(lens)), rtol=1e-7)


def test_rejected_combinations_raise_as_the_reference():
    for kw, fn, match in (
            (dict(use_logsig=True, transform="lead_lag"), "feature_dim",
             "fused-transform"),
            (dict(use_logsig=True, kernel_landmarks=2), "feature_dim",
             "kernel-feature"),
            (dict(transform="lead_lag"), "stream", "time_augment"),
            (dict(kernel_landmarks=2), "stream", "kernel-feature"),
            (dict(use_logsig=True), "stream", "log-signature"),
            (dict(kernel_landmarks=2), "plan", "projected plans")):
        cfg, _ = cfgs(dict(channels=2, depth=2, **kw))
        p = {"proj": torch.zeros(64, 2), "out": torch.zeros(12, 1),
             "landmarks": torch.zeros(2, 3, 2)}
        h = torch.zeros(1, 4, 64)
        with pytest.raises(NotImplementedError, match=match):
            if fn == "feature_dim":
                TS.feature_dim(cfg.sig_head)
            elif fn == "stream":
                TS.sig_stream_features(p, h, cfg)
            else:
                TS.sig_pool(p, h, cfg, plan=twords.make_plan([(0,)], 2))


def test_init_sig_head_and_carry_across():
    cfg, jcfg = cfgs(POOL["kernel"])
    p = TS.init_sig_head(0, cfg, N_OUT, device="cpu")
    ref = JS.init_sig_head(jax.random.PRNGKey(0), jcfg, N_OUT)
    assert sorted(p.keys()) == sorted(ref)
    for k in ref:
        assert tuple(p[k].shape) == ref[k].shape
    np.testing.assert_array_equal(p["landmarks"][:, 0].detach().numpy(), 0)
    # a "sig_head" entry of the reference's parameters comes across as the
    # model's head, which pools as sig_pool does
    import repro.models as JM
    params = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(1),
                                                     jcfg, jnp.float32))
    params["sig_head"] = jax.tree.map(np.asarray, ref)
    model = lm_params_from_reference(params, dataclasses.replace(cfg),
                                     device="cpu")
    hidden = torch.from_numpy(inputs(0, False)[0])
    torch.testing.assert_close(model["sig_head"](hidden),
                               TS.sig_pool(model["sig_head"], hidden, cfg))
