"""Parity of the port's mixture of experts and multi-head latent attention
with ``repro.models.layers``.

``moe`` against the reference's on the same numpy parameters and inputs:
the dropless single group (T <= 4E), the grouped capacity dispatch with
ample and tight capacity, values, the aux loss and every gradient; the
port's mirrors of ``tests/test_moe.py`` (grouped dispatch against a dense
dropless loop, small token counts dropless, tight capacity finite,
gradients) and of ``tests/test_archs.py::test_moe_capacity_drops_at_scale``;
top-k ties; the group rule at the published configs.  ``mla_attention``
with and without a cache, with and without the query's low-rank path.
Values rtol 2e-4, atol 2e-5; gradients rtol 1e-3, atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro.models import layers as JL

from repro_torch import configs as tconfigs
from repro_torch.models import layers as TL

VALUE = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
MOE = ["phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b"]


def cfgs(arch="phi3.5-moe-42b-a6.6b", **kw):
    return (dataclasses.replace(
                tconfigs.reduce_config(tconfigs.get_config(arch)), **kw),
            dataclasses.replace(
                jconfigs.reduce_config(jconfigs.get_config(arch)), **kw))


def params(init, jcfg, seed=0, scale=0.1):
    """The reference's init as numpy, every leaf perturbed."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + scale * rng.normal(
        size=x.shape)).astype(np.float32), init(jax.random.PRNGKey(seed),
                                                jcfg))


def port(tree):
    """numpy tree -> tensors that require grad (nested dicts kept)."""
    return {k: port(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)).requires_grad_()
            for k, v in tree.items()}


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def x_of(shape, d, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(
        size=shape + (d,))).astype(np.float32)


def moe_both(arch, shape, seed=0, **kw):
    """The port's and the reference's moe: (out, aux), grads of
    sum(out · w) + aux (w a fixed random cotangent) w.r.t. x and every
    parameter, for each.  x is scaled by 0.3, as ``tests/test_moe.py``
    scales it."""
    cfg, jcfg = cfgs(arch, **kw)
    p = params(JL.init_moe, jcfg, seed)
    x = x_of(shape, cfg.d_model, seed, scale=0.3)
    w = x_of(shape, cfg.d_model, seed + 1)
    tp, tx = port(p), torch.from_numpy(x).requires_grad_()
    out, aux = TL.moe(tp, tx, cfg)
    names, tensors = zip(*leaves(tp).items())
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux,
                                (tx,) + tensors)

    def jloss(pp, xx):
        o, a = JL.moe(pp, xx, jcfg)
        return jnp.sum(o * w) + a, (o, a)

    (_, (jout, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    want = dict(leaves(jax.tree.map(np.asarray, jg[0])), x=np.asarray(jg[1]))
    got = dict(zip(names, grads[1:]), x=grads[0])
    return cfg, (out, aux, got), (np.asarray(jout), float(jaux), want)


# (config overrides, (B, S)): dropless, grouped with ample and tight
# capacity, one group above 4E, a T with no divisor near the group size
CASES = [
    (dict(), (1, 3)),
    (dict(), (2, 8)),
    (dict(capacity_factor=8.0, moe_group_size=8), (2, 16)),
    (dict(capacity_factor=0.5, moe_group_size=8), (2, 64)),
    (dict(capacity_factor=0.5), (4, 32)),
    (dict(capacity_factor=1.0, moe_group_size=16), (3, 23)),
]


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("kw,shape", CASES,
                         ids=[f"{i}" for i in range(len(CASES))])
def test_moe_values_aux_and_gradients_equal_the_reference(arch, kw, shape):
    cfg, (out, aux, got), (jout, jaux, want) = moe_both(arch, shape, **kw)
    np.testing.assert_allclose(out.detach().numpy(), jout, **VALUE)
    np.testing.assert_allclose(float(aux), jaux, **VALUE)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], **GRAD,
                                   err_msg=k)
    assert ("shared.w_up" in got) == bool(cfg.n_shared_experts)


def _reference_groups(cfg, T):
    """The reference's group rule, written out as it stands in
    ``repro.models.layers.moe``."""
    E, k = cfg.n_experts, cfg.top_k
    if T <= 4 * E or cfg.capacity_factor <= 0:
        return 1, T, T
    Tg = min(cfg.moe_group_size or T, T)
    while T % Tg:
        Tg -= 1
    return T // Tg, Tg, max(1, int(cfg.capacity_factor * Tg * k / E))


@pytest.mark.parametrize("arch", MOE)
def test_group_rule_at_the_published_configs(arch):
    cfg = tconfigs.get_config(arch)
    for T in (1, 4, 64, 4 * cfg.n_experts, 4 * cfg.n_experts + 1, 1000,
              4096, 8 * 512 + 6):
        assert TL.moe_groups(cfg, T) == _reference_groups(cfg, T), T
    # 8 x 512 training tokens: 8 groups of 512 with 60 (deepseek) or 80
    # (phi3.5) slots an expert
    want = {"deepseek-v2-lite-16b": 60, "phi3.5-moe-42b-a6.6b": 80}[arch]
    assert TL.moe_groups(cfg, 4096) == (8, 512, want)
    # up to 4E tokens: one dropless group
    T = 4 * cfg.n_experts
    assert TL.moe_groups(cfg, T) == (1, T, T)


def test_top_k_ties_take_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2],
                      [0.0, 0.5, 0.5, 0.0]], np.float32)
    for k in (1, 2, 3):
        vals, idx = TL.top_k(torch.from_numpy(probs), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


# ------------------------------------------- mirrors of tests/test_moe.py

def _dense_reference(p, x, cfg):
    """Dropless oracle: every token through its top-k experts, dense loop."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    probs = torch.softmax(xt @ p["router"], dim=-1)
    gate_vals, gate_idx = TL.top_k(probs, cfg.top_k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    out = torch.zeros_like(xt)
    for e in range(cfg.n_experts):
        y = (F.silu(xt @ p["w_gate"][e]) * (xt @ p["w_up"][e])) \
            @ p["w_down"][e]
        for k in range(cfg.top_k):
            out = out + torch.where(gate_idx[:, k] == e, gate_vals[:, k],
                                    0.0)[:, None] * y
    if cfg.n_shared_experts:
        out = out + TL.mlp(p["shared"], x, cfg.act).reshape(B * S, d)
    return out.reshape(B, S, d)


def _moe_params(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    return TL.init_moe(g, cfg)


@pytest.mark.parametrize("group", [0, 8, 16])
def test_grouped_dispatch_matches_dropless_reference(group):
    cfg, _ = cfgs(capacity_factor=8.0, moe_group_size=group)  # ample
    p = _moe_params(cfg)
    x = torch.from_numpy(x_of((2, 16), cfg.d_model, scale=0.3))
    got, aux = TL.moe(p, x, cfg)
    np.testing.assert_allclose(got.numpy(),
                               _dense_reference(p, x, cfg).numpy(),
                               rtol=2e-4, atol=2e-4)
    assert np.isfinite(float(aux))


def test_small_token_counts_are_dropless():
    """T <= 4E uses one dropless group: prefill == sum of decode steps."""
    cfg, _ = cfgs()
    p = _moe_params(cfg)
    x = torch.from_numpy(x_of((1, 3), cfg.d_model, scale=0.3))
    full, _ = TL.moe(p, x, cfg)
    stepwise = torch.cat([TL.moe(p, x[:, i:i + 1], cfg)[0]
                          for i in range(3)], dim=1)
    np.testing.assert_allclose(full.numpy(), stepwise.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_tight_capacity_drops_but_stays_finite():
    cfg, _ = cfgs(capacity_factor=0.5, moe_group_size=8)
    p = _moe_params(cfg)
    x = torch.from_numpy(x_of((2, 64), cfg.d_model))
    out, aux = TL.moe(p, x, cfg)
    assert torch.isfinite(out).all()
    # capacity drops make the output differ from dropless, by construction
    assert float((out - _dense_reference(p, x, cfg)).abs().max()) > 0


def test_grouped_dispatch_gradients_flow():
    cfg, _ = cfgs(capacity_factor=2.0, moe_group_size=8)
    p = {k: v.requires_grad_() if isinstance(v, torch.Tensor) else v
         for k, v in _moe_params(cfg).items()}
    x = torch.from_numpy(x_of((2, 16), cfg.d_model, scale=0.3))
    out, aux = TL.moe(p, x, cfg)
    names = [k for k, v in p.items() if isinstance(v, torch.Tensor)]
    grads = torch.autograd.grad((out ** 2).sum() + aux,
                                [p[k] for k in names])
    for k, g in zip(names, grads):
        assert torch.isfinite(g).all(), k
    assert float(grads[names.index("w_up")].abs().max()) > 0


def test_moe_capacity_drops_at_scale():
    """Capacity dispatch must kick in (and drop) for large token counts."""
    cfg, _ = cfgs(capacity_factor=0.5)
    p = _moe_params(cfg)
    x = torch.from_numpy(x_of((4, 32), cfg.d_model, scale=0.1))  # T > 4E
    out, aux = TL.moe(p, x, cfg)
    assert TL.moe_groups(cfg, 128)[2] < 128
    assert torch.isfinite(out).all()
    assert float(aux) > 0


# ------------------------------------------------------------------- MLA

@pytest.mark.parametrize("q_lora_rank", [0, 24])
def test_mla_attention_without_and_with_a_cache(q_lora_rank):
    cfg, jcfg = cfgs("deepseek-v2-lite-16b", q_lora_rank=q_lora_rank)
    p = params(JL.init_mla, jcfg, seed=1)
    assert ("w_dq" in p) == bool(q_lora_rank)
    B, S, T = 2, 5, 9
    x = x_of((B, S), cfg.d_model, seed=1)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    tp = port(p)
    tx = torch.from_numpy(x).requires_grad_()
    got, none = TL.mla_attention(tp, tx, cfg, torch.from_numpy(pos))
    assert none is None
    names, tensors = zip(*tp.items())
    grads = torch.autograd.grad((got ** 2).sum(), (tx,) + tensors)

    def jloss(pp, xx):
        o, _ = JL.mla_attention(pp, xx, jcfg, jnp.asarray(pos))
        return jnp.sum(o ** 2), o

    (_, want), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jax.tree.map(jnp.asarray, p),
                                              jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **VALUE)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg[1]), **GRAD)
    for k, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[0][k]), **GRAD,
                                   err_msg=k)
    # two decode tokens against a cache filled to index 4, then one more
    # at the end of the cache, where the write is clamped
    rng = np.random.default_rng(2)
    cc = rng.normal(size=(B, T, cfg.kv_lora_rank)).astype(np.float32)
    cr = rng.normal(size=(B, T, cfg.qk_rope_dim)).astype(np.float32)
    tc = {"c_kv": torch.from_numpy(cc.copy()),
          "k_rope": torch.from_numpy(cr.copy()),
          "index": torch.tensor(4, dtype=torch.int32)}
    jc = {"c_kv": jnp.asarray(cc), "k_rope": jnp.asarray(cr),
          "index": jnp.int32(4)}
    tpd = {k: v.detach() for k, v in tp.items()}
    jp = jax.tree.map(jnp.asarray, p)
    for n, idx in ((2, 4), (2, 8)):
        tc["index"] = torch.tensor(idx, dtype=torch.int32)
        jc["index"] = jnp.int32(idx)
        xs = x[:, :n]
        ps = np.broadcast_to(np.arange(idx, idx + n, dtype=np.int32), (B, n))
        got, tnew = TL.mla_attention(tpd, torch.from_numpy(xs), cfg,
                                     torch.from_numpy(ps), cache=tc)
        want, jc = jax.jit(lambda pp, xx, qq, cc: JL.mla_attention(
            pp, xx, jcfg, qq, cache=cc))(jp, jnp.asarray(xs), jnp.asarray(ps),
                                         jc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **VALUE)
        for k in ("c_kv", "k_rope"):
            np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jc[k]),
                                       **VALUE, err_msg=k)
        assert tnew["c_kv"] is tc["c_kv"]          # written in place
        assert int(tnew["index"]) == int(jc["index"]) == idx + n
