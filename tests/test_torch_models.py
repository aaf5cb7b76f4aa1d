"""Parity of the port's decoder LM families with the reference.

``repro_torch.configs`` / ``models.config`` against ``repro.configs`` /
``repro.models.config`` field by field; the dense layers (``rms_norm``,
RoPE, M-RoPE, attention with and without a cache, the MLPs); the
parameter tree of every config's init; and, for the five dense-decoder
configs and the MoE/MLA, hybrid and RWKV6 configs reduced, the backbone's
hidden states, the LM loss and aux loss and every gradient, decode
logits and caches step by step, and, for the four, greedy generation by
``ServeEngine`` against the reference's token for token.  zamba2 also
runs at 8 layers (4 groups over 2 shared blocks) with the cache as long
as the tokens fed, so the reference's discarded group writes and the
clamped write are exercised.
The reference's parameters are drawn by JAX, perturbed so no norm weight
or bias is zero, and carried across by
``convert.lm_params_from_reference``.  Tolerances are the repo's: values
rtol 2e-4, atol 2e-5; gradients rtol 1e-3, atol 1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import engine as jengine

import repro_torch.models as TM
from repro_torch import configs as tconfigs
from repro_torch.convert import _per_layer, lm_params_from_reference
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve import ServeEngine

VALUE = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
DENSE = ["command-r-35b", "llama3-405b", "qwen1.5-32b", "qwen3-4b",
         "qwen2-vl-2b"]
FAMILIES = ["deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b", "zamba2-7b",
            "rwkv6-1.6b"]
DECODERS = DENSE + FAMILIES
# zamba2 at 8 layers: 4 groups over its 2 shared attention blocks
ZAMBA8 = "zamba2-7b@8"


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def perturbed(tree, seed=0, scale=0.1):
    """The reference's tree as numpy with noise added to every leaf, so
    zero-initialised norm weights and biases are exercised."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + scale * rng.normal(
        size=x.shape)).astype(np.float32), tree)


def reduced(arch):
    """(port cfg, ref cfg) reduced; ``"<arch>@<n>"`` with n layers."""
    arch, _, layers = arch.partition("@")
    cfgs = (tconfigs.reduce_config(tconfigs.get_config(arch)),
            jconfigs.reduce_config(jconfigs.get_config(arch)))
    if layers:
        cfgs = tuple(dataclasses.replace(c, n_layers=int(layers))
                     for c in cfgs)
    return cfgs


@functools.lru_cache(maxsize=None)
def ref_init(arch, seed=0):
    """The reference's init of a reduced config from ``PRNGKey(seed)``
    (jitted: its eager init takes seconds for the MoE and hybrid trees),
    as numpy."""
    _, jcfg = reduced(arch)
    return jax.tree.map(np.asarray, jax.jit(
        JM.init_params, static_argnums=(1, 2))(jax.random.PRNGKey(seed),
                                               jcfg, jnp.float32))


def models(arch, seed=0):
    """(port cfg, ref cfg, port model, ref numpy params) at reduced size."""
    cfg, jcfg = reduced(arch)
    ref = perturbed(ref_init(arch, seed), seed)
    return cfg, jcfg, lm_params_from_reference(ref, cfg, device="cpu"), ref


def batch(cfg, seed=0, B=2, S=8):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels[0, :2] = -100
    labels[1, -1] = -1
    return tokens, labels


def assert_fields_equal(a, b):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert list(da) == list(db)
    for k in da:
        assert da[k] == db[k], k


# ---------------------------------------------------------------- configs

def test_arch_ids_equal_the_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_config_reduction_and_param_count_equal_the_reference(arch):
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    for a, b in ((cfg, jcfg), reduced(arch),
                 (tconfigs.with_sig_head(cfg, channels=4, depth=2,
                                         kernel_landmarks=3),
                  jconfigs.with_sig_head(jcfg, channels=4, depth=2,
                                         kernel_landmarks=3))):
        assert_fields_equal(a, b)
        assert a.param_count() == b.param_count()
        assert a.active_param_count() == b.active_param_count()
        assert a.resolved_head_dim == b.resolved_head_dim


def test_unknown_arch_raises_as_the_reference():
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-2")


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_init_params_tree_equals_the_reference(arch):
    cfg, jcfg = reduced(arch)
    model = TM.init_params(0, cfg, device="cpu")
    want = _per_layer(ref_init(arch))
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape, k
        # constant-initialised leaves (norms, biases, decays) are equal
        if want[k].size > 1 and np.all(want[k] == want[k].flat[0]):
            assert torch.all(t == float(want[k].flat[0])), k
    assert sum(t.numel() for t in got.values()) == sum(
        w.size for w in want.values())


# ---------------------------------------------------------------- layers

def test_rms_norm_scales_by_one_plus_weight(rng):
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm(_t(x), _t(w), 1e-6).numpy(),
        _np(JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)), **VALUE)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_half_split(rng, theta):
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        TL.apply_rope(_t(x), _t(pos), theta).numpy(),
        _np(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)), **VALUE)


def test_apply_mrope_sections(rng):
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 50, size=(3, 2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        TL.apply_mrope(_t(x), _t(pos), 1e6, (2, 3, 3)).numpy(),
        _np(JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                           (2, 3, 3))), **VALUE)
    with pytest.raises(ValueError, match="sum to"):
        TL.apply_mrope(_t(x), _t(pos), 1e6, (2, 3, 4))


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_mlp_activations(rng, act):
    p = perturbed(JL.init_mlp(jax.random.PRNGKey(1), 16, 24, act))
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    got = TL.mlp({k: _t(v) for k, v in p.items()}, _t(x), act)
    want = JL.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), act)
    np.testing.assert_allclose(got.numpy(), _np(want), **VALUE)
    assert ("w_gate" in p) == (act != "relu")


@pytest.mark.parametrize("arch", DENSE)
def test_attention_without_and_with_a_cache(rng, arch):
    cfg, jcfg = reduced(arch)
    p = perturbed(JL.init_attention(jax.random.PRNGKey(2), jcfg))
    tp = {k: _t(v) for k, v in p.items()}
    jp = jax.tree.map(jnp.asarray, p)
    B, S, T = 2, 5, 9
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    if cfg.rope_type == "mrope":
        pos = np.broadcast_to(pos, (3, B, S))
    got, none = TL.attention(tp, _t(x), cfg, _t(pos))
    want, _ = JL.attention(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    assert none is None
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **VALUE)
    # one decode token against a cache filled to index 4
    hd = cfg.resolved_head_dim
    ck = rng.normal(size=(B, T, cfg.n_kv_heads, hd)).astype(np.float32)
    cv = rng.normal(size=(B, T, cfg.n_kv_heads, hd)).astype(np.float32)
    x1 = x[:, :1]
    pos1 = np.full(pos.shape[:-1] + (1,), 4, np.int32)
    tc = {"k": _t(ck), "v": _t(cv), "index": torch.tensor(4, dtype=torch.int32)}
    got, tnew = TL.attention(tp, _t(x1), cfg, _t(pos1), cache=tc)
    want, jnew = JL.attention(jp, jnp.asarray(x1), jcfg, jnp.asarray(pos1),
                              cache={"k": jnp.asarray(ck),
                                     "v": jnp.asarray(cv),
                                     "index": jnp.int32(4)})
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **VALUE)
    for k in ("k", "v"):
        np.testing.assert_allclose(tnew[k].detach().numpy(), _np(jnew[k]),
                                   **VALUE)
    assert int(tnew["index"]) == int(jnew["index"]) == 5


def test_causal_sdpa_grouped_query_heads(rng):
    # query head h reads kv head h // group
    q = rng.normal(size=(2, 6, 8, 4)).astype(np.float32)
    k = rng.normal(size=(2, 6, 2, 4)).astype(np.float32)
    v = rng.normal(size=(2, 6, 2, 4)).astype(np.float32)
    got = TL._sdpa(_t(q), _t(k), _t(v), causal=True)
    want = JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)
    np.testing.assert_allclose(got.numpy(), _np(want), **VALUE)


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("arch", DECODERS)
def test_backbone_loss_and_gradients(arch):
    cfg, jcfg, model, ref = models(arch)
    tokens, labels = batch(cfg)
    hidden, aux = TT.backbone(model, cfg, tokens=_t(tokens))
    jhidden, jaux = JT.backbone(ref, jcfg, tokens=jnp.asarray(tokens))
    np.testing.assert_allclose(hidden.detach().numpy(), _np(jhidden),
                               **VALUE)
    np.testing.assert_allclose(float(aux), float(jaux), **VALUE)
    assert (float(aux) > 0) == cfg.moe
    tb = {"tokens": _t(tokens), "labels": _t(labels)}
    loss, metrics = TM.loss_fn(model, cfg, tb)
    names, tensors = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, tensors)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, jb), has_aux=True))(ref)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **VALUE)
    for k in ("loss", "aux", "ntok"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   **VALUE)
    want = _per_layer(jax.tree.map(np.asarray, jgrads))
    assert sorted(want) == sorted(names)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name], **GRAD,
                                   err_msg=name)


def assert_caches_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        if isinstance(v, dict):
            assert_caches_equal(v, want[k])
        else:
            np.testing.assert_allclose(v.numpy(), _np(want[k]), **VALUE,
                                       err_msg=k)


@pytest.mark.parametrize("arch", DECODERS + [ZAMBA8])
def test_decode_logits_and_prefill_equal_decode(arch):
    cfg, jcfg, model, ref = models(arch, seed=1)
    tokens, _ = batch(cfg, seed=1, S=6)
    # the cache is as long as the tokens fed: the 8-layer hybrid's later
    # groups write past the end at the last step and are clamped
    max_len = 6 if arch == ZAMBA8 else 10
    cache = TM.init_cache(cfg, 2, max_len, torch.float32, device="cpu")
    jcache = JM.init_cache(jcfg, 2, max_len, jnp.float32)
    jstep = jax.jit(lambda p, t, c: JM.decode_step(p, jcfg, t, c))
    for j in range(tokens.shape[1]):
        logits, cache = TM.decode_step(model, cfg, _t(tokens[:, j:j + 1]),
                                       cache)
        jlogits, jcache = jstep(ref, jnp.asarray(tokens[:, j:j + 1]), jcache)
        np.testing.assert_allclose(logits.numpy(), _np(jlogits), **VALUE)
    assert_caches_equal(cache, jcache)
    full = model(_t(tokens))
    if arch == ZAMBA8:
        # the reference's decode is not its prefill with 4 groups over 2
        # blocks; the port reproduces the decode
        assert float((logits[:, 0] - full[:, -1].detach()).abs().max()) > 1e-3
    else:
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   full[:, -1].detach().numpy(), **VALUE)


@pytest.mark.parametrize("arch", FAMILIES[:2] + ["rwkv6-1.6b", ZAMBA8])
def test_greedy_generation_equals_the_reference(arch):
    """The port's ServeEngine against the reference's, token for token;
    zamba2 at 8 layers with a cache as long as the prompt and the new
    tokens."""
    cfg, jcfg, model, ref = models(arch)
    p, _ = batch(cfg, S=3)
    max_len = 3 + 8 if arch == ZAMBA8 else 16
    out = ServeEngine(cfg, model, max_len=max_len, device="cpu").generate(
        torch.from_numpy(p), 8)
    want = jengine.ServeEngine(jcfg, jax.tree.map(jnp.asarray, ref),
                               max_len=max_len).generate(jnp.asarray(p), 8)
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, 11)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_remat_modes_give_equal_losses_and_gradients():
    cfg, _, model, _ = models("qwen3-4b", seed=2)
    tokens, labels = batch(cfg, seed=2)
    tb = {"tokens": _t(tokens), "labels": _t(labels)}
    out = {}
    for mode in ("none", "full", "dots"):
        loss, _ = TM.loss_fn(model, cfg, tb, remat=mode)
        out[mode] = (loss, torch.autograd.grad(loss, list(model.parameters())))
    for mode in ("full", "dots"):
        np.testing.assert_allclose(float(out[mode][0]), float(out["none"][0]),
                                   rtol=1e-6)
        for g, g0 in zip(out[mode][1], out["none"][1]):
            np.testing.assert_allclose(g.numpy(), g0.numpy(), **GRAD)
    with pytest.raises(ValueError):
        TM.loss_fn(model, cfg, tb, remat="everything")


def test_init_params_shapes_scales_and_device_rule():
    cfg, jcfg = reduced("qwen1.5-32b")
    model = TM.init_params(0, cfg, device="cpu")
    ref = JM.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    want = _per_layer(jax.tree.map(np.asarray, ref))
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape, k
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        # zero-initialised leaves stay zero; weights have the same scale
        if not want[k].any():
            assert not t.detach().any(), k
        else:
            np.testing.assert_allclose(t.detach().std(), want[k].std(),
                                       rtol=0.3, err_msg=k)
    again = TM.init_params(0, cfg, device="cpu")
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.init_params(0, cfg)
