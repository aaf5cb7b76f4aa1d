"""Parity of the port's encoder-decoder (whisper) with
``repro.models.encdec`` and its serving path.

On whisper-large-v3 reduced, the reference's parameters perturbed and
carried across by ``convert.lm_params_from_reference``: ``sinusoids``;
``encode``, ``decode_train`` and ``lm_loss`` values and every gradient;
``prefill_cross`` and ``decode_step`` step by step (logits and caches),
decode against ``decode_train``, and positions past ``decoder_max_len``
(the reference clamps the position row and the cache write); the
``make_prefill_step`` branch; ``ServeEngine`` (zero cross K/V, as the
reference's) token for token; one train step.  Values rtol 2e-4, atol
2e-5; gradients rtol 1e-3, atol 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
from repro import configs as jconfigs
from repro.models import encdec as JE
from repro.serve import engine as jengine

import repro_torch.models as TM
from repro_torch import configs as tconfigs
from repro_torch.convert import _per_layer, lm_params_from_reference
from repro_torch.models import encdec as TE
from repro_torch.optim import adamw
from repro_torch.serve import ServeEngine, make_prefill_step
from repro_torch.train import make_train_step

VALUE = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
ARCH = "whisper-large-v3"


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def ref_init():
    jcfg = jconfigs.reduce_config(jconfigs.get_config(ARCH))
    return jax.tree.map(np.asarray, jax.jit(
        JM.init_params, static_argnums=(1, 2))(jax.random.PRNGKey(0), jcfg,
                                               jnp.float32))


def setup(seed=0, scale=0.1):
    cfg = tconfigs.reduce_config(tconfigs.get_config(ARCH))
    jcfg = jconfigs.reduce_config(jconfigs.get_config(ARCH))
    rng = np.random.default_rng(seed)
    ref = jax.tree.map(lambda x: (x + scale * rng.normal(size=x.shape))
                       .astype(np.float32), ref_init())
    return cfg, jcfg, lm_params_from_reference(ref, cfg, device="cpu"), ref


def data(cfg, seed=0, B=2, F=8, S=6):
    rng = np.random.default_rng(seed)
    frames = (0.5 * rng.normal(size=(B, F, cfg.d_model))).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels[0, :2] = -100
    return frames, tokens, labels


def test_sinusoids_equal_the_reference():
    for length, ch in ((16, 64), (1500, 1280), (3, 4)):
        np.testing.assert_array_equal(TE.sinusoids(length, ch),
                                      JE.sinusoids(length, ch))


def test_model_tree_and_forward():
    cfg, jcfg, model, ref = setup()
    assert isinstance(model, TE.EncDecLM)
    assert sorted(dict(model.named_parameters())) == sorted(_per_layer(ref))
    assert len(model["enc_layers"]) == cfg.n_encoder_layers
    assert len(model["dec_layers"]) == cfg.n_layers
    frames, tokens, _ = data(cfg)
    logits = model(_t(frames), _t(tokens))
    enc = JE.encode(ref, jcfg, jnp.asarray(frames))
    hid = JE.decode_train(ref, jcfg, enc, jnp.asarray(tokens))
    want = jnp.einsum("bsd,vd->bsv", hid, ref["embed"])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               **VALUE)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_encode_decode_train_loss_and_gradients(remat):
    cfg, jcfg, model, ref = setup(seed=1)
    frames, tokens, labels = data(cfg, seed=1)
    enc = TE.encode(model, cfg, _t(frames), remat=remat)
    jenc = JE.encode(ref, jcfg, jnp.asarray(frames))
    np.testing.assert_allclose(enc.detach().numpy(), np.asarray(jenc),
                               **VALUE)
    hid = TE.decode_train(model, cfg, enc, _t(tokens), remat=remat)
    jhid = JE.decode_train(ref, jcfg, jenc, jnp.asarray(tokens))
    np.testing.assert_allclose(hid.detach().numpy(), np.asarray(jhid),
                               **VALUE)
    tb = {"frames": _t(frames), "tokens": _t(tokens), "labels": _t(labels)}
    loss, metrics = TM.loss_fn(model, cfg, tb, remat=remat)
    assert sorted(metrics) == ["loss", "ntok"]
    names, tensors = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, tensors)
    jb = {k: jnp.asarray(v) for k, v in
          (("frames", frames), ("tokens", tokens), ("labels", labels))}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, jb), has_aux=True))(ref)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **VALUE)
    np.testing.assert_allclose(float(metrics["ntok"]), float(jm["ntok"]))
    want = _per_layer(jax.tree.map(np.asarray, jgrads))
    assert sorted(want) == sorted(names)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name], **GRAD,
                                   err_msg=name)


def test_prefill_cross_and_decode_steps():
    cfg, jcfg, model, ref = setup(seed=2)
    frames, tokens, _ = data(cfg, seed=2)
    B, F = frames.shape[:2]
    S = tokens.shape[1]
    enc = TE.encode(model, cfg, _t(frames), remat="none")
    jenc = JE.encode(ref, jcfg, jnp.asarray(frames), remat="none")
    cache = TE.prefill_cross(model, cfg, enc, TM.init_cache(
        cfg, B, F, torch.float32, device="cpu"))
    jcache = JE.prefill_cross(ref, jcfg, jenc,
                              JM.init_cache(jcfg, B, F, jnp.float32))
    for k in ("cross_k", "cross_v"):
        np.testing.assert_allclose(cache[k].detach().numpy(),
                                   np.asarray(jcache[k]), **VALUE)
    jstep = jax.jit(lambda p, t, c: JM.decode_step(p, jcfg, t, c))
    dec = []
    for j in range(S):
        logits, cache = TM.decode_step(model, cfg, _t(tokens[:, j:j + 1]),
                                       cache)
        jlogits, jcache = jstep(ref, jnp.asarray(tokens[:, j:j + 1]), jcache)
        assert logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **VALUE)
        dec.append(logits)
    for k in ("self_k", "self_v", "index"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   **VALUE, err_msg=k)
    # decode equals the teacher-forced decoder
    full = model(_t(frames), _t(tokens)).detach()
    np.testing.assert_allclose(torch.cat(dec, 1).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4 * float(full.abs().max()))


def test_positions_past_the_decoder_length_are_clamped():
    """The reference reads pos_dec[min(index, L - 1)] and writes the self
    cache at min(index, L - 1) once the index passes decoder_max_len."""
    cfg, jcfg, model, ref = setup(seed=3)
    frames, tokens, _ = data(cfg, seed=3, S=4)
    L = cfg.decoder_max_len
    enc = TE.encode(model, cfg, _t(frames), remat="none")
    jenc = JE.encode(ref, jcfg, jnp.asarray(frames), remat="none")
    rng = np.random.default_rng(4)
    self_kv = {k: (0.3 * rng.normal(size=(cfg.n_layers, 2, L,
                                          cfg.n_kv_heads,
                                          cfg.resolved_head_dim)))
               .astype(np.float32) for k in ("self_k", "self_v")}
    start = np.full((cfg.n_layers,), L - 2, np.int32)
    cache = TE.prefill_cross(model, cfg, enc, dict(
        TM.init_cache(cfg, 2, frames.shape[1], torch.float32, device="cpu"),
        index=_t(start), **{k: _t(v) for k, v in self_kv.items()}))
    jcache = JE.prefill_cross(ref, jcfg, jenc, dict(
        JM.init_cache(jcfg, 2, frames.shape[1], jnp.float32),
        index=jnp.asarray(start),
        **{k: jnp.asarray(v) for k, v in self_kv.items()}))
    for j in range(4):                     # indices L-2, L-1, L, L+1
        logits, cache = TM.decode_step(model, cfg, _t(tokens[:, j:j + 1]),
                                       cache)
        jlogits, jcache = JM.decode_step(ref, jcfg,
                                         jnp.asarray(tokens[:, j:j + 1]),
                                         jcache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **VALUE)
    assert int(cache["index"][0]) == L + 2
    for k in ("self_k", "self_v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   **VALUE, err_msg=k)


def test_prefill_step_equals_the_reference():
    cfg, jcfg, model, ref = setup(seed=5)
    frames, tokens, _ = data(cfg, seed=5)
    got = make_prefill_step(cfg)(model, {"frames": _t(frames),
                                         "tokens": _t(tokens)})
    want = jengine.make_prefill_step(jcfg)(
        jax.tree.map(jnp.asarray, ref),
        {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)})
    assert got.dtype == torch.float32 and tuple(got.shape) == (2,
                                                               cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VALUE)


def test_serve_engine_greedy_equals_the_reference():
    cfg, jcfg, model, ref = setup(seed=6, scale=0.3)
    p = np.random.default_rng(6).integers(1, cfg.vocab_size,
                                          size=(3, 4)).astype(np.int32)
    out = ServeEngine(cfg, model, max_len=16, device="cpu").generate(
        _t(p), 6)
    want = jengine.ServeEngine(jcfg, jax.tree.map(jnp.asarray, ref),
                               max_len=16).generate(jnp.asarray(p), 6)
    assert tuple(out.shape) == (3, 10)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_train_step_on_frames():
    cfg, _, model, _ = setup(seed=7)
    frames, tokens, labels = data(cfg, seed=7)
    batch = {"frames": _t(frames), "tokens": _t(tokens), "labels": _t(labels)}
    opt = adamw(lr=1e-3)
    state = opt.init(model)
    before = model["dec_layers"][0]["mlp"]["w_up"].detach().clone()
    model, state, m = make_train_step(cfg, opt)(model, state, batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert not torch.equal(before, model["dec_layers"][0]["mlp"]["w_up"])
