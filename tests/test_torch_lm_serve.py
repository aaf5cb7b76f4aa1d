"""Parity of the port's LM serving path with ``repro.serve.engine`` and
its launchers.

Greedy ``ServeEngine`` generation against the reference's token for token
(the reference's parameters carried across by
``convert.lm_params_from_reference``; the other families' cases are in
``test_torch_models.py``, beside their cached inits), EOS freezing,
``make_prefill_step`` against the decode path, sampling under a seed, the
engine's device rule, and both launch CLIs on the CPU (``--device
cpu``), the serving launcher restoring the training launcher's
checkpoint, and every family through the launchers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
from repro import configs as jconfigs
from repro.serve import engine as jengine

import repro_torch.models as TM
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.serve import ServeEngine, make_prefill_step, make_serve_step

VALUE = dict(rtol=2e-4, atol=2e-5)


def setup(arch="qwen3-4b", seed=0):
    """Reduced configs, the port's model and the reference's numpy
    parameters."""
    cfg = tconfigs.reduce_config(tconfigs.get_config(arch))
    jcfg = jconfigs.reduce_config(jconfigs.get_config(arch))
    ref = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(seed),
                                                  jcfg, jnp.float32))
    return cfg, jcfg, lm_params_from_reference(ref, cfg, device="cpu"), ref


def prompts(cfg, B=3, P=5, seed=0):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=(B, P)).astype(np.int32)


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen1.5-32b", "qwen2-vl-2b"])
def test_greedy_generation_equals_the_reference(arch):
    cfg, jcfg, model, ref = setup(arch)
    p = prompts(cfg)
    out = ServeEngine(cfg, model, max_len=16, device="cpu").generate(
        torch.from_numpy(p), 8)
    want = jengine.ServeEngine(jcfg, jax.tree.map(jnp.asarray, ref),
                               max_len=16).generate(jnp.asarray(p), 8)
    assert out.dtype == torch.int32 and tuple(out.shape) == (3, 13)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_eos_freezes_a_slot():
    cfg, jcfg, model, ref = setup(seed=1)
    p = prompts(cfg, seed=1)
    free = ServeEngine(cfg, model, max_len=16, device="cpu").generate(
        torch.from_numpy(p), 6)
    eos = int(free[0, p.shape[1] + 1])          # slot 0's second new token
    out = ServeEngine(cfg, model, max_len=16, eos_id=eos,
                      device="cpu").generate(torch.from_numpy(p), 6)
    want = jengine.ServeEngine(jcfg, jax.tree.map(jnp.asarray, ref),
                               max_len=16, eos_id=eos).generate(
        jnp.asarray(p), 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    tail = out[0, p.shape[1] + 1:]
    assert (tail == eos).all()
    for b in range(out.shape[0]):
        hit = (out[b, p.shape[1]:] == eos).nonzero()
        if len(hit):
            assert (out[b, p.shape[1] + int(hit[0]):] == eos).all()


def test_prefill_equals_the_decode_path_and_the_reference():
    cfg, jcfg, model, ref = setup(seed=2)
    p = prompts(cfg, seed=2)
    logits = make_prefill_step(cfg)(model, {"tokens": torch.from_numpy(p)})
    jlogits = jengine.make_prefill_step(jcfg)(
        jax.tree.map(jnp.asarray, ref), {"tokens": jnp.asarray(p)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **VALUE)
    cache = TM.init_cache(cfg, p.shape[0], 8, torch.float32, device="cpu")
    for j in range(p.shape[1]):
        step_logits, cache = TM.decode_step(
            model, cfg, torch.from_numpy(p[:, j:j + 1]), cache)
    np.testing.assert_allclose(step_logits[:, -1].numpy(), logits.numpy(),
                               **VALUE)
    # the serve step's greedy token is the argmax of those logits
    cache = TM.init_cache(cfg, p.shape[0], 8, torch.float32, device="cpu")
    for j in range(p.shape[1] - 1):
        _, cache = TM.decode_step(model, cfg,
                                  torch.from_numpy(p[:, j:j + 1]), cache)
    tok, _ = make_serve_step(cfg)(model, cache, torch.from_numpy(p[:, -1:]))
    np.testing.assert_array_equal(tok[:, 0].numpy(),
                                  logits.argmax(-1).numpy())


def test_sampling_is_reproducible_under_a_seed():
    cfg, _, model, _ = setup(seed=3)
    p = torch.from_numpy(prompts(cfg, seed=3))
    runs = [ServeEngine(cfg, model, max_len=16, temperature=0.8, seed=s,
                        device="cpu").generate(p, 8) for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert int(runs[0].max()) < cfg.vocab_size


def test_engine_device_rule():
    cfg, _, model, _ = setup()
    with pytest.raises(ValueError, match="parameters live on"):
        ServeEngine(cfg, model, max_len=8, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(cfg, model, max_len=8)


def test_launch_clis_on_the_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    args = ["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "8", "--log-every", "1"]
    params, m = train_cli.main(args + ["--steps", "3", "--ckpt-dir", ck,
                                       "--ckpt-every", "2"])
    assert np.isfinite(float(m["loss"]))
    # resume from the last save and run on
    train_cli.main(args + ["--steps", "4", "--ckpt-dir", ck, "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    _, m = train_cli.main(args + ["--steps", "2", "--loss", "sig_mmd",
                                  "--sig-channels", "3", "--sig-depth", "2",
                                  "--opt", "adafactor", "--remat", "full"])
    assert np.isfinite(float(m["loss"])) and "sig_mmd" in m
    # a mesh needs a world of its size, which one process is not: a model
    # axis as a data axis
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node=2"):
        train_cli.main(args + ["--mesh", "1x2"])
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node=2"):
        train_cli.main(args + ["--mesh", "2x1"])
    out = serve_cli.main(["--arch", "qwen3-4b", "--reduced", "--device",
                          "cpu", "--batch", "2", "--prompt-len", "3",
                          "--steps", "4", "--ckpt-dir", ck])
    text = capsys.readouterr().out
    assert "restored params from step 4" in text
    assert tuple(out.shape) == (2, 7)
    cfg = dataclasses.replace(tconfigs.reduce_config(
        tconfigs.get_config("qwen3-4b")))
    assert int(out.max()) < cfg.vocab_size


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "phi3.5-moe-42b-a6.6b", "zamba2-7b",
                                  "rwkv6-1.6b", "whisper-large-v3"])
def test_launchers_accept_every_family(arch, capsys):
    out = serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "3", "--steps",
                          "3", "--max-len", "8"])
    cfg = tconfigs.reduce_config(tconfigs.get_config(arch))
    assert tuple(out.shape) == (2, 6) and int(out.max()) < cfg.vocab_size
    assert f"family={cfg.family}" in capsys.readouterr().out
    if cfg.family != "encdec":      # the token stream carries no frames
        _, m = train_cli.main(["--arch", arch, "--reduced", "--device",
                               "cpu", "--batch", "2", "--seq", "8",
                               "--steps", "2"])
        assert np.isfinite(float(m["loss"]))
