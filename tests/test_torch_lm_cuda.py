"""Card-only tests of the LM substrate, the signature heads and the
trainer (marker ``cuda``): the entry points default to the card, and the
heads and the sig-MMD step launch the hand-written kernels and agree with
the torch engine on the same card tensors.  They skip without a card; on
the chip machine run them with ``pytest --noconftest`` (no JAX there).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.models as TM
from repro_torch.configs import get_config, reduce_config, with_sig_head
from repro_torch.data import TokenStream
from repro_torch.kernels import sig_gram as sg
from repro_torch.kernels import sig_sweep as ss
from repro_torch.kernels import sig_trunc as st
from repro_torch.kernels import sig_words as sw
from repro_torch.models.sig_head import (init_sig_head, sig_pool,
                                         sig_stream_features)
from repro_torch.core.words import make_plan
from repro_torch.optim import adamw
from repro_torch.serve import ServeEngine, make_prefill_step
from repro_torch.train import make_train_step

GRAD = dict(rtol=1e-3, atol=1e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")


def counts():
    return dict(trunc=st.launches, stream=st.stream_launches,
                words=sw.launches, gram=sg.launches, sweep=ss.launches)


def cfg_with_head(**kw):
    return with_sig_head(reduce_config(get_config("qwen3-4b")), channels=3,
                         depth=3, **kw)


@pytest.mark.cuda
def test_model_and_engine_default_to_the_card(card):
    cfg = reduce_config(get_config("qwen3-4b"))
    model = TM.init_params(0, cfg)
    assert all(p.is_cuda for p in model.parameters())
    tokens = next(TokenStream(cfg.vocab_size, 3, 7))["tokens"]
    assert tokens.is_cuda
    logits = make_prefill_step(cfg)(model, {"tokens": tokens})
    cache = TM.init_cache(cfg, 3, 12, torch.float32)
    for j in range(tokens.shape[1]):
        step, cache = TM.decode_step(model, cfg, tokens[:, j:j + 1], cache)
    torch.testing.assert_close(step[:, -1], logits, rtol=2e-4, atol=2e-5)
    out = ServeEngine(cfg, model, max_len=12).generate(tokens, 5)
    assert out.is_cuda and tuple(out.shape) == (3, 12)


@pytest.mark.cuda
def test_sig_mmd_step_launches_the_kernels(card):
    cfg = cfg_with_head()
    model = TM.init_params(0, cfg)
    model["sig_head"] = init_sig_head(1, cfg, 4)
    batch = next(TokenStream(cfg.vocab_size, 4, 16))
    batch["paths"] = torch.randn(4, 16, 3, device="cuda") * 0.2
    before = counts()
    _, _, m = make_train_step(cfg, adamw(), loss="sig_mmd")(
        model, adamw().init(model), batch)
    after = counts()
    assert {k: after[k] - before[k] for k in after} == dict(
        trunc=2, stream=0, words=0, gram=3, sweep=1)
    assert np.isfinite(float(m["loss"]))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["truncated", "projected", "kernel",
                                   "stream"])
def test_heads_on_the_kernels_equal_the_torch_engine(card, route):
    kw = dict(kernel_landmarks=3) if route == "kernel" else \
        dict(stream_stride=3) if route == "stream" else {}
    cfg = cfg_with_head(**kw)
    plan = make_plan([(0,), (1, 2), (2, 0, 1)], 3) \
        if route == "projected" else None
    p = {k: v.detach() for k, v in
         init_sig_head(2, cfg, 4).named_parameters()}
    if plan is not None:
        p["out"] = torch.randn(6, 4, device="cuda")
    hidden = torch.randn(3, 20, cfg.d_model, device="cuda")
    outs = {}
    for backend in ("cuda", "torch"):
        c = dataclasses.replace(cfg, sig_head=dataclasses.replace(
            cfg.sig_head, backend=backend))
        x = hidden.clone().requires_grad_()
        fn = sig_stream_features if route == "stream" else sig_pool
        out = fn(p, x, c, plan=plan) if plan is not None else fn(p, x, c)
        outs[backend] = (out, torch.autograd.grad(out.sum(), x)[0])
    torch.testing.assert_close(outs["cuda"][0], outs["torch"][0],
                               rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(outs["cuda"][1], outs["torch"][1], **GRAD)
