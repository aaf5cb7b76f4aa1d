"""Layer-by-layer drift of rwkv6-1.6b's float32 prefill and decode paths.

Draws rwkv6-1.6b as published (24 layers, d_model 2048) from a seed,
feeds TokenStream(seed=0) prompts through the layers once as a prefill
(``rwkv_block`` over the whole prompt) and once as decode (``rwkv_block``
token by token with its cache), in float32 and with the weights and
activations in float64 (the block's own float32 casts of the WKV state,
decay and norms kept), and prints after each layer the largest gap of the
last token's hidden state, as a share of its largest magnitude:

- ``pf32``:  float32 prefill against float64 prefill;
- ``dec32``: float32 decode against float64 prefill;
- ``pd32``:  float32 prefill against float32 decode;
- ``pd64``:  float64 prefill against float64 decode;

and, at the end, the same for the logits (max|err| over max|logit|).  A
layer at a time is kept in float64, so the float32 model is the largest
thing held.  Each layer's value equals what the model's prefill and
decode_step compute, since a layer's output at token t reads only its
input at tokens <= t.

``--grads`` (CPU; needs the JAX reference package ``repro`` and ``jax``)
puts the port's and the reference's training side by side instead, on
the reduced rwkv6 of ``tests/_torch_mp_ranks.py`` with its inputs: the
first step's gradients, each leaf's max |err| over its max |g|, and the
embedding after three SGD steps at lr 1e-3 (its max |err| against the
band rtol 1e-3 / atol 1e-5, as a multiple of the band), for

- ``port32_ref32``: the port in float32 against the reference in float32;
- ``ref32_ref64``: the reference in float32 against itself in float64;
- ``port32_port64``: the port in float32 against itself in float64;
- ``port64_ref64``: the two in float64.

    PYTHONPATH=src python tools/rwkv_drift.py --device cpu [--json out]
    PYTHONPATH=src python tools/rwkv_drift.py --device cuda
    PYTHONPATH=src:tests python tools/rwkv_drift.py --grads [--json out]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from repro_torch import models as LM
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenStream
from repro_torch.models.layers import rms_norm
from repro_torch.models.ssm import rwkv_block, rwkv_cache
from repro_torch.models.transformer import logits_fn


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def decode(p, x: torch.Tensor, cfg, dtype) -> torch.Tensor:
    cache = rwkv_cache(cfg, x.shape[0], dtype, device=x.device)
    out = []
    for t in range(x.shape[1]):
        y, cache = rwkv_block(p, x[:, t:t + 1], cfg, cache=cache)
        out.append(y)
    return torch.cat(out, dim=1)


@torch.no_grad()
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth (0: as published)")
    ap.add_argument("--json", help="also write the rows here")
    ap.add_argument("--grads", action="store_true",
                    help="the port's and the reference's training instead")
    args = ap.parse_args(argv)
    if args.grads:
        return grads_main(args)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("rwkv6-1.6b")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = LM.init_params(args.seed, cfg, device=args.device)
    tokens = next(TokenStream(cfg.vocab_size, args.batch, args.prompt,
                              seed=0, device=args.device))["tokens"]
    emb = params["embed"][tokens.long()]
    h = {"pf32": emb, "dec32": emb, "pf64": emb.double(),
         "dec64": emb.double()}
    rows = []
    for i, p in enumerate(params["layers"]):
        p64 = {k: p[k].double() for k in p.keys()}
        h["pf32"] = rwkv_block(p, h["pf32"], cfg)[0]
        h["dec32"] = decode(p, h["dec32"], cfg, torch.float32)
        h["pf64"] = rwkv_block(p64, h["pf64"], cfg)[0]
        h["dec64"] = decode(p64, h["dec64"], cfg, torch.float64)
        last = {k: v[:, -1] for k, v in h.items()}
        row = dict(layer=i + 1, pf32=rel(last["pf32"], last["pf64"]),
                   dec32=rel(last["dec32"], last["pf64"]),
                   pd32=rel(last["pf32"], last["dec32"]),
                   pd64=rel(last["pf64"], last["dec64"]),
                   max_abs=float(last["pf64"].abs().max()))
        rows.append(row)
        print(json.dumps(row), flush=True)
        del p64
    logits = {}
    for k, v in h.items():
        x = rms_norm(v[:, -1], params["ln_f"], cfg.norm_eps)
        logits[k] = logits_fn(params, cfg, x)
    out = dict(rows=rows, logits=dict(
        pf32=rel(logits["pf32"], logits["pf64"]),
        dec32=rel(logits["dec32"], logits["pf64"]),
        pd32=rel(logits["pf32"], logits["dec32"]),
        pd64=rel(logits["pf64"], logits["dec64"]),
        max_logit=float(logits["pf64"].abs().max())),
        device=args.device, batch=args.batch, prompt=args.prompt,
        layers=cfg.n_layers, d_model=cfg.d_model)
    print(json.dumps(out["logits"]), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


def _band(a, b, rtol=1e-3, atol=1e-5) -> float:
    """max |a − b| / (atol + rtol·|b|): above 1 is outside the band."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


def grads_main(args) -> int:
    """The port against the reference on reduced rwkv6: first-step
    gradients and three SGD steps, float32 and float64."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import _torch_mp_ranks as R
    import repro.models as JM
    from repro import configs as jconfigs
    from repro import optim as joptim
    from repro import train as jtrain
    from repro.data import pipeline as jpipe
    from repro_torch import configs, optim, train
    from repro_torch.convert import _per_layer, lm_params_from_reference
    arch = "rwkv6-1.6b"
    jcfg, cfg = R.config(arch, jconfigs), R.config(arch, configs)
    B, S, steps = R.TRAIN
    i = R.ARCHS.index(arch)
    ref_params = jax.tree.map(np.asarray, JM.init_params(
        jax.random.PRNGKey(i), jcfg, jnp.float32))
    stream = jpipe.TokenStream(jcfg.vocab_size, B, S, i)
    batches = [jax.tree.map(np.asarray, next(stream)) for _ in range(steps)]
    lr = 1e-3

    def reference(x64: bool):
        with jax.enable_x64(x64):
            dt = jnp.float64 if x64 else jnp.float32
            p = jax.tree.map(lambda a: jnp.asarray(a, dt), ref_params)
            b0 = jax.tree.map(jnp.asarray, batches[0])
            g = jax.grad(lambda q: JM.loss_fn(q, jcfg, b0, "dots")[0])(p)
            opt = joptim.sgd(lr=lr)
            step = jax.jit(jtrain.make_train_step(jcfg, opt))
            state = opt.init(p)
            for b in batches:
                p, state, _ = step(p, state, jax.tree.map(jnp.asarray, b))
            return ({k: torch.from_numpy(np.asarray(v, np.float64))
                     for k, v in _per_layer(jax.tree.map(np.asarray, g))
                     .items()},
                    torch.from_numpy(np.asarray(p["embed"], np.float64)))

    @torch.enable_grad()
    def port(dtype):
        model = lm_params_from_reference(ref_params, cfg, device="cpu").to(
            dtype)
        t = [{k: torch.from_numpy(np.array(v)) for k, v in b.items()}
             for b in batches]
        names = [k for k, _ in model.named_parameters()]
        loss, _ = train.trainer.M.loss_fn(model, cfg, t[0], remat="dots")
        g = torch.autograd.grad(loss, list(model.parameters()))
        grads = {k: v.detach().double() for k, v in zip(names, g)}
        opt = optim.sgd(lr=lr)
        state = opt.init(model)
        step = train.make_train_step(cfg, opt)
        for b in t:
            model, state, _ = step(model, state, b)
        return grads, model.embed.detach().double()

    runs = {"ref32": reference(False), "ref64": reference(True),
            "port32": port(torch.float32), "port64": port(torch.float64)}
    out = {}
    for name, (a, b) in (("port32_ref32", ("port32", "ref32")),
                         ("ref32_ref64", ("ref32", "ref64")),
                         ("port32_port64", ("port32", "port64")),
                         ("port64_ref64", ("port64", "ref64"))):
        ga, gb = runs[a][0], runs[b][0]
        worst = max(ga, key=lambda k: rel(ga[k], gb[k]))
        out[name] = dict(grad_rel_max=rel(ga[worst], gb[worst]),
                         grad_leaf=worst,
                         grad_norm=float(torch.sqrt(sum(
                             (v ** 2).sum() for v in gb.values()))),
                         embed_band=_band(runs[a][1], runs[b][1]),
                         embed_max_abs_err=float(
                             (runs[a][1] - runs[b][1]).abs().max()))
        print(name, json.dumps(out[name]), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
