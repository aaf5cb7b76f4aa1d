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

    PYTHONPATH=src python tools/rwkv_drift.py --device cpu [--json out]
    PYTHONPATH=src python tools/rwkv_drift.py --device cuda
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
    args = ap.parse_args(argv)
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


if __name__ == "__main__":
    sys.exit(main())
