"""Which float32 GEMMs make rwkv6-1.6b's prefill drift from float64.

Runs rwkv6-1.6b as published (24 layers, d_model 2048, drawn from seed 0)
over TokenStream(seed=0) prompts (4 x 64 tokens) as a prefill, with the
weights and activations in float64 as the yardstick, and in float32 with
the block's matrix products taken in one of these ways:

- ``base``:  as the port's ``rwkv_block`` takes them (one GEMM over all
  B*S rows);
- ``all64``: every product in float64, cast back to float32;
- ``tm64``:  the time mix's products (r, k, v, g, the decay's LoRA, w_o)
  in float64;
- ``cm64``:  the channel mix's products (w_ck, w_cv, w_cr) in float64;
- ``rows4``: every product over row chunks of 4 (the rows a decode step
  of 4 requests feeds);

and prints the last token's largest logit gap to the float64 run over its
largest logit.  The block is written out here with its products as a
parameter; it is ``repro_torch.models.ssm.rwkv_block`` without a cache.

    PYTHONPATH=src python tools/rwkv_gemm_variants.py --device cuda
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch
import torch.nn.functional as F

from repro_torch import models as LM
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenStream
from repro_torch.models import ssm
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import logits_fn

KINDS = ("base", "all64", "tm64", "cm64", "rows4")


def product(kind: str):
    def mm(a: torch.Tensor, w: torch.Tensor, part: str) -> torch.Tensor:
        if kind in ("all64", part + "64"):
            return (a.double() @ w.double()).to(a.dtype)
        if kind == "rows4":
            rows = a.reshape(-1, a.shape[-1])
            return torch.cat([c @ w for c in rows.split(4)]).reshape(
                *a.shape[:-1], w.shape[-1])
        return a @ w
    return mm


def block(p: dict, x_in: torch.Tensor, cfg, mm) -> torch.Tensor:
    B, S, d = x_in.shape
    hk = cfg.rwkv_head_dim
    nh = d // hk
    x = rms_norm(x_in, p["ln1"], cfg.norm_eps)
    xs = ssm._token_shift(x, x.new_zeros((B, d)))

    def lerp(mu):
        return x + (xs - x) * mu[None, None]

    r = mm(lerp(p["mu_r"]), p["w_r"], "tm")
    k = mm(lerp(p["mu_k"]), p["w_k"], "tm")
    v = mm(lerp(p["mu_v"]), p["w_v"], "tm")
    g = mm(lerp(p["mu_g"]), p["w_g"], "tm")
    wl = mm(torch.tanh(mm(lerp(p["mu_w"]), p["w_lora_a"], "tm")),
            p["w_lora_b"], "tm")
    w = torch.exp(-torch.exp((p["w0"][None, None] + wl).float()))
    state = torch.zeros((B, nh, hk, hk), dtype=torch.float32,
                        device=x.device)
    y, _ = ssm._wkv_scan(*(t.reshape(B, S, nh, hk) for t in (r, k, v, w)),
                         p["u"], state)
    yh = y.reshape(B, S, d).to(x.dtype).reshape(B, S, nh, hk).float()
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, unbiased=False, keepdim=True)
    yh = (yh - mu) * torch.rsqrt(var + 64e-5)
    y = (yh.reshape(B, S, d) * (1.0 + p["ln_x"][None, None])).to(x.dtype)
    res = x_in + mm(y * F.silu(g), p["w_o"], "tm")
    x2 = rms_norm(res, p["ln2"], cfg.norm_eps)
    xs2 = ssm._token_shift(x2, x2.new_zeros((B, d)))

    def lerp2(mu):
        return x2 + (xs2 - x2) * mu[None, None]

    cv = mm(torch.square(F.relu(mm(lerp2(p["mu_ck"]), p["w_ck"], "cm"))),
            p["w_cv"], "cm")
    cr = torch.sigmoid(mm(lerp2(p["mu_cr"]), p["w_cr"], "cm"))
    return res + cr * cv


@torch.no_grad()
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth (0: as published)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("rwkv6-1.6b")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = LM.init_params(0, cfg, device=args.device)
    tokens = next(TokenStream(cfg.vocab_size, 4, 64, seed=0,
                              device=args.device))["tokens"]
    emb = params["embed"][tokens.long()]

    def run(kind: str, dtype) -> torch.Tensor:
        h = emb.to(dtype)
        for p in params["layers"]:
            h = block({k: p[k].to(dtype) for k in p.keys()}, h, cfg,
                      product(kind))
        x = rms_norm(h[:, -1], params["ln_f"], cfg.norm_eps)
        return logits_fn(params, cfg, x).double()

    ref = run("base", torch.float64)
    scale = float(ref.abs().max())
    for kind in KINDS:
        err = float((run(kind, torch.float32) - ref).abs().max())
        print(f"{kind} {err / scale!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
