"""Input / state specs for every (architecture × shape) dry-run cell (port
of ``repro.launch.specs``).

The reference answers ``jax.ShapeDtypeStruct`` trees from
``jax.eval_shape``; the port answers **meta tensors**: the models, caches
and optimizer states of the published configs (405B parameters included)
are built on the ``meta`` device, shapes and dtypes only, without a
single real allocation.  The trees keep the port's layout (a model is a
``ParamTree`` of per-layer entries where the reference stacks layers on a
leading axis).
"""
from __future__ import annotations

import torch

from .. import models as M
from ..configs import ARCH_IDS
from ..models.config import ModelConfig

SHAPES = {
    "train_4k":    dict(kind="train",   seq=4096,   batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768,  batch=32),
    "decode_32k":  dict(kind="decode",  seq=32768,  batch=128),
    "long_500k":   dict(kind="decode",  seq=524288, batch=1),
}

# long_500k needs sub-quadratic sequence mixing (DESIGN.md §4: skips)
LONG_OK = {"zamba2-7b", "rwkv6-1.6b"}


def cell_is_runnable(arch: str, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_OK:
        return False, "pure full-attention arch: 500k decode skipped (DESIGN.md §4)"
    return True, ""


def all_cells():
    for arch in ARCH_IDS:
        for shape in SHAPES:
            yield arch, shape


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs_for(cfg: ModelConfig, shape_name: str) -> dict:
    """Training / prefill batch as meta tensors."""
    info = SHAPES[shape_name]
    B, S = info["batch"], info["seq"]
    i32, bf16 = torch.int32, torch.bfloat16
    if cfg.family == "encdec":
        # seq axis = encoder frames (stub frontend); decoder length fixed
        return {"frames": _meta((B, S, cfg.d_model), bf16),
                "tokens": _meta((B, cfg.decoder_max_len), i32),
                "labels": _meta((B, cfg.decoder_max_len), i32)}
    if cfg.rope_type == "mrope":
        return {"embeds": _meta((B, S, cfg.d_model), bf16),
                "positions": _meta((3, B, S), i32),
                "labels": _meta((B, S), i32)}
    return {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}


def decode_inputs_for(cfg: ModelConfig, shape_name: str):
    """(tokens, cache, generator) for a serve_step cell: meta tokens (the
    whole batch), the meta cache (under a sharding context, this rank's
    blocks of it) and a seeded ``torch.Generator`` where the reference
    returns a key.

    The cache length is rounded up to a multiple of 512 so the kv_seq axis
    is cleanly divisible by any mesh-axis product (16, 256, 512) — uneven
    shardings get silently dropped by the divisibility guard and the cache
    then fails to fit in HBM (§Perf cell B).
    """
    info = SHAPES[shape_name]
    B, S = info["batch"], info["seq"]
    if cfg.family == "encdec":
        cache = M.init_cache(cfg, B, S, torch.bfloat16, device="meta")
    else:
        cache_len = -(-(S + 1) // 512) * 512
        cache = M.init_cache(cfg, B, cache_len, torch.bfloat16,
                             device="meta")
    tokens = _meta((B, 1), torch.int32)
    gen = torch.Generator()
    gen.manual_seed(0)
    return tokens, cache, gen


def params_specs_for(cfg: ModelConfig, dtype=torch.bfloat16):
    """The model with every parameter a meta tensor of ``dtype``."""
    return M.init_params(0, cfg, dtype, device="meta")


def opt_state_specs_for(opt, params):
    """``opt.init`` over the meta parameters: the state's meta tensors."""
    return opt.init(params)


def hbm_bytes_estimate(cfg: ModelConfig, shape_name: str, n_dev: int,
                       kind: str | None = None) -> float:
    """Fusion-aware per-device HBM traffic per step (napkin model).

    XLA's `bytes accessed` counts every HLO op unfused and overestimates real
    DRAM traffic by 1-2 orders of magnitude; this analytic estimate assumes
    perfect elementwise fusion: parameters, saved activations (remat=dots),
    logits, optimizer state, and KV/state caches each move once per use.
    """
    info = SHAPES[shape_name]
    B, S = info["batch"], info["seq"]
    kind = kind or info["kind"]
    P = cfg.param_count()
    p_bytes = 2.0 * P / n_dev                     # bf16 params per device
    d, ff = cfg.d_model, (cfg.d_ff_expert if cfg.moe else cfg.d_ff)
    hd = cfg.resolved_head_dim

    if kind == "decode":
        # params once + cache read/write once
        if cfg.family == "rwkv":
            cache = cfg.n_layers * B * (d // cfg.rwkv_head_dim) * \
                cfg.rwkv_head_dim ** 2 * 4
        elif cfg.family == "hybrid":
            d_in = cfg.mamba_expand * d
            cache = cfg.n_layers * B * (d_in // cfg.mamba_head_dim) * \
                cfg.mamba_head_dim * cfg.ssm_state * 4
            cache += cfg.n_shared_attn_blocks * B * S * 2 * \
                cfg.n_kv_heads * hd * 2
        elif cfg.mla:
            cache = cfg.n_layers * B * S * (cfg.kv_lora_rank +
                                            cfg.qk_rope_dim) * 2
        else:
            cache = cfg.n_layers * B * S * 2 * cfg.n_kv_heads * hd * 2
        act_p = cfg.active_param_count() if cfg.moe else P
        return 2.0 * act_p / n_dev + 2.0 * cache / n_dev

    tokens_dev = B * S / n_dev
    # saved dot outputs per token per layer (remat="dots" policy)
    attn_save = cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd + d
    ff_mult = (cfg.top_k + cfg.n_shared_experts) if cfg.moe else 1
    mlp_save = ff_mult * (3 * ff) + d
    act = tokens_dev * cfg.n_layers * (attn_save + mlp_save) * 2  # bf16
    logits = tokens_dev * cfg.vocab_size * 4
    if kind == "prefill":
        return p_bytes + act + logits
    # train: params fwd+bwd+update, adafactor state ~1.5 passes, acts saved
    # then re-read in bwd, logits fwd+bwd
    opt_bytes = 4.0 * P / n_dev * 0.5             # factored second moment
    return 3 * p_bytes + 2 * opt_bytes + 2.5 * act + 2 * logits


def flops_estimate(cfg: ModelConfig, shape_name: str) -> float:
    """MODEL_FLOPS: 6·N·D (dense train), 6·N_active·D (MoE); 2·N·D forward
    for prefill; 2·N_active per token for decode."""
    info = SHAPES[shape_name]
    B, S = info["batch"], info["seq"]
    n = cfg.active_param_count() if cfg.moe else cfg.param_count()
    if cfg.family == "encdec" and info["kind"] != "decode":
        # encoder sees S frames, decoder decoder_max_len tokens
        tokens = B * (S + cfg.decoder_max_len) / 2  # rough split of params
    else:
        tokens = B * S
    if info["kind"] == "train":
        return 6.0 * n * tokens
    if info["kind"] == "prefill":
        return 2.0 * n * tokens
    return 2.0 * n * B  # decode: one token per sequence
