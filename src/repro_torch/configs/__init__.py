"""Assigned architecture pool: one module per architecture (exact configs
from the assignment sheet) + reduced smoke variants + the paper's own
signature-model example configs."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig, SigHeadConfig

ARCH_IDS = [
    "command-r-35b", "llama3-405b", "qwen1.5-32b", "qwen3-4b", "qwen2-vl-2b",
    "deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b", "zamba2-7b",
    "rwkv6-1.6b", "whisper-large-v3",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving reduction for CPU smoke tests: tiny widths/layers,
    few experts, small vocab — same code paths as the full config."""
    upd: dict = dict(
        n_layers=4 if cfg.family == "hybrid" else 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=96,
        vocab_size=128,
        sig_head=cfg.sig_head,
    )
    if cfg.moe:
        upd.update(n_experts=4, top_k=2, d_ff_expert=32,
                   n_shared_experts=min(cfg.n_shared_experts, 1),
                   d_ff_dense=96 if cfg.d_ff_dense else 0)
    if cfg.mla:
        upd.update(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                   v_head_dim=16, head_dim=0)
    if cfg.family == "hybrid":
        upd.update(ssm_state=16, mamba_head_dim=16, hybrid_attn_every=2,
                   n_shared_attn_blocks=2, head_dim=0)
    if cfg.family == "rwkv":
        upd.update(rwkv_head_dim=16, n_heads=4, n_kv_heads=4)
    if cfg.family == "encdec":
        upd.update(n_encoder_layers=2, n_audio_frames=16, decoder_max_len=32)
    if cfg.rope_type == "mrope":
        upd.update(mrope_sections=(2, 3, 3), head_dim=16)
    return dataclasses.replace(cfg, **upd)


def with_sig_head(cfg: ModelConfig, **kw) -> ModelConfig:
    return dataclasses.replace(cfg, sig_head=SigHeadConfig(**kw))
