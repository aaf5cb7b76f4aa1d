"""Architecture pool: config-driven model builders (port of
``repro.models``).  The dense decoder is ported; the encoder-decoder
family raises, as do the MoE, MLA, hybrid and RWKV families inside
:mod:`repro_torch.models.transformer` (ROADMAP.md queue 1, item 16)."""
import torch

from .config import ModelConfig, SigHeadConfig
from . import layers, sig_head, transformer


def init_params(generator, cfg: ModelConfig, dtype=None, *, device=None):
    return transformer.init_params(generator, cfg, dtype or torch.float32,
                                   device=device)


def loss_fn(params, cfg: ModelConfig, batch, remat: str = "dots"):
    return transformer.lm_loss(params, cfg, batch, remat=remat)


def init_cache(cfg: ModelConfig, B: int, max_len: int, dtype=None,
               device=None):
    return transformer.init_cache(cfg, B, max_len, dtype or torch.bfloat16,
                                  device=device)


def decode_step(params, cfg: ModelConfig, tokens, cache, **kw):
    return transformer.decode_step(params, cfg, tokens, cache, **kw)


__all__ = ["ModelConfig", "SigHeadConfig", "init_params", "loss_fn",
           "init_cache", "decode_step", "transformer", "layers", "sig_head"]
