"""Architecture pool: config-driven model builders (port of
``repro.models``): the decoder families in
:mod:`repro_torch.models.transformer` (dense, MoE, MLA, hybrid, RWKV6)
and the encoder-decoder in :mod:`repro_torch.models.encdec`."""
import torch

from .config import ModelConfig, SigHeadConfig
from . import transformer, encdec, layers, ssm, sig_head


def init_params(generator, cfg: ModelConfig, dtype=None, *, device=None):
    dtype = dtype or torch.float32
    if cfg.family == "encdec":
        return encdec.init_params(generator, cfg, dtype, device=device)
    return transformer.init_params(generator, cfg, dtype, device=device)


def loss_fn(params, cfg: ModelConfig, batch, remat: str = "dots"):
    if cfg.family == "encdec":
        return encdec.lm_loss(params, cfg, batch, remat=remat)
    return transformer.lm_loss(params, cfg, batch, remat=remat)


def init_cache(cfg: ModelConfig, B: int, max_len: int, dtype=None,
               device=None):
    dtype = dtype or torch.bfloat16
    if cfg.family == "encdec":
        return encdec.init_cache(cfg, B, max_len, dtype, device=device)
    return transformer.init_cache(cfg, B, max_len, dtype, device=device)


def decode_step(params, cfg: ModelConfig, tokens, cache, **kw):
    if cfg.family == "encdec":
        return encdec.decode_step(params, cfg, tokens, cache)
    return transformer.decode_step(params, cfg, tokens, cache, **kw)


__all__ = ["ModelConfig", "SigHeadConfig", "init_params", "loss_fn",
           "init_cache", "decode_step", "transformer", "encdec", "layers",
           "ssm", "sig_head"]
