"""The dense decoder LM (port of the ``family == "decoder"`` branch of
``repro.models.transformer`` with ``moe=False``, ``mla=False``).

The model is a :class:`DecoderLM`, an ``nn.Module`` whose parameter tree
is the reference's with the layer-stacked ``"layers"`` entry split into an
``nn.ModuleList`` of layers, walked in a Python loop where the reference
runs ``lax.scan``.  Remat is a per-layer ``torch.utils.checkpoint``:
``"full"`` recomputes the whole layer in the backward, ``"dots"`` saves the
outputs of the weight matmuls (the reference's
``dots_with_no_batch_dims_saveable``: ``aten.mm`` without batch dimensions,
not the attention's batched products) and recomputes the rest.

The MoE, MLA, hybrid (Mamba2 + shared attention) and RWKV families raise
``NotImplementedError``: they are ROADMAP.md queue 1, item 16.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from .config import ModelConfig
from .layers import (ParamTree, _init, _zeros, as_generator, attention,
                     init_attention, init_mlp, mlp, rms_norm)


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a family this port does not have yet."""
    kind = None
    if cfg.family != "decoder":
        kind = f"{cfg.family} family"
    elif cfg.moe:
        kind = "mixture-of-experts decoder"
    elif cfg.mla:
        kind = "MLA decoder"
    if kind is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {kind} is not ported yet (ROADMAP.md queue 1, "
            f"item 16); the port runs the dense decoder")


class DecoderLM(ParamTree):
    """The dense decoder's parameters as a module: ``embed``, ``ln_f``,
    ``lm_head`` (untied), ``layers`` (one ``ParamTree`` a layer:
    ``ln_attn``, ``ln_mlp``, ``attn``, ``mlp``) and, when attached,
    ``sig_head``.  Calling it maps tokens (B, S) to logits (B, S, V)."""

    def __init__(self, tree: dict, cfg: ModelConfig):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, tokens: torch.Tensor, remat: str = "none"):
        hidden, _ = backbone(self, self.cfg, tokens=tokens, remat=remat)
        return logits_fn(self, self.cfg, hidden)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_decoder_layer(generator: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"ln_attn": _zeros(generator, (d,)),
            "ln_mlp": _zeros(generator, (d,)),
            "attn": init_attention(generator, cfg),
            "mlp": init_mlp(generator, d, cfg.d_ff_dense or cfg.d_ff,
                            cfg.act)}


def init_params(generator, cfg: ModelConfig, dtype=torch.float32, *,
                device=None) -> DecoderLM:
    """Random init on the generator's device (an int seeds one on
    ``device``, default CUDA): every weight is drawn there, never on the
    host.  Scales as the reference's; the draws are torch's, so carry a
    reference init across with :func:`repro_torch.convert.lm_params_from_
    reference` to compare."""
    check_ported(cfg)
    g = as_generator(generator, device)
    d = cfg.d_model
    tree = {"embed": _init(g, (cfg.vocab_size, d), scale=0.02),
            "ln_f": _zeros(g, (d,))}
    if not cfg.tie_embeddings:
        tree["lm_head"] = _init(g, (d, cfg.vocab_size))
    tree["layers"] = [_init_decoder_layer(g, cfg)
                      for _ in range(cfg.n_layers)]
    return DecoderLM(tree, cfg).to(dtype)


# ---------------------------------------------------------------------------
# forward (training path)
# ---------------------------------------------------------------------------

def _decoder_layer_fwd(p, x: torch.Tensor, cfg: ModelConfig,
                       positions: torch.Tensor, cache=None):
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    a, new_kv = attention(p["attn"], h, cfg, positions, cache=cache)
    x = x + a
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    return x + mlp(p["mlp"], h, cfg.act), new_kv


_UNBATCHED_MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _save_unbatched_matmuls(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _UNBATCHED_MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, mode: str):
    if mode == "none":
        return fn
    if mode == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if mode == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_unbatched_matmuls))
    raise ValueError(mode)


def default_positions(cfg: ModelConfig, B: int, S: int, device,
                      start=0) -> torch.Tensor:
    """(B, S) positions start, start + 1, ...; (3, B, S) under M-RoPE."""
    pos = (start + torch.arange(S, device=device))[None].expand(B, S)
    if cfg.rope_type == "mrope":
        pos = pos[None].expand(3, B, S)
    return pos


def backbone(params, cfg: ModelConfig, tokens=None, embeds=None,
             positions=None, remat: str = "dots"):
    """Token/embedding inputs -> final hidden states (B, S, d).  Returns
    (hidden, aux_loss); a dense decoder's aux loss is 0."""
    check_ported(cfg)
    x = params["embed"][tokens.long()] if embeds is None else embeds
    B, S = x.shape[:2]
    if positions is None:
        positions = default_positions(cfg, B, S, x.device)
    body = _remat(lambda p, h: _decoder_layer_fwd(p, h, cfg, positions)[0],
                  remat)
    for p in params["layers"]:
        x = body(p, x)
    return rms_norm(x, params["ln_f"], cfg.norm_eps), x.new_zeros(())


def logits_fn(params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = hidden @ w.to(hidden.dtype)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def lm_loss(params, cfg: ModelConfig, batch: dict, remat: str = "dots"):
    """batch: tokens (B, S) int, labels (B, S) int (< 0 = ignore), optional
    embeds/positions.  Returns (loss + aux + z-loss, metrics): the metrics'
    ``loss`` is the token NLL alone."""
    hidden, aux = backbone(params, cfg, tokens=batch.get("tokens"),
                           embeds=batch.get("embeds"),
                           positions=batch.get("positions"), remat=remat)
    logits = logits_fn(params, cfg, hidden).float()
    labels = batch["labels"]
    valid = (labels >= 0).float()
    safe = torch.clamp(labels, min=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    ntok = torch.clamp(valid.sum(), min=1.0)
    loss = (nll * valid).sum() / ntok
    # z-loss for stability at scale
    zl = 1e-4 * (torch.logsumexp(logits, dim=-1) ** 2 * valid).sum() / ntok
    return loss + aux + zl, {"loss": loss, "aux": aux, "ntok": ntok}


# ---------------------------------------------------------------------------
# decode path (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, B: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """{"layers": {"k", "v": (L, B, max_len, Hkv, hd), "index": (L,)
    int32}} on ``device`` (default CUDA)."""
    check_ported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"layers": {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "index": torch.zeros((cfg.n_layers,), dtype=torch.int32,
                             device=dev)}}


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, tokens, cache: dict,
                positions=None, embeds=None):
    """One decoding step.  tokens: (B, S) (or embeds (B, S, d)).  Returns
    (logits (B, S, V), cache): the cache is updated in place (the
    counterpart of the reference's donated cache) and returned."""
    check_ported(cfg)
    x = params["embed"][tokens.long()] if embeds is None else embeds
    B, S = x.shape[:2]
    lc = cache["layers"]
    if positions is None:
        positions = default_positions(cfg, B, S, x.device,
                                      start=lc["index"][0])
    for i, p in enumerate(params["layers"]):
        c = {"k": lc["k"][i], "v": lc["v"][i], "index": lc["index"][i]}
        x, c2 = _decoder_layer_fwd(p, x, cfg, positions, cache=c)
        lc["index"][i] = c2["index"]
    hidden = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return logits_fn(params, cfg, hidden), cache

