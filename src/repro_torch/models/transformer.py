"""Decoder LM families: dense/GQA, MoE, MLA, hybrid (Mamba2 + shared
attention) and RWKV6 (port of ``repro.models.transformer``): one
init/forward/decode triple driven by ``ModelConfig``.

The model is a :class:`DecoderLM`, an ``nn.Module`` whose parameter tree
is the reference's with each layer-stacked entry (``layers``,
``dense_layers``, ``shared_attn``) split into an ``nn.ModuleList`` of
layers, walked in a Python loop where the reference runs ``lax.scan``.
Remat is a per-layer ``torch.utils.checkpoint``: ``"full"`` recomputes the
whole layer in the backward, ``"dots"`` saves the outputs of the weight
matmuls (the reference's ``dots_with_no_batch_dims_saveable``: ``aten.mm``
without batch dimensions, not the attention's or the experts' batched
products) and recomputes the rest.

The decode cache is written in place.  For the hybrid family the reference
keeps one K/V cache a shared attention block, written by the first
``n_shared_attn_blocks`` groups only: a later group reuses block
``g % n_shared_attn_blocks``'s cache, attends over one slot it writes past
that block's index, and the reference throws the write away.  The port
restores the rows it wrote, so decode equals the reference's, which
differs from a prefill when there are more groups than blocks.

On a model sharded over a model axis the embedding is vocab-parallel (a
masked lookup of this rank's rows, summed over the model group), the
logits are this rank's vocabulary block, and the token NLL all-reduces
their max and sum-exp over the model group, so no rank holds the whole
logits in training; decoding gathers them.  Where the model axis also
cuts the sequence (the ``"seq"`` rule, alone or with other axes) its
ranks hold different tokens: the embedding looks up the model group's
tokens and reduce-scatters them back to the blocks, and the LM loss
gathers the vocabulary's blocks of the output weight over that group
(its backward reduce-scatters their gradients) and takes each block's
whole logits; the layers take the whole sequence's positions
(:func:`sequence_positions`).  A cache made by
:func:`init_cache` under a sharding context is this rank's block of every
leaf (``cache_specs``), written in place: decode runs the reference's
layout, each rank its rows of the requests (the batch over the data
axes) against its block of each attention cache's sequence (``kv_seq``).
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..distributed import batch as DB
from ..distributed import collectives as C
from ..distributed.ctx import current_mesh, current_rules
from ..distributed.model_parallel import (cache_split, copy_to,
                                          decode_rows, gather_from,
                                          local_cache, reduce_from,
                                          seq_gather, seq_scatter, seq_tp)
from .config import ModelConfig
from .layers import (ParamTree, _full, _init, _split, _zeros, as_generator,
                     attention, block_rows, init_attention, init_mla,
                     init_mlp, init_moe, mla_attention, mlp, moe, rms_norm)
from .ssm import (init_mamba, init_rwkv, mamba_block, mamba_cache,
                  rwkv_block, rwkv_cache)


class DecoderLM(ParamTree):
    """A decoder LM's parameters as a module: ``embed``, ``ln_f``,
    ``lm_head`` (untied) and the layer lists of its family (``layers``;
    a MoE model's leading ``dense_layers``; the hybrid's
    ``shared_attn`` blocks) and, when attached, ``sig_head``.  Calling it
    maps tokens (B, S) to logits (B, S, V)."""

    def __init__(self, tree: dict, cfg: ModelConfig):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, tokens: torch.Tensor, remat: str = "none"):
        hidden, _ = backbone(self, self.cfg, tokens=tokens, remat=remat)
        return logits_fn(self, self.cfg, hidden)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_decoder_layer(generator: torch.Generator, cfg: ModelConfig,
                        use_moe: bool) -> dict:
    d = cfg.d_model
    p = {"ln_attn": _zeros(generator, (d,)),
         "ln_mlp": _zeros(generator, (d,)),
         "attn": init_mla(generator, cfg) if cfg.mla
         else init_attention(generator, cfg)}
    if use_moe:
        p["moe"] = init_moe(generator, cfg)
    else:
        p["mlp"] = init_mlp(generator, d, cfg.d_ff_dense or cfg.d_ff,
                            cfg.act)
    return p


def _init_shared_block(generator: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"ln_attn": _zeros(generator, (d,)),
            "ln_mlp": _zeros(generator, (d,)),
            "attn": init_attention(generator, cfg),
            "mlp": init_mlp(generator, d, cfg.d_ff, cfg.act)}


def init_params(generator, cfg: ModelConfig, dtype=torch.float32, *,
                device=None) -> DecoderLM:
    """Random init on the generator's device (an int seeds one on
    ``device``, default CUDA): every weight is drawn there, never on the
    host.  Scales as the reference's; the draws are torch's, so carry a
    reference init across with :func:`repro_torch.convert.lm_params_from_
    reference` to compare."""
    g = as_generator(generator, device)
    d, L = cfg.d_model, cfg.n_layers
    tree = {"embed": _init(g, (cfg.vocab_size, d), scale=0.02),
            "ln_f": _zeros(g, (d,))}
    if not cfg.tie_embeddings:
        tree["lm_head"] = _init(g, (d, cfg.vocab_size))
    if cfg.family == "rwkv":
        tree["layers"] = [init_rwkv(g, cfg) for _ in range(L)]
    elif cfg.family == "hybrid":
        tree["layers"] = [{"ln": _zeros(g, (d,)), "mamba": init_mamba(g, cfg)}
                          for _ in range(L)]
        tree["shared_attn"] = [_init_shared_block(g, cfg)
                               for _ in range(cfg.n_shared_attn_blocks)]
    else:  # decoder (dense or MoE; MoE may have leading dense layers)
        n_dense = cfg.moe_layer_start if cfg.moe else L
        if cfg.moe and n_dense:
            tree["dense_layers"] = [_init_decoder_layer(g, cfg, False)
                                    for _ in range(n_dense)]
        if L - n_dense:
            tree["layers"] = [_init_decoder_layer(g, cfg, True)
                              for _ in range(L - n_dense)]
        elif not cfg.moe:
            tree["layers"] = [_init_decoder_layer(g, cfg, False)
                              for _ in range(L)]
    return DecoderLM(tree, cfg).to(dtype)


# ---------------------------------------------------------------------------
# forward (training path)
# ---------------------------------------------------------------------------

def _decoder_layer_fwd(p, x: torch.Tensor, cfg: ModelConfig,
                       positions: torch.Tensor, use_moe: bool = False,
                       cache=None):
    """Returns (x, aux, new_cache); aux is 0 for a dense layer.  Under a
    sequence split ``x`` is this rank's block and ``positions`` the whole
    sequence's (:func:`sequence_positions`)."""
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    attn_fn = mla_attention if cfg.mla else attention
    a, new_kv = attn_fn(p["attn"], h, cfg, positions, cache=cache)
    x = x + a
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    if use_moe:
        m, aux = moe(p["moe"], h, cfg)
    else:
        m, aux = mlp(p["mlp"], h, cfg.act), x.new_zeros(())
    return x + m, aux, new_kv


_UNBATCHED_MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _save_unbatched_matmuls(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _UNBATCHED_MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _within(*managers):
    with contextlib.ExitStack() as stack:
        for m in managers:
            stack.enter_context(m)
        yield


def _remat(fn, mode: str):
    if mode == "none":
        return fn
    if mode not in ("full", "dots"):
        raise ValueError(mode)

    def context_fn():
        # the recompute runs in the backward, outside the forward's rows
        # scope: it reinstalls the rows the forward saw (MoE dispatch)
        rows = DB.current_rows()
        if mode == "dots":
            fwd, rec = create_selective_checkpoint_contexts(
                _save_unbatched_matmuls)
        else:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        return fwd, _within(rec, DB.rows_set(rows))

    return functools.partial(checkpoint, fn, use_reentrant=False,
                             context_fn=context_fn)


def default_positions(cfg: ModelConfig, B: int, S: int, device,
                      start=0) -> torch.Tensor:
    """(B, S) positions start, start + 1, ...; (3, B, S) under M-RoPE."""
    pos = (start + torch.arange(S, device=device))[None].expand(B, S)
    if cfg.rope_type == "mrope":
        pos = pos[None].expand(3, B, S)
    return pos


def sequence_positions(cfg: ModelConfig, B: int, S: int, device,
                       positions=None) -> torch.Tensor:
    """The positions the layers take for rows of S tokens: inside a rows
    scope whose sequence is cut (``distributed.batch.current_seq``), of
    which the rows are this rank's block, the whole sequence's (a layer
    that gathers the group's rows applies RoPE over all of them, and
    ``layers.block_positions`` gives the block's): the default positions
    from 0, or the given block's ``positions`` all-gathered over the
    split on their last dimension (tag ``sp_positions``).  Outside a
    split, ``positions`` or the default ones."""
    seq = DB.current_seq()
    if positions is not None:
        return positions if seq is None else C.all_gather(
            positions.contiguous(), seq.group, dim=positions.ndim - 1,
            tag="sp_positions")
    return default_positions(cfg, B, S if seq is None else S * seq.size,
                             device)


def _groups(cfg: ModelConfig):
    """The hybrid's groups: (g, first Mamba layer, layers, shared block)."""
    per, done = cfg.hybrid_attn_every, 0
    for g in range(-(-cfg.n_layers // per)):
        take = min(per, cfg.n_layers - done)
        yield g, done, take, g % cfg.n_shared_attn_blocks
        done += take


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings; vocab-parallel on a vocabulary split: each
    rank looks up the tokens of its rows of the table (zeros elsewhere)
    and the lookups are summed over the model group.  Where the model
    axis also cuts the sequence (the ``"seq"`` rule, alone or with other
    axes) its ranks hold different tokens: each looks up the whole model
    group's tokens (gathered: the sequence, or under context parallelism
    the group's super-block of it) and the sums are reduce-scattered
    back to the blocks (the backward all-gathers the blocks' gradients,
    so each rank's rows of the table take every token of its group's,
    and the step sums them over the other super-blocks)."""
    sp = _split(params, "embed", 0)
    if sp is None:
        return _full(params, "embed")[tokens.long()]
    seq = _vocab_seq(sp)
    if seq is not None:
        tokens = C.all_gather(tokens, seq.group, dim=1, tag="sp_tokens")
    w = params["embed"]
    v0, Vl = sp.block(sp.size * w.shape[0])
    loc = tokens.long() - v0
    inside = (loc >= 0) & (loc < Vl)
    x = w[loc.clamp(0, Vl - 1)] * inside[..., None].to(w.dtype)
    if seq is not None:
        return seq_scatter(x, seq, 1, "sp_embed")
    return reduce_from(x, sp, tag="embed")


def _vocab_seq(sp):
    """The group over which a vocabulary split ``sp`` exchanges tokens
    when the innermost rows scope cuts the sequence over its axis: the
    model group inside the sequence's (``model_parallel.seq_tp``), whose
    blocks are the sequence's over the model axis alone and a
    super-block of it under context parallelism.  None when the ranks of
    ``sp`` hold the same tokens."""
    tp = seq_tp(sp, DB.current_seq())
    return None if tp is None else tp.inner


def backbone(params, cfg: ModelConfig, tokens=None, embeds=None,
             positions=None, remat: str = "dots"):
    """Token/embedding inputs -> final hidden states (B, S, d).  Returns
    (hidden, aux_loss); the aux loss is the MoE layers' sum, else 0.
    Inside a ``rows_scope`` of a batch whose sequence is cut, the inputs
    are this rank's block (``positions`` too) and the layers take the
    whole sequence's positions (:func:`sequence_positions`)."""
    x = embed(params, tokens) if embeds is None else embeds
    B, S = x.shape[:2]
    positions = sequence_positions(cfg, B, S, x.device, positions)
    aux = x.new_zeros(())
    if cfg.family == "rwkv":
        body = _remat(lambda p, h: rwkv_block(p, h, cfg)[0], remat)
        for p in params["layers"]:
            x = body(p, x)
    elif cfg.family == "hybrid":
        mbody = _remat(lambda p, h: h + mamba_block(
            p["mamba"], rms_norm(h, p["ln"], cfg.norm_eps), cfg)[0], remat)
        layers, shared = params["layers"], params["shared_attn"]
        for _, first, take, b in _groups(cfg):
            for p in layers[first:first + take]:
                x = mbody(p, x)
            x = _decoder_layer_fwd(shared[b], x, cfg, positions)[0]
    else:
        stacks = [("layers", cfg.moe)]
        if cfg.moe and cfg.moe_layer_start:
            stacks.insert(0, ("dense_layers", False))
        for key, use_moe in stacks:
            body = _remat(lambda p, h, use_moe=use_moe: _decoder_layer_fwd(
                p, h, cfg, positions, use_moe)[:2], remat)
            for p in params[key]:
                x, a = body(p, x)
                aux = aux + a
    return rms_norm(x, params["ln_f"], cfg.norm_eps), aux


def placed_backbone(params, cfg: ModelConfig, batch: dict,
                    remat: str = "dots", head=None):
    """:func:`backbone` over a batch whose leaves may be placed (DTensors
    of this rank's rows, and of its block of the sequence under the
    ``"seq"`` rule), inside the rows scope of its tokens (or embeds), and
    ``head(hidden)`` (when given) inside it too -> (hidden or head's
    result, the aux loss, the sequence's split or None).  A plain batch
    is whole, or the block of an enclosing scope's split."""
    local = {k: DB.to_local(v) for k, v in batch.items()}
    with DB.rows_scope(batch.get("tokens", batch.get("embeds"))):
        hidden, aux = backbone(params, cfg, tokens=local.get("tokens"),
                               embeds=local.get("embeds"),
                               positions=local.get("positions"),
                               remat=remat)
        return (hidden if head is None else head(hidden)), aux, \
            DB.current_seq()


def vocab_logits(params, cfg: ModelConfig, hidden: torch.Tensor):
    """-> (logits of this rank's vocabulary block, the vocabulary split);
    the whole logits and None when the vocabulary is not split.  Where
    the vocabulary's axis also cuts the sequence (alone or with other
    axes), the ranks of the model group hold different tokens: the
    weight's blocks are gathered over that group (``seq_gather``: the
    backward sums each block's gradient over it) and the logits are the
    block's whole vocabulary, so the loss takes no vocabulary
    exchange."""
    key, dim = ("embed", 0) if cfg.tie_embeddings else ("lm_head", 1)
    sp = _split(params, key, dim)
    seq = None if sp is None else _vocab_seq(sp)
    if seq is not None:
        w, sp = seq_gather(params[key], seq, dim, "sp_vocab"), None
    else:
        w = params[key] if sp is not None else _full(params, key)
    if cfg.tie_embeddings:
        w = w.T
    logits = copy_to(hidden, sp) @ w.to(hidden.dtype)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits, sp


def logits_fn(params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """The whole logits (B, S, V) (gathered over a vocabulary split)."""
    logits, sp = vocab_logits(params, cfg, hidden)
    return gather_from(logits, sp, dim=-1, tag="logits")


def _token_nll(logits: torch.Tensor, labels: torch.Tensor, sp):
    """-> (token NLL, logsumexp) of float32 logits; over a vocabulary
    split the max and the sum-exp are all-reduced over the model group
    and the label's logit is summed from the rank that holds it."""
    safe = torch.clamp(labels, min=0).long()
    if sp is None:
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, safe[..., None])[..., 0], \
            torch.logsumexp(logits, dim=-1)
    Vl = logits.shape[-1]
    v0 = sp.index * Vl
    m = C.all_reduce_(logits.detach().amax(-1).contiguous(), sp.group,
                      tag="vocab_max", op="max")
    se = reduce_from(torch.exp(logits - m[..., None]).sum(-1), sp,
                     tag="vocab_sumexp")
    lse = m + torch.log(se)
    loc = safe - v0
    inside = (loc >= 0) & (loc < Vl)
    tgt = torch.gather(logits, -1, loc.clamp(0, Vl - 1)[..., None])[..., 0]
    tgt = reduce_from(tgt * inside, sp, tag="vocab_target")
    return lse - tgt, lse


def lm_loss(params, cfg: ModelConfig, batch: dict, remat: str = "dots"):
    """batch: tokens (B, S) int, labels (B, S) int (< 0 = ignore), optional
    embeds/positions.  Returns (loss + aux + z-loss, metrics): the metrics'
    ``loss`` is the token NLL alone.  On a placed batch
    (:func:`placed_backbone`) the loss is this rank's rows' and, under the
    ``"seq"`` rule, its block's positions' (each its own label: the data
    shifts them), ``ntok`` their count."""
    (logits, sp), aux, _ = placed_backbone(
        params, cfg, batch, remat, lambda h: vocab_logits(params, cfg, h))
    labels = DB.to_local(batch["labels"])
    valid = (labels >= 0).float()
    nll, lse = _token_nll(logits.float(), labels, sp)
    ntok = torch.clamp(valid.sum(), min=1.0)
    loss = (nll * valid).sum() / ntok
    # z-loss for stability at scale
    zl = 1e-4 * (lse ** 2 * valid).sum() / ntok
    return loss + aux + zl, {"loss": loss, "aux": aux, "ntok": ntok}


# ---------------------------------------------------------------------------
# decode path (serving)
# ---------------------------------------------------------------------------

def _zeros_stack(n: int, tree: dict) -> dict:
    """A per-layer cache tree stacked n times on a new leading axis."""
    return {k: v.new_zeros((n,) + v.shape) for k, v in tree.items()}


def init_cache(cfg: ModelConfig, B: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """The decode cache on ``device`` (default CUDA): ``{"layers": ...}``
    with a leading layer axis: K/V (L, B, max_len, Hkv, hd), MLA's
    ``c_kv`` / ``k_rope``, RWKV's shifts and WKV state, Mamba's conv ring
    and SSM state; the hybrid's ``shared_attn`` K/V a shared block; an
    int32 ``index`` a layer (a block) for the attention caches.  Under a
    sharding context each leaf is this rank's block by ``cache_specs``
    (:func:`~repro_torch.distributed.model_parallel.local_cache`: the
    requests over the data axes, each attention cache's sequence over
    ``kv_seq``'s axes), allocated as such."""
    mesh = current_mesh()
    if mesh is None:
        return _init_cache(cfg, B, max_len, dtype, device)
    return local_cache(_init_cache(cfg, B, max_len, dtype, "meta"), mesh,
                       current_rules(), device=resolve_device(device))


def _init_cache(cfg: ModelConfig, B: int, max_len: int, dtype,
                device) -> dict:
    dev = resolve_device(device)
    L, hd = cfg.n_layers, cfg.resolved_head_dim

    def zeros(*shape, dtype=dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.family == "rwkv":
        return {"layers": _zeros_stack(L, rwkv_cache(cfg, B, dtype, dev))}
    if cfg.family == "hybrid":
        n = cfg.n_shared_attn_blocks
        return {"layers": _zeros_stack(L, mamba_cache(cfg, B, dtype, dev)),
                "shared_attn": {
                    "k": zeros(n, B, max_len, cfg.n_kv_heads, hd),
                    "v": zeros(n, B, max_len, cfg.n_kv_heads, hd),
                    "index": zeros(n, dtype=torch.int32)}}
    if cfg.mla:
        return {"layers": {
            "c_kv": zeros(L, B, max_len, cfg.kv_lora_rank),
            "k_rope": zeros(L, B, max_len, cfg.qk_rope_dim),
            "index": zeros(L, dtype=torch.int32)}}
    return {"layers": {
        "k": zeros(L, B, max_len, cfg.n_kv_heads, hd),
        "v": zeros(L, B, max_len, cfg.n_kv_heads, hd),
        "index": zeros(L, dtype=torch.int32)}}


def _write(stacked: dict, i: int, new: dict) -> None:
    """Layer i's new cache into the stacked cache (in place)."""
    for k, v in new.items():
        stacked[k][i] = v


def decode_batch(cache, B: int):
    """-> (this rank's rows of a decode step of B requests, a slice of
    the whole batch; a scope installing them for the MoE, whose dispatch
    groups are the whole batch's).  The rows are the cache's
    (:func:`~repro_torch.distributed.model_parallel.decode_rows`): every
    row where the cache holds the whole batch."""
    rows = decode_rows(cache, B)
    if rows is None:
        return slice(None), contextlib.nullcontext()
    start, n = rows.block(B)
    return slice(start, start + n), DB.rows_set(DB.Rows(rows.group, B,
                                                        start, n))


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, tokens, cache: dict,
                positions=None, embeds=None):
    """One decoding step.  tokens: (B, S) (or embeds (B, S, d)).  Returns
    (logits (B, S, V), cache): the cache is updated in place (the
    counterpart of the reference's donated cache) and returned.

    On a cache made under a sharding context (:func:`init_cache`) the
    inputs are the whole batch, the same on every rank, and the step runs
    this rank's rows of it, the cache's: the logits are those rows'
    (``serve.engine.make_serve_step`` gathers the next tokens).  Where the
    cache's sequence is cut, the attention layers combine their blocks
    over its group (``layers.attention``)."""
    mine, scope = decode_batch(cache, (tokens if embeds is None
                                       else embeds).shape[0])
    tokens = None if tokens is None else tokens[mine]
    embeds = None if embeds is None else embeds[mine]
    if positions is not None:
        positions = positions[..., mine, :]
    with scope:
        return _decode_step(params, cfg, tokens, cache, positions, embeds)


def _with_seq(c: dict, seq) -> dict:
    """A layer's cache with its sequence split (when cut)."""
    if seq is not None:
        c["seq"] = seq
    return c


def _decode_step(params, cfg: ModelConfig, tokens, cache: dict, positions,
                 embeds):
    x = embed(params, tokens) if embeds is None else embeds
    B, S = x.shape[:2]
    lc = cache["layers"]
    if positions is None:
        if cfg.family == "hybrid":
            start = cache["shared_attn"]["index"][0]
        elif "index" in lc:
            start = lc["index"][0]
        else:
            start = 0
        positions = default_positions(cfg, B, S, x.device, start=start)

    if cfg.family == "rwkv":
        for i, p in enumerate(params["layers"]):
            x, c2 = rwkv_block(p, x, cfg, cache={k: v[i]
                                                 for k, v in lc.items()})
            _write(lc, i, c2)
    elif cfg.family == "hybrid":
        kvs = cache["shared_attn"]
        seq = cache_split(cache, ("shared_attn", "k"), 2)
        layers, shared = params["layers"], params["shared_attn"]
        for g, first, take, b in _groups(cfg):
            for i in range(first, first + take):
                p = layers[i]
                h, c2 = mamba_block(p["mamba"],
                                    rms_norm(x, p["ln"], cfg.norm_eps), cfg,
                                    cache={k: v[i] for k, v in lc.items()})
                x = x + h
                _write(lc, i, c2)
            kvc = _with_seq({"k": kvs["k"][b], "v": kvs["v"][b],
                             "index": kvs["index"][b]}, seq)
            if g < cfg.n_shared_attn_blocks:  # shared blocks share one cache
                x, _, kvn = _decoder_layer_fwd(shared[b], x, cfg, positions,
                                               cache=kvc)
                kvs["index"][b] = kvn["index"]
            else:  # the reference discards this group's write
                rows, _ = block_rows(kvc["index"], S, kvc["k"].shape[1],
                                     seq)
                saved = [kvc[k].index_select(1, rows) for k in ("k", "v")]
                x, _, _ = _decoder_layer_fwd(shared[b], x, cfg, positions,
                                             cache=kvc)
                for k, old in zip(("k", "v"), saved):
                    kvc[k].index_copy_(1, rows, old)
    else:
        stacks = [("layers", cfg.moe)]
        if cfg.moe and cfg.moe_layer_start:
            stacks.insert(0, ("dense_layers", False))
        seq = cache_split(cache, ("layers", "c_kv" if cfg.mla else "k"), 2)
        i = 0
        for key, use_moe in stacks:
            for p in params[key]:
                x, _, c2 = _decoder_layer_fwd(
                    p, x, cfg, positions, use_moe,
                    cache=_with_seq({k: v[i] for k, v in lc.items()}, seq))
                lc["index"][i] = c2["index"]
                i += 1
    hidden = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return logits_fn(params, cfg, hidden), cache
