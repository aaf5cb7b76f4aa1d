"""Whisper-style encoder-decoder backbone (port of
``repro.models.encdec``).

The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, F, d_model).  Everything after it is
real: sinusoidal positions, the bidirectional encoder, the causal decoder
with cross-attention and a tied output embedding.  The model is an
:class:`EncDecLM` whose ``enc_layers`` and ``dec_layers`` are
``nn.ModuleList``\\ s of layers, walked in Python loops where the
reference scans stacked parameters.

Serving decodes one token at a time against cross K/V computed once from
the encoder's output (:func:`prefill_cross`) and a self-attention cache of
``decoder_max_len`` rows, written in place.

On a model sharded over a model axis
(:func:`repro_torch.distributed.model_parallel.shard_model`) the layers
run their tensor-parallel blocks where the reference annotates
``shard(...)``: encoder and decoder self-attention and the
cross-attention over this rank's heads (``wq`` column-, ``wo``
row-parallel; ``cross_kv`` projects the KV heads of this rank's query
heads from the replicated ``wk``/``wv``), the gated GELU MLPs over their
``ff`` columns, and the tied vocabulary as the decoder LM's is: a
vocab-parallel lookup, this rank's block of the logits in the loss,
gathered logits in decoding.  A head count the model axis does not divide
(20 heads over 16) runs on the whole weights.  FSDP shards (``"data"``)
are gathered by ``p[key]``.  A cache made by :func:`init_cache` under a
sharding context is this rank's block by ``cache_specs``, the self and
the cross K/V alike: its rows of the requests, and its block of the
decoder positions and of the frames where ``kv_seq``'s axes divide them
(1,500 frames stay whole over 16 ranks).

In a prefill or a train step under the ``"seq"`` rule the frames and the
decoder tokens are both cut over the same group (``distributed.batch.
Rows.seq``; :func:`placed_hidden`): the encoder adds its block's rows of
the sinusoids and its self-attention attends the block's queries over the
gathered frames, the decoder adds its block's rows of ``pos_dec`` and
attends causally over the gathered tokens, and the cross-attention
gathers the decoder's queries (448 rows, where the frames are 32k),
attends them over this rank's block of the frames, merges the blocks'
softmax partials (``layers.combine_blocks``) and keeps its block's query
rows.  Where the model axis that cuts them also splits the heads and
the ``ff`` columns (Megatron sequence parallelism, ``model_parallel.
seq_tp``), self-attention and the MLPs gather their block's rows and
reduce-scatter their row-parallel sums (``layers.attention``,
``layers.mlp``), and so does the cross-attention: :func:`cross_kv`
gathers the encoder's block of frames once a layer and projects this
rank's KV heads over every frame, and the decoder's block of tokens is
gathered for the queries of this rank's heads, which attend over every
frame, ``wo``'s partial sums reduce-scattered back to the token block.
Where the frames and tokens are cut over the model axis and others
(context parallelism, ``model_parallel.SeqTP``), the gathered rows are
the model group's super-blocks: self-attention and the MLPs run as the
decoder LM's layers do, and :func:`cross_kv` gathers the K/V of its
heads over the other axes too, so that each rank's heads attend the
tokens' super-block over every frame.  In a prefill whose frames are
cut and whose tokens are not, the queries are the same on every rank of
the group and only the K/V side gathers.  Every exchange is
differentiable.  Two train steps raise: one whose
frames are cut and whose tokens are not (every rank of the group then
computes the same decoder), and one whose tokens are cut over the model
axis and whose frames are not while encoder weights are split over it
(the encoder's tensor-parallel backward takes its output's gradient as
the same on every rank of the group, where each holds its tokens'
share).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..distributed import batch as DB
from ..distributed.ctx import current_mesh, current_rules
from ..distributed.model_parallel import (MODEL, cache_split, copy_to,
                                          local_cache, placements,
                                          seq_gather, seq_tp, tp_enter,
                                          tp_exit)
from .config import ModelConfig
from .layers import (ParamTree, _attend_cache, _full, _init, _sdpa, _weight,
                     _zeros, as_generator, attention, combine_blocks,
                     decode_partials, every_head, heads_split,
                     init_attention, init_mlp, mlp, prompt_split, rms_norm)
from .transformer import (_remat, _token_nll, _with_seq, decode_batch,
                          default_positions, embed, logits_fn,
                          sequence_positions, vocab_logits)


def sinusoids(length: int, channels: int, start: int = 0) -> np.ndarray:
    """Rows [start, start + length) of the sinusoidal position table."""
    t = np.arange(start, start + length)[:, None]
    inv = np.exp(-np.log(10000.0) * np.arange(channels // 2)
                 / (channels // 2 - 1))
    ang = t * inv[None]
    return np.concatenate([np.sin(ang), np.cos(ang)],
                          axis=1).astype(np.float32)


class EncDecLM(ParamTree):
    """The encoder-decoder's parameters as a module: ``enc_layers``,
    ``dec_layers``, ``embed`` (tied output), ``pos_dec``, ``ln_enc`` and
    ``ln_f``.  Calling it maps frames (B, F, d) and tokens (B, S) to
    logits (B, S, V)."""

    def __init__(self, tree: dict, cfg: ModelConfig):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, frames: torch.Tensor, tokens: torch.Tensor,
                remat: str = "none"):
        enc = encode(self, self.cfg, frames, remat=remat)
        hidden = decode_train(self, self.cfg, enc, tokens, remat=remat)
        return logits_fn(self, self.cfg, hidden)


def init_params(generator, cfg: ModelConfig, dtype=torch.float32, *,
                device=None) -> EncDecLM:
    """Random init on the generator's device (an int seeds one on
    ``device``, default CUDA), scales as the reference's."""
    g = as_generator(generator, device)
    d = cfg.d_model

    def enc_one():
        return {"ln_attn": _zeros(g, (d,)), "ln_mlp": _zeros(g, (d,)),
                "attn": init_attention(g, cfg),
                "mlp": init_mlp(g, d, cfg.d_ff, cfg.act)}

    def dec_one():
        return {"ln_self": _zeros(g, (d,)), "ln_cross": _zeros(g, (d,)),
                "ln_mlp": _zeros(g, (d,)),
                "self_attn": init_attention(g, cfg),
                "cross_attn": init_attention(g, cfg),
                "mlp": init_mlp(g, d, cfg.d_ff, cfg.act)}

    tree = {
        "enc_layers": [enc_one() for _ in range(cfg.n_encoder_layers)],
        "dec_layers": [dec_one() for _ in range(cfg.n_layers)],
        "embed": _init(g, (cfg.vocab_size, d), scale=0.02),
        "pos_dec": _init(g, (cfg.decoder_max_len, d), scale=0.02),
        "ln_enc": _zeros(g, (d,)), "ln_f": _zeros(g, (d,)),
    }
    return EncDecLM(tree, cfg).to(dtype)


def _cross_attention(p, x: torch.Tensor, enc_kv, cfg,
                     seq=None) -> torch.Tensor:
    """x: (B,S,d); enc_kv: precomputed (k, v) each (B, F, Hkv, hd): every
    KV head, or this rank's under a heads split; under ``seq`` (a cache
    cut on its frames, or a prefill's block of the frames) this rank's
    block of the frames, combined over its group as ``layers.attention``
    combines a self-attention cache.  Where ``x`` is itself a block of a
    prefill's tokens, the tokens' queries are gathered first and this
    block's rows of the output kept; where the heads are split over the
    axis that cuts the tokens (``model_parallel.seq_tp``), the model
    group's rows are gathered instead (``tp_enter``: the tokens'
    super-block under context parallelism), this rank's heads attend
    them over every frame (``enc_kv`` and ``seq`` None, as
    :func:`cross_kv` returns them) and ``wo``'s row-parallel sum is
    reduce-scattered back to the block (``tp_exit``)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    tp = heads_split(p, cfg)
    every = every_head(tp, seq)
    k, v = enc_kv
    if tp is None:
        sp, H = None, cfg.n_heads
    else:
        sp, kv0, Hkv = tp
        H = cfg.n_heads // sp.size
        if k.shape[2] != Hkv and not every:   # the cross K/V of every head
            k, v = (t.narrow(2, kv0, Hkv) for t in (k, v))
    qseq = prompt_split(x)
    whole = seq_tp(sp, qseq)
    x = tp_enter(x, sp, whole)
    q = (x @ _weight(p, "wq", sp).to(x.dtype)).reshape(B, x.shape[1], H, hd)
    k, v = k.to(x.dtype), v.to(x.dtype)
    if seq is None:
        out = _sdpa(q, k, v, causal=False)
    elif qseq is None:
        out = _attend_cache(q, k, v, None, seq, tp if every else None)
    else:
        q = seq_gather(q, qseq, 1, "sp_cross_q")
        out = combine_blocks(*decode_partials(q, k, v), seq, tag="sp_cross")
        out = out.narrow(1, qseq.index * S, S).to(v.dtype).reshape(
            B, S, H * hd)
    return tp_exit(out @ _weight(p, "wo", sp).to(x.dtype), sp, whole)


def cross_kv(p, enc_out: torch.Tensor, cfg, heads: int | None = None,
             seq=None):
    """The cross K/V of ``enc_out``, each (B, F, Hkv, hd): every KV head,
    or under a heads split this rank's (the KV groups of its query heads,
    from the replicated ``wk``/``wv``); ``heads=cfg.n_kv_heads`` asks for
    every head.  ``seq`` is the split of which ``enc_out`` is a block of
    the frames in a prefill or a train step: where the heads are split
    over its axis (``model_parallel.seq_tp``) the blocks are gathered
    over the model group (``tp_enter``) and, where other axes cut the
    frames too (context parallelism), the K/V of that super-block are
    gathered over them (tag ``sp_cross_kv``): the K/V are of every
    frame.  Where the ranks of
    the heads' split hold different frames or tokens, nothing is copied
    to the group: each rank's gradient of ``wk``/``wv`` is its heads'
    share, which the step sums.  -> ((k, v), the split of the frames the
    K/V are a block of: ``seq``, or None where they are of every
    frame), the pair and the split :func:`_cross_attention` takes."""
    B = enc_out.shape[0]
    hd = cfg.resolved_head_dim
    tp = None if heads == cfg.n_kv_heads else heads_split(p, cfg)
    sp, kv0, Hkv = (None, 0, cfg.n_kv_heads) if tp is None else tp
    whole = seq_tp(sp, seq)
    differ = whole is not None or seq_tp(sp, prompt_split(enc_out)) \
        is not None
    cp = None if differ else sp

    def w(key):
        return copy_to(_full(p, key), cp)[..., kv0 * hd:(kv0 + Hkv) * hd] \
            .to(enc_out.dtype)

    x = tp_enter(enc_out, cp, whole)
    F = x.shape[1]
    k, v = (x @ w("wk")).reshape(B, F, Hkv, hd), \
        (x @ w("wv")).reshape(B, F, Hkv, hd)
    if whole is not None and whole.outer is not None:
        # a super-block of the frames: every super-block's K/V of this
        # rank's heads, gathered over the other axes
        kv = seq_gather(torch.stack([k, v]), whole.outer, 2, "sp_cross_kv")
        k, v = kv[0], kv[1]
    return (k, v), None if whole is not None else seq


def encode(params, cfg: ModelConfig, frames: torch.Tensor,
           remat: str = "dots") -> torch.Tensor:
    """frames: (B, F, d_model) stub embeddings -> encoder states.  Inside
    a ``rows_scope`` of frames cut on their sequence, ``frames`` is this
    rank's block and so are the states."""
    B, F, d = frames.shape
    rows = DB.current_rows()
    start = 0 if rows is None else rows.seq_start(F)
    pos = torch.as_tensor(sinusoids(F, d, start), device=frames.device).to(
        frames.dtype)
    x = frames + pos[None]
    positions = sequence_positions(cfg, B, F, frames.device)

    def body(p, h):
        a, _ = attention(p["attn"], rms_norm(h, p["ln_attn"], cfg.norm_eps),
                         cfg, positions, causal=False)
        h = h + a
        return h + mlp(p["mlp"], rms_norm(h, p["ln_mlp"], cfg.norm_eps),
                       cfg.act)

    fn = _remat(body, remat)
    for p in params["enc_layers"]:
        x = fn(p, x)
    return rms_norm(x, params["ln_enc"], cfg.norm_eps)


def decode_train(params, cfg: ModelConfig, enc_out: torch.Tensor, tokens,
                 remat: str = "dots", enc_seq=None) -> torch.Tensor:
    """The decoder's final hidden states (B, S, d) over ``enc_out``.
    Inside a ``rows_scope`` of tokens cut on their sequence, ``tokens``
    is this rank's block; ``enc_seq`` is the split of which ``enc_out``
    is a block of the frames (None: every frame)."""
    B, S = tokens.shape
    rows = DB.current_rows()
    start = 0 if rows is None else rows.seq_start(S)
    x = embed(params, tokens)
    x = x + params["pos_dec"][start:start + S][None].to(x.dtype)
    positions = sequence_positions(cfg, B, S, x.device)

    def body(p, h):
        a, _ = attention(p["self_attn"],
                         rms_norm(h, p["ln_self"], cfg.norm_eps), cfg,
                         positions, causal=True)
        h = h + a
        ca = p["cross_attn"]
        kv, frames = cross_kv(ca, enc_out, cfg, seq=enc_seq)
        h = h + _cross_attention(ca, rms_norm(h, p["ln_cross"], cfg.norm_eps),
                                 kv, cfg, frames)
        return h + mlp(p["mlp"], rms_norm(h, p["ln_mlp"], cfg.norm_eps),
                       cfg.act)

    fn = _remat(body, remat)
    for p in params["dec_layers"]:
        x = fn(p, x)
    return rms_norm(x, params["ln_f"], cfg.norm_eps)


def _refuse_mixed_split(params, enc_seq, seq) -> None:
    """Training where only one of the frames and the tokens is cut in a
    way the encoder's backward cannot take: the frames cut and the tokens
    whole, or the tokens cut over the model axis and the frames not while
    an encoder weight is split over that axis."""
    if enc_seq is not None and seq is None:
        raise NotImplementedError(
            f"training on frames cut over {enc_seq.axes} with the "
            f"decoder's tokens whole (a sequence the split does not "
            f"divide): {DB.ITEM_21} is not ported")
    if seq is None or MODEL not in seq.axes or \
            (enc_seq is not None and MODEL in enc_seq.axes) or \
            not isinstance(params, torch.nn.Module):
        return
    split = sorted(n for n, pl in placements(params).items()
                   if n.startswith("enc_layers.") and MODEL in pl.spec)
    if split:
        raise NotImplementedError(
            f"training on tokens cut over {seq.axes} with the frames not "
            f"cut over the model axis (a count the split does not divide) "
            f"and {split[0]} (and {len(split) - 1} more) tensor-parallel "
            f"over it: {DB.ITEM_21} is not ported")


def placed_hidden(params, cfg: ModelConfig, batch: dict,
                  remat: str = "dots", head=None):
    """The decoder's final hidden states of a batch whose leaves may be
    placed (DTensors of this rank's rows, and of its block of the frames
    and the tokens under the ``"seq"`` rule): the encoder runs inside the
    frames' rows scope, the decoder inside the tokens', and ``head(hidden)``
    (when given) inside it too -> (hidden or head's result, the split of
    the tokens' sequence or None).  A plain batch is whole, or the block
    of an enclosing scope's split."""
    frames, tokens = batch["frames"], batch["tokens"]
    with DB.rows_scope(tokens):
        seq = DB.current_seq()
    with DB.rows_scope(frames):
        enc_seq = DB.current_seq()
        if torch.is_grad_enabled():
            _refuse_mixed_split(params, enc_seq, seq)
        enc = encode(params, cfg, DB.to_local(frames), remat=remat)
    with DB.rows_scope(tokens):
        out = decode_train(params, cfg, enc, DB.to_local(tokens),
                           remat=remat, enc_seq=enc_seq)
        if head is not None:
            out = head(out)
    return out, seq


def lm_loss(params, cfg: ModelConfig, batch: dict, remat: str = "dots"):
    """batch: frames (B, F, d), tokens (B, S), labels (B, S) (< 0 =
    ignore).  The token NLL through the tied output embedding (over a
    vocabulary split, this rank's block of the logits); no z-loss and no
    aux loss.  Returns (loss, metrics).  On a placed batch it is this
    rank's rows' and blocks' loss (:func:`placed_hidden`), ``ntok`` their
    count."""
    labels = DB.to_local(batch["labels"])

    def head(hidden):
        logits, sp = vocab_logits(params, cfg, hidden)
        return _token_nll(logits.float(), labels, sp)[0]

    nll, _ = placed_hidden(params, cfg, batch, remat, head)
    valid = (labels >= 0).float()
    ntok = torch.clamp(valid.sum(), min=1.0)
    loss = (nll * valid).sum() / ntok
    return loss, {"loss": loss, "ntok": ntok}


# ---------------------------------------------------------------------------
# serving: decode one token against precomputed cross-KV
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, B: int, n_frames: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Cross K/V (L, B, n_frames, Hkv, hd), self K/V (L, B,
    decoder_max_len, Hkv, hd) and an int32 ``index`` a layer, zero, on
    ``device`` (default CUDA).  Under a sharding context each leaf is this
    rank's block by ``cache_specs`` (the requests over the data axes, the
    frames and the decoder positions over ``kv_seq``'s axes where they
    divide), allocated as such."""
    mesh = current_mesh()
    if mesh is None:
        return _init_cache(cfg, B, n_frames, dtype, device)
    return local_cache(_init_cache(cfg, B, n_frames, dtype, "meta"), mesh,
                       current_rules(), device=resolve_device(device))


def _init_cache(cfg: ModelConfig, B: int, n_frames: int, dtype,
                device) -> dict:
    dev = resolve_device(device)
    hd, L = cfg.resolved_head_dim, cfg.n_layers

    def zeros(n):
        return torch.zeros((L, B, n, cfg.n_kv_heads, hd), dtype=dtype,
                           device=dev)

    return {"cross_k": zeros(n_frames), "cross_v": zeros(n_frames),
            "self_k": zeros(cfg.decoder_max_len),
            "self_v": zeros(cfg.decoder_max_len),
            "index": torch.zeros((L,), dtype=torch.int32, device=dev)}


def prefill_cross(params, cfg: ModelConfig, enc_out: torch.Tensor,
                  cache: dict) -> dict:
    """The cache with each decoder layer's cross K/V of ``enc_out`` (in
    the cache's dtype), as many KV heads as the cache holds.  On a cache
    made under a sharding context ``enc_out`` is the whole batch's, and
    the cross K/V are those of this rank's rows and block of the
    frames."""
    mine, _ = decode_batch(cache, enc_out.shape[0])
    enc_out = enc_out[mine]
    seq = cache_split(cache, ("cross_k",), 2)
    if seq is not None:
        enc_out = enc_out.narrow(1, *seq.block(enc_out.shape[1]))
    heads = cache["cross_k"].shape[3]
    ks, vs = zip(*(cross_kv(p["cross_attn"], enc_out, cfg, heads)[0]
                   for p in params["dec_layers"]))
    out = cache.copy()
    out.update(cross_k=torch.stack(ks).to(cache["cross_k"].dtype),
               cross_v=torch.stack(vs).to(cache["cross_v"].dtype))
    return out


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, tokens, cache: dict):
    """tokens (B, S) -> (float32 logits (B, S, V), cache); the cross K/V
    must be prefilled.  The decoder position ``index`` is clamped to the
    last of ``decoder_max_len`` rows, as the reference's
    ``dynamic_slice_in_dim`` clamps; the self cache is written in place.
    On a cache made under a sharding context ``tokens`` is the whole
    batch and the step runs this rank's rows of it (the logits are
    theirs), as the decoder LM's ``decode_step`` does."""
    mine, scope = decode_batch(cache, tokens.shape[0])
    tokens = tokens[mine]
    B, S = tokens.shape
    idx = cache["index"][0]
    self_seq = cache_split(cache, ("self_k",), 2)
    cross_seq = cache_split(cache, ("cross_k",), 2)
    x = embed(params, tokens)
    row = torch.clamp(idx, 0, params["pos_dec"].shape[0] - 1).long()
    x = x + params["pos_dec"].index_select(0, row.reshape(1))[None].to(
        x.dtype)
    positions = default_positions(cfg, B, S, x.device, start=idx)
    with scope:
        for i, p in enumerate(params["dec_layers"]):
            a, new_kv = attention(
                p["self_attn"], rms_norm(x, p["ln_self"], cfg.norm_eps), cfg,
                positions, cache=_with_seq({"k": cache["self_k"][i],
                                            "v": cache["self_v"][i],
                                            "index": cache["index"][i]},
                                           self_seq))
            x = x + a
            x = x + _cross_attention(
                p["cross_attn"], rms_norm(x, p["ln_cross"], cfg.norm_eps),
                (cache["cross_k"][i], cache["cross_v"][i]), cfg, cross_seq)
            x = x + mlp(p["mlp"], rms_norm(x, p["ln_mlp"], cfg.norm_eps),
                        cfg.act)
            cache["index"][i] = new_kv["index"]
    hidden = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return logits_fn(params, cfg, hidden).float(), cache
