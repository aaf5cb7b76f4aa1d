"""Transformer building blocks (port of ``repro.models.layers``).

Parameters are a tree of :class:`ParamTree` modules that reads as the
reference's nested dicts (``p["wq"]``, ``"bq" in p``), so every function
here takes the reference's arguments.  Weights keep the reference's
layout ((d_in, d_out), applied as ``x @ w``).  Attention is plain
PyTorch, as the reference's is plain ``jnp``: a matmul, a ``-1e30`` mask
and a float32 softmax cast back to the values' dtype.  So are
multi-head latent attention (``mla_attention``) and the mixture of
experts (``moe``), whose grouped capacity dispatch runs as index
scatters and gathers where the reference multiplies dense one-hots.

On a model sharded by :func:`repro_torch.distributed.model_parallel.
shard_model` each layer runs its tensor-parallel block where the
reference annotates ``shard(...)``: attention and MLA over this rank's
heads (``wq``/``w_u*`` column-parallel, ``wo`` row-parallel; ``wk``/``wv``
replicated, each rank using the KV groups of its own query heads), the
MLP's ``ff`` columns, and the MoE's experts (each rank runs its experts
on every token of its rows; the row-parallel sum adds their outputs).
``p[key]`` is the parameter as the layer uses it (FSDP shards gathered),
``p.full(key)`` the whole of it; a layer whose split does not fall on
head boundaries runs on the whole weights, replicated.

In decode, a cache cut on its sequence (the reference's ``kv_seq`` rule,
where GSPMD splits the softmax and the PV product into partial sums over
the split) runs context-parallel: each rank writes the new rows that fall
in its block of the positions (:func:`block_rows`, :func:`write_rows`),
computes its block's max, sum of exponentials and exp-weighted values in
float32, and the blocks are merged by the log-sum-exp rule after one
all-gather over the split's group (:func:`combine_blocks`).

In a prefill or a train step whose sequence is cut (the reference's
``"seq"`` rule, ``distributed.batch.Rows.seq``) each rank runs its block
of the positions: attention all-gathers the block's keys and values over
the split's group and attends its queries over the whole sequence under
the causal mask offset to the block's first position (GSPMD's program for
queries cut on the sequence against whole keys), MLA gathers the block's
latents and rope keys the same way, and the vocabulary-parallel embedding
looks up the group's tokens and reduce-scatters the rows back to their
blocks.  The layers then take the whole sequence's positions
(:func:`block_positions` gives the block's).  Where the model axis that
cuts the sequence also splits a layer's heads or ``ff`` columns
(Megatron-LM's sequence parallelism, ``model_parallel.seq_tp``), the
layer gathers its input block over the model group (``tp_enter``), runs
its heads or columns over the gathered rows and reduce-scatters its
row-parallel output back to the block (``tp_exit``).  Over the model
axis alone the gathered rows are the whole sequences (attention causal
from position 0).  Over the model axis and others (context parallelism,
``{"seq": ("data", "model")}``) they are the model group's super-block
of the sequence, and what crosses super-blocks goes over the other axes
(``SeqTP.outer``): attention gathers its heads' keys and values there
and attends causally from the super-block's first position, MLA gathers
its latents there.  The MoE gathers the sequence's tokens in any case,
so that each rank routes whole sequences in the reference's dispatch
groups; where the experts are split over the model axis their (and the
shared experts') partial sums are cut to the super-block and
reduce-scattered back to the block over the model group.  Each exchange
is differentiable (``model_parallel.seq_gather`` / ``seq_scatter``):
every rank computes only its own block's share (or its heads' share)
from a gathered tensor, so the backward sums the gradients over the
group (a reduce-scatter; an all-gather for a reduce-scatter).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..distributed import batch as DB
from ..distributed.collectives import all_gather, reduce_sum
from ..distributed.model_parallel import (MODEL, copy_to, fsdp_view,
                                          full_view, gather_from,
                                          model_split, reduce_from,
                                          seq_gather, seq_scatter, seq_tp,
                                          tp_enter, tp_exit)


class ParamTree(nn.Module):
    """An ``nn.Module`` built from a nested dict of tensors: a tensor
    becomes a parameter, a dict a child ``ParamTree``, a list an
    ``nn.ModuleList`` of them.  It reads as the dict it was built from
    (``p["wq"]``, ``"bq" in p``, ``p.get``), the reference's parameter
    tree with each layer-stacked leaf split into a list of layers."""

    def __init__(self, tree: dict | None = None):
        super().__init__()
        self._placed: dict = {}        # key -> Placement (sharded leaves)
        for k, v in (tree or {}).items():
            self[k] = v

    def __setitem__(self, key: str, value) -> None:
        if isinstance(value, dict):
            value = ParamTree(value)
        elif isinstance(value, (list, tuple)):
            value = nn.ModuleList(
                v if isinstance(v, nn.Module) else ParamTree(v)
                for v in value)
        if isinstance(value, nn.Module):
            self.add_module(key, value)
        else:
            self.register_parameter(
                key, value if isinstance(value, nn.Parameter)
                else nn.Parameter(value))

    def __getitem__(self, key: str):
        if key in self._parameters:
            w = self._parameters[key]
            pl = self._placed.get(key)
            return w if pl is None else fsdp_view(w, pl)
        if key in self._modules:
            return self._modules[key]
        raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key: str, default=None):
        return self[key] if key in self else default

    def keys(self) -> list[str]:
        return list(self._parameters) + list(self._modules)

    def split(self, key: str, dim: int):
        """The model axis's split of dimension ``dim`` of parameter
        ``key`` (None when that dimension is whole on this rank)."""
        return model_split(self._placed.get(key), dim)

    def full(self, key: str) -> torch.Tensor:
        """The whole parameter (its model-axis blocks gathered too)."""
        return full_view(self._parameters[key], self._placed.get(key))


def _split(p, key: str, dim: int):
    return p.split(key, dim) if isinstance(p, ParamTree) else None


def _full(p, key: str) -> torch.Tensor:
    return p.full(key) if isinstance(p, ParamTree) else p[key]


def _weight(p, key: str, sp) -> torch.Tensor:
    """This rank's tensor-parallel block of ``key`` under a split, else
    the whole parameter."""
    return p[key] if sp is not None else _full(p, key)


def model_axis(p, *keys):
    """The model axis's split of the first of ``keys`` that has one."""
    for key in keys:
        if isinstance(p, ParamTree) and key in p._placed:
            for dim in range(len(p._placed[key].shape)):
                sp = p.split(key, dim)
                if sp is not None:
                    return sp
    return None


def as_generator(generator, device=None) -> torch.Generator:
    """A ``torch.Generator`` as given, or one seeded with an int on
    ``device`` (every draw of an init runs on the parameters' device)."""
    if isinstance(generator, (torch.Generator, _Shapes)):
        return generator
    from ..device import resolve_device
    dev = resolve_device(device)
    if dev.type == "meta":
        return _Shapes()
    g = torch.Generator(device=dev)
    g.manual_seed(int(generator))
    return g


class _Shapes:
    """The generator of an init on the ``meta`` device: shapes only (a
    published-size tree for the spec functions, nothing allocated)."""
    device = torch.device("meta")


def _init(generator: torch.Generator, shape, scale=None,
          dtype=torch.float32) -> torch.Tensor:
    if isinstance(generator, _Shapes):
        return torch.empty(shape, dtype=dtype, device="meta")
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return (torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32) * scale).to(dtype)


def _zeros(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.zeros(shape, device=generator.device)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm scaling by ``1 + weight`` (weights start at zero), in
    float32, cast back to ``x.dtype``."""
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * (1.0 + weight.float())).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / theta ** (np.arange(0, head_dim, 2) / head_dim)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of x (B, S, H, hd) by angles (B, S, hd/2)."""
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd), positions: (B, S) -> rotated (half-split layout)."""
    freqs = torch.as_tensor(rope_freqs(x.shape[-1], theta),
                            dtype=torch.float32, device=x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl §3): positions (3, B, S) for (t, h, w);
    the frequency bands are split across the three position streams."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32,
                            device=x.device)
    sec = np.cumsum((0,) + tuple(sections))
    if sec[-1] != hd // 2:
        raise ValueError(f"mrope sections {sections} must sum to "
                         f"head_dim / 2 = {hd // 2}")
    ang = torch.cat([positions[i][..., None].float()
                     * freqs[sec[i]:sec[i + 1]] for i in range(3)], dim=-1)
    return _rotate(x, ang)


# ---------------------------------------------------------------------------
# attention (GQA with optional bias / qk-norm / cache)
# ---------------------------------------------------------------------------

def init_attention(generator: torch.Generator, cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": _init(generator, (d, cfg.n_heads * hd)),
        "wk": _init(generator, (d, cfg.n_kv_heads * hd)),
        "wv": _init(generator, (d, cfg.n_kv_heads * hd)),
        "wo": _init(generator, (cfg.n_heads * hd, d)),
    }
    if cfg.attn_bias:
        p["bq"] = _zeros(generator, (cfg.n_heads * hd,))
        p["bk"] = _zeros(generator, (cfg.n_kv_heads * hd,))
        p["bv"] = _zeros(generator, (cfg.n_kv_heads * hd,))
    if cfg.qk_norm:
        p["q_norm"] = _zeros(generator, (hd,))
        p["k_norm"] = _zeros(generator, (hd,))
    return p


def heads_split(p, cfg):
    """The model split of an attention layer's query heads, when ``wq``'s
    columns and ``wo``'s rows are split on head boundaries and each rank's
    heads read whole KV groups (or share one): -> (split, first KV head,
    KV heads a rank), else None."""
    sp = _split(p, "wq", 1)
    if sp is None or _split(p, "wo", 0) is None:
        return None
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    if H % sp.size:
        return None
    Hl, g = H // sp.size, H // Hkv
    if Hl % g and g % Hl:
        return None
    return sp, sp.index * Hl // g, max(1, Hl // g)


def _project_qkv(p, x: torch.Tensor, cfg, positions: torch.Tensor,
                 tp=None, every_kv: bool = False, whole=None):
    """q of this rank's heads (every head without a split), k and v of
    their KV heads, or of every KV head with ``every_kv``.  With
    ``whole`` (``model_parallel.seq_tp``'s pair) ``x`` is the model
    group's gathered rows and nothing is copied to the group: the
    gather's backward and the step's reduction sum the ranks'
    gradients."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    if tp is None:
        sp, kv0, Hkv = None, 0, cfg.n_kv_heads
        H = cfg.n_heads
    else:
        sp, kv0, Hkv = tp
        H = cfg.n_heads // sp.size
        if every_kv:
            kv0, Hkv = 0, cfg.n_kv_heads
    cp = None if whole is not None else sp

    def kv(key):        # replicated; this rank reads its KV heads' columns
        w = copy_to(_full(p, key), cp)
        return w[..., kv0 * hd:(kv0 + Hkv) * hd].to(x.dtype)

    x = copy_to(x, cp)
    q = x @ _weight(p, "wq", sp).to(x.dtype)
    k = x @ kv("wk")
    v = x @ kv("wv")
    if cfg.attn_bias:
        q = q + _weight(p, "bq", sp).to(x.dtype)
        k = k + kv("bk")
        v = v + kv("bv")
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, Hkv, hd)
    v = v.reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, copy_to(_full(p, "q_norm"), cp), cfg.norm_eps)
        k = rms_norm(k, copy_to(_full(p, "k_norm"), cp), cfg.norm_eps)
    if cfg.rope_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope_type == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
          q_offset=None) -> torch.Tensor:
    """q: (B, Sq, Hq, hd), k/v: (B, Skv, Hkv, hd): grouped-query attention;
    query head h reads kv head h // (Hq / Hkv)."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    q = q.reshape(B, Sq, Hkv, Hq // Hkv, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float()
    logits = logits / math.sqrt(hd)
    if causal:
        qpos = torch.arange(Sq, device=q.device)
        if q_offset is not None:
            qpos = qpos + q_offset
        mask = qpos[:, None] >= torch.arange(Skv, device=q.device)[None, :]
        logits = logits.masked_fill(~mask[None, None, None], -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(B, Sq, Hq * hd)


def cache_rows(index: torch.Tensor, S: int, Skv: int) -> torch.Tensor:
    """The cache rows S new entries are written to at ``index``: the
    start clamped so the S rows fit, as ``lax.dynamic_update_slice``
    clamps."""
    start = torch.clamp(index, max=Skv - S).long()
    return start + torch.arange(S, device=index.device)


def block_rows(index: torch.Tensor, S: int, n: int, seq=None):
    """-> (rows, inside): the rows of this rank's cache block of n rows
    that S new entries at ``index`` go to.  Without a sequence split (seq
    None) the block is the whole cache: :func:`cache_rows`, inside None.
    Over a split, the rows are the whole cache's (clamped as on it), less
    the block's start, modulo n: S consecutive rows land on distinct rows
    of the block (n at a time), and ``inside`` (S,) marks the ones that
    fall in it."""
    if seq is None:
        return cache_rows(index, S, n), None
    rows = cache_rows(index, S, n * seq.size) - seq.index * n
    return rows % n, (rows >= 0) & (rows < n)


def write_rows(c: torch.Tensor, rows: torch.Tensor, inside,
               new: torch.Tensor) -> None:
    """Write ``new`` (B, S, ...) into the cache block ``c`` (B, n, ...)
    at :func:`block_rows`' rows, in place.  Under a split only the rows
    ``inside`` the block change: the others rewrite the row they land on
    with its own value, n rows at a time so that no two rows of a write
    meet."""
    new = new.to(c.dtype)
    if inside is None:
        c.index_copy_(1, rows, new)
        return
    n = c.shape[1]
    for j in range(0, rows.shape[0], n):
        r, v = rows[j:j + n], new[:, j:j + n]
        m = inside[j:j + n].view((1, -1) + (1,) * (v.ndim - 2))
        c.index_copy_(1, r, torch.where(m, v, c.index_select(1, r)))


def valid_rows(index: torch.Tensor, S: int, n: int, seq=None):
    """(n,) True where this rank's cache block holds a position below
    ``index + S`` (global positions)."""
    pos = torch.arange(n, device=index.device)
    if seq is not None:
        pos = pos + seq.index * n
    return pos < (index + S)


def every_head(tp, seq) -> bool:
    """True when the cache's sequence is split over the model axis that
    also splits the query heads: each rank then attends with every head
    over its block of the sequence."""
    return tp is not None and seq is not None and MODEL in seq.axes


def _partials(logits: torch.Tensor, values, dtype):
    """One block's share of a softmax-weighted sum: from float32
    ``logits`` (..., k), the block's max m and sum of exponentials s, and
    the exp-weighted sum ``values(e)``, its weights cast to ``dtype`` as
    the reference casts its softmax -> (o, m, s) in float32.  A block
    with no valid position (every logit -1e30) gets m = -1e30, which
    :func:`merge_partials` weighs by zero."""
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m)
    return values(e.to(dtype)).float(), m[..., 0], e.sum(-1)


def merge_partials(parts: torch.Tensor) -> torch.Tensor:
    """Blocks' partials (P, ..., D + 2) (each the exp-weighted sum, the
    max and the sum of exponentials of one block) -> the softmax-weighted
    sum over every block (..., D), float32, by the log-sum-exp rule."""
    o, m, s = parts[..., :-2], parts[..., -2], parts[..., -1]
    w = torch.exp(m - m.amax(0))
    return (o * w[..., None]).sum(0) / (s * w).sum(0)[..., None]


def pack_partials(o, m, s) -> torch.Tensor:
    """A block's (o, m, s) as one (..., D + 2) tensor."""
    return torch.cat([o, m[..., None], s[..., None]], dim=-1)


def combine_blocks(o, m, s, seq, tag: str = "cp_combine") -> torch.Tensor:
    """This rank's partials merged with the other blocks' of the sequence
    group (one all-gather of the packed triples; its backward sums the
    merged result's gradients over the group, whose ranks each keep their
    own rows of it)."""
    return merge_partials(seq_gather(pack_partials(o, m, s)[None], seq, 0,
                                     tag))


def prompt_split(x: torch.Tensor):
    """The :class:`~repro_torch.distributed.model_parallel.Split` of the
    sequence of which ``x`` (B, S, ...) is this rank's block
    (``distributed.batch.current_seq``), None when the sequence is
    whole."""
    return DB.current_seq()


def block_positions(positions: torch.Tensor, S: int, seq) -> torch.Tensor:
    """This rank's block of S positions of the whole sequence's
    ``positions`` (B, S·P) or M-RoPE's (3, B, S·P), which the layers take
    under a sequence split; ``positions`` itself when the sequence is
    whole."""
    if seq is None:
        return positions
    return positions.narrow(-1, seq.index * S, S)


def halo_rows(x: torch.Tensor, n: int, seq, tag: str) -> torch.Tensor:
    """The n rows of the sequence just before this rank's block ``x``
    (B, S, ...): the earlier blocks' last rows, from one all-gather of
    each block's tail over the split's group, zeros before the sequence's
    start.  Every rank takes its rows by the same operations (only the
    offset differs), so every rank's backward reaches the gather."""
    t = min(n, x.shape[1])
    tails = seq_gather(x[:, x.shape[1] - t:], seq, 1, tag)
    prev = torch.cat([tails.new_zeros((x.shape[0], n) + tuple(x.shape[2:])),
                      tails], dim=1)
    end = n + seq.index * t
    return prev[:, end - n:end]


def attention(p, x: torch.Tensor, cfg, positions: torch.Tensor,
              causal: bool = True, cache=None):
    """Returns (out, new_cache).  cache = dict(k, v, index) for decode: the
    new keys and values are written into ``cache["k"]`` / ``cache["v"]``
    in place at ``index`` (clamped so the S new rows fit, as
    ``lax.dynamic_update_slice`` clamps), and every cache position below
    ``index + S`` is attended to: there is no causal mask among the S new
    tokens, as in the reference (decoding feeds S = 1).  Under a heads
    split the cache holds this rank's KV heads (or all of them, of which
    it writes and reads its own).

    With ``cache["seq"]``, the :class:`~repro_torch.distributed.
    model_parallel.Split` of a cache cut on its sequence (context
    parallelism), the cache is this rank's block of the positions: the
    rank writes the new rows that fall in it, attends over it, and the
    blocks' partial softmax sums are combined over the split's group
    (:func:`combine_blocks`).  Where the model axis splits both the
    sequence and the query heads, each rank projects every KV head,
    gathers every query head, attends with all of them and keeps its own
    heads' output for its rows of ``wo``.

    Without a cache, under a sequence split (``positions`` the whole
    sequence's) each rank attends its block's queries over the gathered
    keys and values (:func:`_prefill_attend`), or, where the heads are
    split over an axis that cuts the sequence, its heads over the model
    group's gathered rows (the whole sequence, or under context
    parallelism its super-block, whose keys and values are gathered over
    the other axes), the output reduce-scattered back to the block."""
    B, S, _ = x.shape
    tp = heads_split(p, cfg)
    sp = None if tp is None else tp[0]
    if cache is None:
        prompt = prompt_split(x)
        whole = seq_tp(sp, prompt)
        if whole is not None:       # this rank's heads over its super-block
            x = tp_enter(x, sp, whole)
            q, k, v = _project_qkv(p, x, cfg, block_positions(
                positions, x.shape[1], whole.outer), tp, whole=whole)
            out = _prefill_attend(q, k, v, causal, whole.outer)
        else:
            q, k, v = _project_qkv(p, x, cfg, block_positions(
                positions, S, prompt), tp)
            out = _prefill_attend(q, k, v, causal, prompt)
        return tp_exit(out @ _weight(p, "wo", sp).to(x.dtype), sp, whole), \
            None
    seq = cache.get("seq")
    every = every_head(tp, seq)
    q, k, v = _project_qkv(p, x, cfg, positions, tp, every)
    idx = cache["index"]
    ck, cv = cache["k"], cache["v"]
    if tp is not None and not every and ck.shape[2] != k.shape[2]:
        ck, cv = (c.narrow(2, tp[1], tp[2]) for c in (ck, cv))
    n = ck.shape[1]
    rows, inside = block_rows(idx, S, n, seq)
    write_rows(ck, rows, inside, k)
    write_rows(cv, rows, inside, v)
    new_cache = {"k": cache["k"], "v": cache["v"], "index": idx + S}
    valid = valid_rows(idx, S, n, seq)
    out = _attend_cache(q, ck, cv, valid, seq, tp if every else None)
    return reduce_from(out @ _weight(p, "wo", sp).to(x.dtype), sp), \
        new_cache


def _prefill_attend(q, k, v, causal: bool, seq) -> torch.Tensor:
    """Attention of a prompt's block: under a sequence split the block's
    keys and values are all-gathered over the split's group (one packed
    all-gather) and its queries attend over the whole prompt, causally
    from the block's first position."""
    if seq is None:
        return _sdpa(q, k, v, causal)
    kv = seq_gather(torch.stack([k, v]), seq, 2, "sp_kv")
    return _sdpa(q, kv[0], kv[1], causal, q_offset=seq.index * q.shape[1])


def _attend_cache(q, k, v, valid, seq, gather=None) -> torch.Tensor:
    """Decode attention of q over a cache (whole, or this rank's block of
    its sequence under ``seq``); ``gather``, a heads split, gathers every
    query head first and keeps this rank's heads of the output."""
    if seq is None:
        return _sdpa_decode(q, k, v, valid)
    if gather is not None:
        q = gather_from(q, gather[0], dim=2, tag="cp_heads")
    out = combine_blocks(*decode_partials(q, k, v, valid), seq)
    B, Sq, Hq, hd = q.shape
    out = out.to(v.dtype).reshape(B, Sq, Hq * hd)
    if gather is not None:
        sp = gather[0]
        w = Hq // sp.size * hd
        out = out.narrow(-1, sp.index * w, w)
    return out


def decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid=None):
    """One block's partials of :func:`_sdpa_decode`: q (B, Sq, Hq, hd)
    against k/v (B, n, Hkv, hd) with ``valid`` (n,) or None (every
    position) -> (o (B, Sq, Hq, hd), m, s (B, Sq, Hq)), float32."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    q = q.reshape(B, Sq, Hkv, Hq // Hkv, hd)
    logits = torch.einsum("bqhgd,bkhd->bqhgk", q, k.to(q.dtype))
    logits = logits.float() / math.sqrt(hd)
    if valid is not None:
        logits = logits.masked_fill(~valid, -1e30)
    o, m, s = _partials(logits, lambda e: torch.einsum(
        "bqhgk,bkhd->bqhgd", e, v.to(e.dtype)), v.dtype)
    return o.reshape(B, Sq, Hq, hd), m.reshape(B, Sq, Hq), \
        s.reshape(B, Sq, Hq)


def _sdpa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid_mask: torch.Tensor) -> torch.Tensor:
    """Decode attention against a full cache with a validity mask."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    q = q.reshape(B, Sq, Hkv, Hq // Hkv, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q, k.to(q.dtype))
    logits = logits.float() / math.sqrt(hd)
    logits = logits.masked_fill(~valid_mask[None, None, None, None, :],
                                -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.to(q.dtype))
    return out.reshape(B, Sq, Hq * hd)


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (deepseek-v2)
# ---------------------------------------------------------------------------

def init_mla(generator: torch.Generator, cfg) -> dict:
    d = cfg.d_model
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    H = cfg.n_heads
    p = {
        "w_dkv": _init(generator, (d, r)),            # latent compression
        "w_krope": _init(generator, (d, dr)),          # shared rope key
        "kv_norm": _zeros(generator, (r,)),
        "w_uk": _init(generator, (r, H * dn)),         # latent -> keys
        "w_uv": _init(generator, (r, H * dv)),         # latent -> values
        "wo": _init(generator, (H * dv, d)),
    }
    if qr:
        p["w_dq"] = _init(generator, (d, qr))
        p["q_norm"] = _zeros(generator, (qr,))
        p["w_uq"] = _init(generator, (qr, H * (dn + dr)))
    else:
        p["wq"] = _init(generator, (d, H * (dn + dr)))
    return p


def mla_attention(p, x: torch.Tensor, cfg, positions: torch.Tensor,
                  causal: bool = True, cache=None):
    """MLA: queries and keys split into a no-rope part and a rope part
    whose key is one head shared by all heads; the scale is
    1/sqrt(dn + dr).  The cache holds only the RMS-normed rank-r latent
    ``c_kv`` and the rope key ``k_rope``, written in place at ``index``
    as :func:`attention` writes its cache.  Returns (out, new_cache).
    Under a heads split (``w_u*``, ``wq`` and ``wo`` split by heads) the
    latent and the rope key are computed whole and every rank runs its
    heads on them; the cache is the whole latent on every rank, or its
    block of the positions under ``cache["seq"]`` (:func:`_mla_blocks`).

    Without a cache, under a sequence split (``positions`` the whole
    sequence's) each rank's block gathers the group's normed latents and
    rope keys (one packed all-gather, tag ``sp_latent``), up-projects
    them to its heads' keys and values and attends its queries causally
    from the block's first position; where the heads are split over an
    axis that cuts the sequence, each rank gathers the model group's rows
    (``model_parallel.tp_enter``), computes the latents, rope keys and
    its heads over them, attends from the rows' first position (under
    context parallelism the super-block's, the latents gathered over the
    other axes) and reduce-scatters its ``wo`` partial sum back to the
    block.  ``w_dkv``, ``w_krope``,
    ``kv_norm``, ``w_dq`` and ``q_norm`` are read whole there, each
    rank's gradient its heads' share.
    """
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    r = cfg.kv_lora_rank
    qkey = "w_uq" if cfg.q_lora_rank else "wq"
    sp = _split(p, "w_uk", 1)
    if sp is not None and (H % sp.size or _split(p, "w_uv", 1) is None
                           or _split(p, qkey, 1) is None
                           or _split(p, "wo", 0) is None):
        sp = None
    prompt = prompt_split(x) if cache is None else None
    whole = seq_tp(sp, prompt)
    if whole is not None:           # the rows of the model group's blocks
        x, prompt = tp_enter(x, sp, whole), whole.outer
    positions = block_positions(positions, x.shape[1], prompt)
    cp = None if whole is not None else sp     # copied to the heads split
    B, S, _ = x.shape
    Hl = H if sp is None else H // sp.size
    if cfg.q_lora_rank:
        q = rms_norm(x @ _full(p, "w_dq").to(x.dtype), _full(p, "q_norm"),
                     cfg.norm_eps)
        q = copy_to(q, cp) @ _weight(p, "w_uq", sp).to(x.dtype)
    else:
        q = copy_to(x, cp) @ _weight(p, "wq", sp).to(x.dtype)
    q = q.reshape(B, S, Hl, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv = rms_norm(x @ _full(p, "w_dkv").to(x.dtype), _full(p, "kv_norm"),
                    cfg.norm_eps)
    k_rope = x @ _full(p, "w_krope").to(x.dtype)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    if cache is not None and cache.get("seq") is not None:
        return _mla_blocks(p, x, cfg, q_nope, q_rope, c_kv, k_rope, cache,
                           sp)

    new_cache = valid = None
    q0 = 0                          # the queries' first position
    if cache is not None:
        idx = cache["index"]
        cc, cr = cache["c_kv"], cache["k_rope"]
        rows = cache_rows(idx, S, cc.shape[1])
        cc.index_copy_(1, rows, c_kv.to(cc.dtype))
        cr.index_copy_(1, rows, k_rope.to(cr.dtype))
        new_cache = {"c_kv": cc, "k_rope": cr, "index": idx + S}
        c_kv, k_rope = cc.to(x.dtype), cr.to(x.dtype)
        valid = torch.arange(cc.shape[1], device=x.device) < (idx + S)
    elif prompt is not None:        # the group's latents and rope keys
        lat = seq_gather(torch.cat([c_kv, k_rope], dim=-1), prompt, 1,
                         "sp_latent")
        c_kv, k_rope, q0 = lat[..., :r], lat[..., r:], prompt.index * S

    c_kv, k_rope = copy_to(c_kv, cp), copy_to(k_rope, cp)
    k_nope = (c_kv @ _weight(p, "w_uk", sp).to(x.dtype)).reshape(
        B, -1, Hl, dn)
    v = (c_kv @ _weight(p, "w_uv", sp).to(x.dtype)).reshape(B, -1, Hl, dv)
    scale = 1.0 / math.sqrt(dn + dr)
    logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
              + torch.einsum("bqhd,bkd->bhqk", q_rope, k_rope)
              ).float() * scale
    Skv = logits.shape[-1]
    if valid is not None:
        logits = logits.masked_fill(~valid[None, None, None, :], -1e30)
    elif causal:
        mask = q0 + torch.arange(S, device=x.device)[:, None] >= \
            torch.arange(Skv, device=x.device)[None, :]
        logits = logits.masked_fill(~mask[None, None], -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, S, Hl * dv)
    return tp_exit(out @ _weight(p, "wo", sp).to(x.dtype), sp, whole), \
        new_cache


def _mla_blocks(p, x, cfg, q_nope, q_rope, c_kv, k_rope, cache, sp):
    """MLA decode over this rank's block of a cache cut on its sequence
    (``cache["seq"]``), with ``w_uk`` absorbed into the queries and
    ``w_uv`` applied after the blocks are combined: each rank scores its
    block's latents ``c_kv`` directly, and the sequence group exchanges
    latent-width partials (rank + 2 floats a head), never the
    up-projected keys and values or the ``w_u*`` weights.  Where the model
    axis splits both the sequence and the heads, the absorbed queries of
    every head are gathered and each rank keeps its heads' latents for
    its ``w_uv`` and ``wo`` blocks."""
    B, S, Hl, dn = q_nope.shape
    r, dv = cfg.kv_lora_rank, cfg.v_head_dim
    seq = cache["seq"]
    idx = cache["index"]
    cc, cr = cache["c_kv"], cache["k_rope"]
    n = cc.shape[1]
    rows, inside = block_rows(idx, S, n, seq)
    write_rows(cc, rows, inside, c_kv)
    write_rows(cr, rows, inside, k_rope)
    new_cache = {"c_kv": cc, "k_rope": cr, "index": idx + S}
    w_uk = _weight(p, "w_uk", sp).to(x.dtype).view(r, Hl, dn)
    qs = torch.cat([torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk), q_rope],
                   dim=-1)
    every = every_head(sp, seq)
    if every:
        qs = gather_from(qs, sp, dim=2, tag="cp_heads")
    lat = combine_blocks(*mla_partials(
        qs[..., :r], qs[..., r:], cc.to(x.dtype), cr.to(x.dtype),
        valid_rows(idx, S, n, seq), 1.0 / math.sqrt(dn + cfg.qk_rope_dim)),
        seq)
    if every:
        lat = lat.narrow(2, sp.index * Hl, Hl)
    w_uv = _weight(p, "w_uv", sp).to(x.dtype).view(r, Hl, dv)
    out = torch.einsum("bqhr,rhd->bqhd", lat.to(x.dtype), w_uv)
    return reduce_from(out.reshape(B, S, Hl * dv)
                       @ _weight(p, "wo", sp).to(x.dtype), sp), new_cache


def mla_partials(q_lat, q_rope, c_kv, k_rope, valid, scale: float):
    """One block's partials of MLA with ``w_uk`` absorbed: the latent
    queries q_lat (B, Sq, H, r) and the rope queries (B, Sq, H, dr)
    against the block's latents c_kv (B, n, r) and rope keys (B, n, dr)
    -> (o (B, Sq, H, r), m, s (B, Sq, H)), float32; o is the exp-weighted
    sum of the latents, which ``w_uv`` maps to the values."""
    logits = (torch.einsum("bqhr,bkr->bqhk", q_lat, c_kv)
              + torch.einsum("bqhd,bkd->bqhk", q_rope, k_rope)
              ).float() * scale
    if valid is not None:
        logits = logits.masked_fill(~valid, -1e30)
    return _partials(logits, lambda e: torch.einsum(
        "bqhk,bkr->bqhr", e, c_kv.to(e.dtype)), c_kv.dtype)


# ---------------------------------------------------------------------------
# MLP + MoE
# ---------------------------------------------------------------------------

def init_mlp(generator: torch.Generator, d: int, ff: int, act: str) -> dict:
    p = {"w_up": _init(generator, (d, ff)), "w_down": _init(generator, (ff, d))}
    if act in ("silu", "gelu"):
        p["w_gate"] = _init(generator, (d, ff))
    return p


def _mlp_partial(p, x: torch.Tensor, act: str, gathered=None):
    """-> (this rank's partial output, its model split, the sequence
    split its input was gathered over or None): column-parallel
    ``w_up``/``w_gate`` and row-parallel ``w_down`` under an ``ff`` split
    (the output still to be summed over the split), else the whole MLP
    and None.  Under an ``ff`` split over the axis that cuts the sequence
    the input block is gathered over the group first
    (``model_parallel.tp_enter``); ``gathered``, a sequence split, says
    that ``x`` is already the group's whole sequences over it."""
    sp = _split(p, "w_up", 1)
    if sp is not None and _split(p, "w_down", 0) is None:
        sp = None
    if gathered is None:
        whole = seq_tp(sp, DB.current_seq())
        x = tp_enter(x, sp, whole)
    else:
        whole = seq_tp(sp, gathered)
        x = x if whole is not None else copy_to(x, sp)
    up = x @ _weight(p, "w_up", sp).to(x.dtype)
    if "w_gate" in p:
        up = act_fn(act)(x @ _weight(p, "w_gate", sp).to(x.dtype)) * up
    else:
        up = act_fn(act)(up)
    return up @ _weight(p, "w_down", sp).to(x.dtype), sp, whole


def mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    """The MLP of ``x``; under an ``ff`` split the row-parallel sum over
    the split, reduce-scattered back to this rank's block where the split
    is over the axis that cuts the sequence."""
    out, sp, whole = _mlp_partial(p, x, act)
    return tp_exit(out, sp, whole)


def init_moe(generator: torch.Generator, cfg) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    p = {
        "router": _init(generator, (d, E)),
        "w_gate": _init(generator, (E, d, ff)),
        "w_up": _init(generator, (E, d, ff)),
        "w_down": _init(generator, (E, ff, d)),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(generator, d, cfg.n_shared_experts * ff,
                               cfg.act)
    return p


def top_k(probs: torch.Tensor, k: int):
    """The k largest entries of the last axis and their indices, ties to
    the lower index (``jax.lax.top_k``'s order; ``torch.topk`` promises
    none): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_groups(cfg, T: int) -> tuple[int, int, int]:
    """(groups G, tokens a group Tg, slots an expert a group C).  Up to 4E
    tokens (decode steps, short prompts) are one dropless group, so that a
    prefill equals its decode steps; above, groups of ``moe_group_size``
    (the largest divisor of T not above it) with capacity
    ``int(capacity_factor * Tg * k / E)``."""
    E, k = cfg.n_experts, cfg.top_k
    if T <= 4 * E or cfg.capacity_factor <= 0:
        return 1, T, T
    Tg = min(cfg.moe_group_size or T, T)
    while T % Tg:                       # largest divisor <= requested
        Tg -= 1
    return T // Tg, Tg, max(1, int(cfg.capacity_factor * Tg * k / E))


@dataclasses.dataclass(frozen=True)
class Dispatch:
    """A rank's view of the dispatch groups of the global batch: the
    groups its tokens touch (G; the first ``first`` in the global order,
    ``lead`` tokens of it held by lower ranks), tokens a group Tg and
    slots an expert a group C; ``lower``, the ranks of the data group
    (by rows, the group's order) that hold the rest of its first group;
    ``straddles``, whether any group of the batch holds the tokens of two
    ranks (then every rank exchanges its counts)."""
    G: int
    Tg: int
    C: int
    first: int = 0
    lead: int = 0
    lower: tuple = ()
    straddles: bool = False


def dispatch_groups(cfg, T: int, S: int, rows=None, P: int = 1) -> Dispatch:
    """The :class:`Dispatch` of this rank's T tokens (``rows.n`` rows of
    S), from the static layout alone.  Off a placed batch (``rows``
    None) it is :func:`moe_groups` of T.  On one (``rows``: the global
    row count B and this rank's first row, of the P ranks'
    ``distributed.batch.rows_of`` blocks) the groups are the reference's
    groups of the global B·S tokens: a dropless global batch is dropless
    here (one group of this rank's tokens), else every rank takes the
    global (Tg, C) over the groups its tokens [start·S, (start + n)·S)
    touch, the first and last of them maybe partial."""
    if rows is None:
        return Dispatch(*moe_groups(cfg, T))
    B = rows.B
    Tglob = B * S
    if Tglob <= 4 * cfg.n_experts or cfg.capacity_factor <= 0:
        return Dispatch(1, T, T)
    _, Tg, C = moe_groups(cfg, Tglob)
    spans = [DB.rows_of(B, P, i)[:2] for i in range(P)]
    straddles = any(start * S % Tg for start, _ in spans)
    t0, t1 = rows.start * S, rows.start * S + T
    first = t0 // Tg
    if T == 0:
        return Dispatch(0, Tg, C, first, 0, (), straddles)
    lower = tuple(i for i, (start, n) in enumerate(spans)
                  if n and start < rows.start
                  and ((start + n) * S - 1) // Tg == first)
    return Dispatch((t1 - 1) // Tg - first + 1, Tg, C, first, t0 - first * Tg,
                    lower, straddles)


def capacity_positions(onehot: torch.Tensor, disp: Dispatch,
                       rows=None) -> torch.Tensor:
    """Each (token, slot) pair's position among its expert's pairs of its
    dispatch group, in the group's flattened (token, slot) order, counted
    in float32 -> (T·k,).  ``onehot`` (T, k, E) holds this rank's pairs.
    A group whose start lower ranks hold (``disp.lead`` tokens) is padded
    at the front with pairs of no expert, the last at the back; where a
    group of the batch straddles ranks, every rank all-gathers over the
    data group (tag ``moe_pos``) the per-expert counts of its pairs in the
    last group it touches, and the first group's positions add those of
    the lower ranks that share it (``disp.lower``).  Not differentiable,
    as the reference's positions are not."""
    T, k, E = onehot.shape
    G, Tg = disp.G, disp.Tg
    tail = G * Tg - disp.lead - T
    ohf = F.pad(onehot.reshape(T * k, E), (0, 0, disp.lead * k, tail * k))
    ohf = ohf.reshape(G, Tg * k, E)
    excl = torch.cumsum(ohf, dim=1) - ohf
    if disp.straddles:
        P = dist.get_world_size(rows.group)
        me = dist.get_rank(rows.group)
        if DB.rows_of(rows.B, P, me)[:2] != (rows.start, rows.n):
            raise AssertionError(
                f"MoE dispatch: rank {me} of the data group holds rows "
                f"[{rows.start}, {rows.start + rows.n}), not its block "
                f"{DB.rows_of(rows.B, P, me)[:2]} in the group's order")
        last = ohf[-1].sum(0) if G else onehot.new_zeros(E)
        counts = all_gather(last[None], rows.group, tag="moe_pos")  # (P, E)
        if disp.lower:
            offset = counts[list(disp.lower)].sum(0)
            excl = excl + F.pad(offset[None, None], (0, 0, 0, 0, 0, G - 1))
    pos = (excl * ohf).sum(-1).reshape(-1)
    return pos[disp.lead * k:(disp.lead + T) * k]


_DROPS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_moe_drops", default=None)


@contextlib.contextmanager
def dropped_pairs():
    """Collect the (token, slot) pairs past their expert's capacity: the
    yielded list gets, for each run of a MoE layer inside the block (a
    layer recomputed in the backward runs again), the count of this
    rank's dropped pairs as a detached 0-d tensor.  The model ranks that
    route the same tokens count the same pairs; the data ranks' counts
    add up to one device's."""
    out: list = []
    token = _DROPS.set(out)
    try:
        yield out
    finally:
        _DROPS.reset(token)


def moe(p, x: torch.Tensor, cfg):
    """Top-k routed experts with the reference's grouped capacity dispatch
    (GShard-style) and Switch aux loss.  Returns (out, aux_loss).

    Each (token, slot) pair of a group takes the next free slot of its
    expert in the order of the flattened (token, slot) axis (positions
    counted in float32, as the reference counts them); a pair past the
    capacity C is dropped.  The kept pairs are scattered into an
    (E, G·C, d) slot buffer, the experts run as batched matmuls over all
    their slots (empty slots are zero rows, as the reference's), and each
    token gathers its k slots back, weighted by its normalised gates.

    Under an expert split each rank fills and runs the slots of its own
    experts (the capacity positions are counted over all experts, as on
    one device) and the row-parallel sum over the model group adds the
    ranks' outputs, the shared experts' partial sums with them.  On a
    placed batch (:func:`repro_torch.distributed.batch.current_rows`) the
    dispatch groups are the global batch's (:func:`dispatch_groups`), a
    group may hold the tokens of several data ranks, and each rank gives
    its own pairs the positions, and so the keep/drop decisions, that one
    device gives them over the whole group (:func:`capacity_positions`:
    one all-gather of per-expert counts where a group straddles ranks).
    Each rank fills only its own pairs' slots; the slots of other ranks'
    pairs stay zero rows.  The aux loss E·Σ me·ce takes ``me`` and
    ``ce`` over the global batch: their sums and the token count are
    added over the data group first (differentiably for ``ce``), as the
    reference's means over its whole batch are.

    On a batch whose sequence is cut (``distributed.batch.current_seq``)
    each rank gathers its rows' whole sequences over the split's group
    (tag ``sp_moe_in``) and routes them in the global batch's groups.
    Experts (or shared experts) split over an axis that cuts the
    sequence add their partial sums in one reduce-scatter over the model
    group back to the block (``sp_moe_out``), cut first to the group's
    super-block under context parallelism (the ranks of the other axes
    compute the same experts on the same tokens, and nothing is summed
    over them); an output every rank of the group computes whole is cut
    to the block.  The aux loss's sums are taken over the
    block's tokens and added over the data group and the sequence's."""
    B, Sb, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    seq = DB.current_seq()
    if seq is not None:
        x = seq_gather(x, seq, 1, "sp_moe_in")
    S = x.shape[1]
    T = B * S
    xt = x.reshape(T, d)
    probs = torch.softmax((xt @ _full(p, "router").to(x.dtype)).float(),
                          dim=-1)
    gate_vals, gate_idx = top_k(probs, k)                       # (T, k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    rows = DB.current_rows()
    P = 1 if rows is None or rows.group is None else \
        dist.get_world_size(rows.group)
    disp = dispatch_groups(cfg, T, S, rows, P)
    G, C = disp.G, disp.C
    onehot = F.one_hot(gate_idx, E).float()                     # (T, k, E)
    pos = capacity_positions(onehot, disp, rows)                # (T*k,)
    keep = (pos < C).reshape(T, k)
    drops = _DROPS.get()
    if drops is not None:
        drops.append((~keep).sum().detach())
    sp = _split(p, "w_gate", 0)
    if sp is not None and (E % sp.size or _split(p, "w_up", 0) is None
                           or _split(p, "w_down", 0) is None):
        sp = None
    whole = seq_tp(sp, seq)
    cp = None if whole is not None else sp     # copied to the expert split
    El = E if sp is None else E // sp.size
    e0 = 0 if sp is None else sp.index * El
    mine = (gate_idx >= e0) & (gate_idx < e0 + El)              # (T, k)
    group = ((torch.arange(T, device=x.device) + disp.lead) // disp.Tg
             ).repeat_interleave(k)                            # local group
    slot = ((gate_idx.reshape(-1) - e0).clamp(0, El - 1) * G + group) * C \
        + pos.long().clamp(max=C - 1)                           # (T*k,)
    n_slots = El * G * C
    # dropped pairs (and other ranks' experts') land in one spare row
    target = torch.where((keep & mine).reshape(-1), slot,
                         torch.full_like(slot, n_slots))
    xin = copy_to(xt, cp)
    xe = xin.new_zeros((n_slots + 1, d)).index_add(
        0, target, xin.repeat_interleave(k, dim=0))[:n_slots]
    xe = xe.reshape(El, G * C, d)
    h = act_fn(cfg.act)(torch.bmm(xe, _weight(p, "w_gate", sp).to(x.dtype))) \
        * torch.bmm(xe, _weight(p, "w_up", sp).to(x.dtype))
    ye = torch.bmm(h, _weight(p, "w_down", sp).to(x.dtype)).reshape(n_slots,
                                                                     d)
    ye = torch.cat([ye, ye.new_zeros((1, d))])
    w = (copy_to(gate_vals * keep, cp) * mine).to(x.dtype)      # (T, k)
    out = (ye[target].reshape(T, k, d) * w[..., None]).sum(1)
    terms = [(out, sp, whole)]
    if cfg.n_shared_experts:
        sh, ssp, swhole = _mlp_partial(p["shared"], x, cfg.act,
                                       gathered=seq)
        terms.append((sh.reshape(T, d), ssp, swhole))
    out = _moe_output(terms, seq, (B, S, d), Sb)
    # load-balancing aux loss (Switch-style), over the global batch
    first, pr = onehot[:, 0], probs
    if seq is not None:             # this rank's block of the tokens
        first, pr = (t.reshape(B, S, E).narrow(1, seq.index * Sb, Sb)
                     .reshape(-1, E) for t in (first, pr))
    sums = torch.stack([first.sum(0), pr.sum(0)])
    if rows is not None and rows.group is not None:
        sums = reduce_sum(sums, rows.group, tag="moe_aux")
    if seq is not None:
        sums = reduce_sum(sums, seq.group, tag="moe_aux")
    n = (B if rows is None else rows.B) * S
    me, ce = sums[0].detach() / n, sums[1] / n
    aux = E * torch.sum(me * ce) * cfg.router_aux_coef
    return out, aux


def _moe_output(terms: list, seq, shape: tuple, Sb: int) -> torch.Tensor:
    """The MoE's output (B, Sb, d) from its terms (output (T, d), model
    split, ``model_parallel.SeqTP`` or None): the terms under one model
    split summed over it together (one all-reduce); where the sequence is
    cut, the terms every rank of its group computed whole cut to this
    rank's block, and the partial sums over the model axis that cuts it
    cut to the model group's super-block and added in one reduce-scatter
    over that group back to the block."""
    whole = [t for t, sp, w in terms if sp is None]
    summed = [(t, sp) for t, sp, w in terms if sp is not None and w is None]
    parts = [t for t, sp, w in terms if w is not None]
    out = None
    if summed:
        out = reduce_from(sum(t for t, _ in summed), summed[0][1])
    if whole:
        out = sum(whole) if out is None else sum(whole) + out
    if out is not None:
        out = out.reshape(shape)
        if seq is not None:
            out = out.narrow(1, seq.index * Sb, Sb)
    if parts:
        tp = next(w for t, sp, w in terms if w is not None)
        y = sum(parts).reshape(shape)
        if tp.outer is not None:    # this rank's super-block
            n = Sb * tp.inner.size
            y = y.narrow(1, tp.outer.index * n, n)
        y = seq_scatter(y, tp.inner, 1, "sp_moe_out")
        out = y if out is None else out + y
    return out
