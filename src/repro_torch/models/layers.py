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
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class ParamTree(nn.Module):
    """An ``nn.Module`` built from a nested dict of tensors: a tensor
    becomes a parameter, a dict a child ``ParamTree``, a list an
    ``nn.ModuleList`` of them.  It reads as the dict it was built from
    (``p["wq"]``, ``"bq" in p``, ``p.get``), the reference's parameter
    tree with each layer-stacked leaf split into a list of layers."""

    def __init__(self, tree: dict | None = None):
        super().__init__()
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
            return self._parameters[key]
        if key in self._modules:
            return self._modules[key]
        raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key: str, default=None):
        return self[key] if key in self else default

    def keys(self) -> list[str]:
        return list(self._parameters) + list(self._modules)


def as_generator(generator, device=None) -> torch.Generator:
    """A ``torch.Generator`` as given, or one seeded with an int on
    ``device`` (every draw of an init runs on the parameters' device)."""
    if isinstance(generator, torch.Generator):
        return generator
    from ..device import resolve_device
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(generator))
    return g


def _init(generator: torch.Generator, shape, scale=None,
          dtype=torch.float32) -> torch.Tensor:
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


def _project_qkv(p, x: torch.Tensor, cfg, positions: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.attn_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
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


def attention(p, x: torch.Tensor, cfg, positions: torch.Tensor,
              causal: bool = True, cache=None):
    """Returns (out, new_cache).  cache = dict(k, v, index) for decode: the
    new keys and values are written into ``cache["k"]`` / ``cache["v"]``
    in place at ``index`` (clamped so the S new rows fit, as
    ``lax.dynamic_update_slice`` clamps), and every cache position below
    ``index + S`` is attended to: there is no causal mask among the S new
    tokens, as in the reference (decoding feeds S = 1)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    new_cache = None
    if cache is not None:
        idx = cache["index"]
        ck, cv = cache["k"], cache["v"]
        Skv = ck.shape[1]
        rows = cache_rows(idx, S, Skv)
        ck.index_copy_(1, rows, k.to(ck.dtype))
        cv.index_copy_(1, rows, v.to(cv.dtype))
        new_cache = {"k": ck, "v": cv, "index": idx + S}
        valid = torch.arange(Skv, device=x.device) < (idx + S)
        out = _sdpa_decode(q, ck, cv, valid)
    else:
        out = _sdpa(q, k, v, causal)
    return out @ p["wo"].to(x.dtype), new_cache


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
    as :func:`attention` writes its cache.  Returns (out, new_cache)."""
    B, S, _ = x.shape
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    if cfg.q_lora_rank:
        q = rms_norm(x @ p["w_dq"].to(x.dtype), p["q_norm"], cfg.norm_eps)
        q = q @ p["w_uq"].to(x.dtype)
    else:
        q = x @ p["wq"].to(x.dtype)
    q = q.reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv = rms_norm(x @ p["w_dkv"].to(x.dtype), p["kv_norm"], cfg.norm_eps)
    k_rope = x @ p["w_krope"].to(x.dtype)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]

    new_cache = valid = None
    if cache is not None:
        idx = cache["index"]
        cc, cr = cache["c_kv"], cache["k_rope"]
        rows = cache_rows(idx, S, cc.shape[1])
        cc.index_copy_(1, rows, c_kv.to(cc.dtype))
        cr.index_copy_(1, rows, k_rope.to(cr.dtype))
        new_cache = {"c_kv": cc, "k_rope": cr, "index": idx + S}
        c_kv, k_rope = cc.to(x.dtype), cr.to(x.dtype)
        valid = torch.arange(cc.shape[1], device=x.device) < (idx + S)

    k_nope = (c_kv @ p["w_uk"].to(x.dtype)).reshape(B, -1, H, dn)
    v = (c_kv @ p["w_uv"].to(x.dtype)).reshape(B, -1, H, dv)
    scale = 1.0 / math.sqrt(dn + dr)
    logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
              + torch.einsum("bqhd,bkd->bhqk", q_rope, k_rope)
              ).float() * scale
    Skv = logits.shape[-1]
    if valid is not None:
        logits = logits.masked_fill(~valid[None, None, None, :], -1e30)
    elif causal:
        mask = torch.arange(S, device=x.device)[:, None] >= \
            torch.arange(Skv, device=x.device)[None, :]
        logits = logits.masked_fill(~mask[None, None], -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, S, H * dv)
    return out @ p["wo"].to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# MLP + MoE
# ---------------------------------------------------------------------------

def init_mlp(generator: torch.Generator, d: int, ff: int, act: str) -> dict:
    p = {"w_up": _init(generator, (d, ff)), "w_down": _init(generator, (ff, d))}
    if act in ("silu", "gelu"):
        p["w_gate"] = _init(generator, (d, ff))
    return p


def mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    up = x @ p["w_up"].to(x.dtype)
    if "w_gate" in p:
        up = act_fn(act)(x @ p["w_gate"].to(x.dtype)) * up
    else:
        up = act_fn(act)(up)
    return up @ p["w_down"].to(x.dtype)


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


def moe(p, x: torch.Tensor, cfg):
    """Top-k routed experts with the reference's grouped capacity dispatch
    (GShard-style) and Switch aux loss.  Returns (out, aux_loss).

    Each (token, slot) pair of a group takes the next free slot of its
    expert in the order of the flattened (token, slot) axis (positions
    counted in float32, as the reference counts them); a pair past the
    capacity C is dropped.  The kept pairs are scattered into an
    (E, G·C, d) slot buffer, the experts run as batched matmuls over all
    their slots (empty slots are zero rows, as the reference's), and each
    token gathers its k slots back, weighted by its normalised gates."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    probs = torch.softmax((xt @ p["router"].to(x.dtype)).float(), dim=-1)
    gate_vals, gate_idx = top_k(probs, k)                       # (T, k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    G, Tg, C = moe_groups(cfg, T)
    onehot = F.one_hot(gate_idx, E).float()                     # (T, k, E)
    ohf = onehot.reshape(G, Tg * k, E)
    pos = ((torch.cumsum(ohf, dim=1) - ohf) * ohf).sum(-1)      # (G, Tg*k)
    keep = (pos < C).reshape(T, k)
    group = torch.arange(G, device=x.device).repeat_interleave(Tg * k)
    slot = (gate_idx.reshape(-1) * G + group) * C \
        + pos.reshape(-1).long().clamp(max=C - 1)               # (T*k,)
    n_slots = E * G * C
    # dropped pairs land in one spare row past the slots
    target = torch.where(keep.reshape(-1), slot,
                         torch.full_like(slot, n_slots))
    xe = xt.new_zeros((n_slots + 1, d)).index_add(
        0, target, xt.repeat_interleave(k, dim=0))[:n_slots]
    xe = xe.reshape(E, G * C, d)
    h = act_fn(cfg.act)(torch.bmm(xe, p["w_gate"].to(x.dtype))) \
        * torch.bmm(xe, p["w_up"].to(x.dtype))
    ye = torch.bmm(h, p["w_down"].to(x.dtype)).reshape(n_slots, d)
    w = (gate_vals * keep).to(x.dtype)                          # (T, k)
    out = (ye[slot].reshape(T, k, d) * w[..., None]).sum(1)
    if cfg.n_shared_experts:
        out = out + mlp(p["shared"], x, cfg.act).reshape(T, d)
    # load-balancing aux loss (Switch-style)
    me = onehot[:, 0].mean(0)
    ce = probs.mean(0)
    aux = E * torch.sum(me * ce) * cfg.router_aux_coef
    return out.reshape(B, S, d), aux
