"""State-space blocks: Mamba2 (SSD, chunked) and RWKV6 (Finch) (port of
``repro.models.ssm``).

Both are linear-time in sequence length and have one-step decode updates
on O(1) state caches.  The chunked SSD scan (``_ssd_chunked``) and the
WKV6 recurrence (``_wkv_scan``) are plain PyTorch, as the reference's are
plain ``jnp`` scans; the SSD's scan over chunks and the WKV's scan over
steps are Python loops.  A decode cache is updated in place by the
caller: the conv ring and the token shifts keep the dtype they were made
with, the SSM and WKV states are float32.

On a model sharded over a model axis: Mamba2's fused ``w_in`` is split
flat over its (z, xBC, dt) columns by the reference's rule, which cuts
across the segments, so each rank projects onto its columns, the
projections are gathered (activations, not the weight) and the block
runs whole; ``w_out`` is row-parallel over ``d_in`` (each rank its rows
of the gated, normed output, summed over the model group).  Its decode
caches are this rank's blocks (conv channels, SSM heads), gathered for
the step and cut back.  RWKV6 runs its WKV heads split over the model
axis (``w_r``, ``w_k``, ``w_v``, ``w_g`` column-parallel, ``w_o``
row-parallel, the WKV state cached per head) and its channel mix as a
column/row-parallel pair, ``w_cr``'s gate columns gathered.

In a prefill or a train step whose sequence is cut (``distributed.batch.
Rows.seq``) each rank runs its block: the causal convolution and the
token shifts take the rows before the block from one all-gather of each
block's tail (:func:`~repro_torch.models.layers.halo_rows`), and each
recurrence runs its block from a zero state, all-gathers every block's
(final state, total decay), folds the earlier blocks' into its incoming
state (:func:`fold_states`) and adds that state's share to its outputs,
which by linearity equals a scan started from it.  The gathers are
differentiable (``model_parallel.seq_gather``): the gradient of an
incoming state reaches the earlier blocks through their reduce-scatter,
and the fold is plain torch.

Where the model axis that cuts the sequence also splits the weights
(``model_parallel.seq_tp``): Mamba2 reads ``w_in`` and ``w_out`` whole
(``p.full``: one gather of each a layer, whose backward reduce-scatters
the gradient) and runs its block as above, so that no rank computes
another's convolution or scan.  RWKV6 runs Megatron sequence parallelism,
as attention and the MLP do: the time mix gathers the block's normed
rows over the group (``model_parallel.tp_enter``), shifts them and runs
the decay LoRA over the group's whole sequences from position 0, scans
its WKV heads over them from a zero state (no state crosses ranks: a
rank's heads are its own) and reduce-scatters ``w_o``'s row-parallel sum
back to the block (``tp_exit``); the channel mix gathers its rows the
same way for the ``w_ck`` / ``w_cv`` pair, and computes its gate on the
block with ``w_cr`` read whole.  A weight read on the gathered rows
keeps its partial gradient there, which the step sums over the model
axis once.  Where the sequence is cut over the model axis and others
(context parallelism, ``model_parallel.SeqTP``), the gathered rows are
the model group's super-block: Mamba2 runs as above (its split weights
read whole, its halo and state over the whole sequence's group), and
RWKV6's mixes shift the super-block from the previous super-block's last
row (``halo_rows`` over the other axes) and its WKV heads fold the
earlier super-blocks' states into theirs (:func:`_wkv_blocks` over the
other axes, not a scan from zero).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..distributed.model_parallel import (copy_to, gather_from, reduce_from,
                                          seq_gather, seq_tp, tp_enter,
                                          tp_exit)
from .layers import _full, _init, _split, _weight, _zeros, halo_rows, \
    model_axis, prompt_split, rms_norm


def _whole(t: torch.Tensor, n: int, dim: int, sp):
    """A cache leaf whole: gathered over the model split when it holds
    this rank's block of its ``n`` entries along ``dim``."""
    if sp is None or t.shape[dim] == n:
        return t
    return gather_from(t, sp, dim=dim, tag="cache_gather")


def _mine(t: torch.Tensor, like: torch.Tensor, dim: int, sp):
    """``t`` cut to this rank's block along ``dim`` when the cache leaf
    ``like`` holds a block."""
    if sp is None or like.shape[dim] == t.shape[dim]:
        return t
    start, n = sp.block(t.shape[dim])
    return t.narrow(dim, start, n)


# ---------------------------------------------------------------------------
# Mamba2 / SSD
# ---------------------------------------------------------------------------

def mamba_dims(cfg):
    d_in = cfg.mamba_expand * cfg.d_model
    nh = d_in // cfg.mamba_head_dim
    return d_in, nh


def init_mamba(generator: torch.Generator, cfg) -> dict:
    d, ds = cfg.d_model, cfg.ssm_state
    d_in, nh = mamba_dims(cfg)
    conv_ch = d_in + 2 * ds
    return {
        "w_in": _init(generator, (d, 2 * d_in + 2 * ds + nh)),  # z, xBC, dt
        "conv_w": _init(generator, (cfg.conv_width, conv_ch), scale=0.5),
        "conv_b": _zeros(generator, (conv_ch,)),
        "dt_bias": _zeros(generator, (nh,)),
        "A_log": _zeros(generator, (nh,)),
        "D": torch.ones((nh,), device=generator.device),
        "norm": _zeros(generator, (d_in,)),
        "w_out": _init(generator, (d_in, d)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 halo: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, C), w (K, C); ``halo`` (B, K - 1,
    C) the rows before x (zeros when None)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0)) if halo is None else \
        torch.cat([halo.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + S] * w[i][None, None] for i in range(K))
    return out + b[None, None]


def fold_states(states: torch.Tensor, decays: torch.Tensor,
                index: int) -> torch.Tensor:
    """The state entering block ``index`` of a linear recurrence cut into
    blocks, from each block's final state from a zero start (P, ...) and
    its total decay (P, ..., broadcast against a state):
    Σ_{j<index} S_j ∏_{j<l<index} decay_l.  The first block's is zero, as
    a product with the gathered states, so that every rank's backward
    reaches their gather."""
    S = states[0] * 0
    for j in range(index):
        S = S * decays[j] + states[j]
    return S


def _gather_states(state: torch.Tensor, decay: torch.Tensor, seq):
    """Every block's (final state, total decay) over the split's group,
    from one all-gather of the pair -> ((P,) + state's shape, (P,) +
    decay's shape)."""
    B = state.shape[0]
    n = state[0].numel()
    g = seq_gather(torch.cat([state.reshape(B, -1),
                              decay.reshape(B, -1).to(state.dtype)],
                             dim=1)[None], seq, 0, "sp_state")
    return g[:, :, :n].reshape((-1,) + tuple(state.shape)), \
        g[:, :, n:].reshape((-1,) + tuple(decay.shape))


def ssd_state_term(Cc: torch.Tensor, cum: torch.Tensor,
                   S_in: torch.Tensor) -> torch.Tensor:
    """The outputs' share of an incoming SSD state S_in (B, nh, hd, ds):
    C_t · exp(cum_t) · S_in, cum (B, S, nh) the block's inclusive
    cumulative log-decay -> (B, S, nh, hd), in S_in's dtype."""
    return torch.einsum("btn,bth,bhdn->bthd", Cc.to(S_in.dtype),
                        torch.exp(cum).to(S_in.dtype), S_in)


def _ssd_blocks(xh, dt, a_log, Bc, Cc, chunk: int, seq) -> torch.Tensor:
    """:func:`_ssd_chunked` over this rank's block of a sequence cut over
    ``seq``: the block from a zero state, the earlier blocks' states
    folded in (:func:`fold_states`, :func:`ssd_state_term`)."""
    y, final = _ssd_chunked(xh, dt, a_log, Bc, Cc, chunk, final=True)
    cum = torch.cumsum(a_log.float(), dim=1)
    states, decays = _gather_states(final, cum[:, -1], seq)
    S_in = fold_states(states, torch.exp(decays)[..., None, None], seq.index)
    return y + ssd_state_term(Cc, cum, S_in)


def _ssd_chunked(xh, dt, a_log, Bc, Cc, chunk: int, final: bool = False):
    """Chunked SSD scan (Mamba2).  xh: (B,S,nh,hd), dt: (B,S,nh),
    a_log: per-step log-decay (B,S,nh), Bc/Cc: (B,S,ds).  S is padded up
    to a multiple of the chunk and the scan runs in float32, from a zero
    state.  Returns y (B,S,nh,hd), and with ``final`` (y, the final state
    (B,nh,hd,ds)).

    Within a chunk the decay exp(cum_t - cum_s) is wanted for s <= t only;
    above the diagonal the difference is positive and its exponential can
    overflow.  The reference takes the exponential of the whole block and
    masks it with ``where`` (an overflow there leaves 0 * inf in its
    gradient); here the block is masked to -inf before the exponential, so
    the values are the same and the gradient stays finite."""
    B, S, nh, hd = xh.shape
    ds = Bc.shape[-1]
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        a_log = F.pad(a_log, (0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
    f32 = torch.float32
    xh = xh.reshape(B, nc, L, nh, hd)
    dtx = (dt.reshape(B, nc, L, nh)[..., None] * xh).to(f32)
    al = a_log.reshape(B, nc, L, nh).to(f32)
    Bc = Bc.reshape(B, nc, L, ds).to(f32)
    Cc = Cc.reshape(B, nc, L, ds).to(f32)

    cum = torch.cumsum(al, dim=2)                            # (B,nc,L,nh)
    # intra-chunk: scores[t,s] = (C_t·B_s) exp(cum_t - cum_s) [s<=t]
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)             # (B,nc,L,L)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,L,L,nh)
    ar = torch.arange(L, device=xh.device)
    tri = ar[:, None] >= ar[None, :]
    m = torch.exp(decay.masked_fill(~tri[None, None, :, :, None],
                                    float("-inf")))
    scores = cb[..., None] * m                               # (B,nc,L,L,nh)
    y_intra = torch.einsum("bctsh,bcshd->bcthd", scores, dtx)

    # chunk-final states: sum_s exp(cum_L - cum_s) dtx_s ⊗ B_s
    tail = torch.exp(cum[:, :, -1:, :] - cum)                # (B,nc,L,nh)
    st = torch.einsum("bclh,bclhd,bcln->bchdn", tail, dtx, Bc)

    # inter-chunk: scan over the chunk axis; S_prevs[c] is the state
    # entering chunk c
    decay_chunk = torch.exp(cum[:, :, -1, :])                # (B,nc,nh)
    state = torch.zeros((B, nh, hd, ds), dtype=f32, device=xh.device)
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = state * decay_chunk[:, c, :, None, None] + st[:, c]
    S_prevs = torch.stack(prevs, dim=1)                      # (B,nc,nh,hd,ds)
    y_inter = torch.einsum("bctn,bcth,bchdn->bcthd",
                           Cc, torch.exp(cum), S_prevs)
    y = (y_intra + y_inter).reshape(B, nc * L, nh, hd)[:, :S]
    return (y, state) if final else y


def mamba_block(p, x: torch.Tensor, cfg, chunk: int = 128, cache=None):
    """Returns (out, new_cache).  cache = {"conv": (B,K-1,C), "ssm":
    (B,nh,hd,ds)}; with a cache the S steps run as the recurrent update."""
    B, S, d = x.shape
    ds = cfg.ssm_state
    d_in, nh = mamba_dims(cfg)
    hd = cfg.mamba_head_dim
    ms = model_axis(p, "w_in", "w_out")
    seq = prompt_split(x) if cache is None else None
    sp = _split(p, "w_in", 1)
    if sp is None or seq_tp(sp, seq) is not None:
        proj = x @ _full(p, "w_in").to(x.dtype)
    else:       # column-parallel, the projection gathered whole
        proj = gather_from(copy_to(x, sp) @ p["w_in"].to(x.dtype), sp,
                           dim=-1, tag="tp_gather")
    z, xBC, dt = torch.split(proj, [d_in, d_in + 2 * ds, nh], dim=-1)
    conv_w, conv_b = _full(p, "conv_w"), _full(p, "conv_b")

    if cache is None:
        halo = None if seq is None else halo_rows(
            xBC, conv_w.shape[0] - 1, seq, "sp_conv")
        xBC = _causal_conv(xBC, conv_w.to(x.dtype), conv_b.to(x.dtype), halo)
        new_conv = None
    else:
        conv = _whole(cache["conv"], d_in + 2 * ds, -1, ms)
        ctx = torch.cat([conv.to(x.dtype), xBC], dim=1)
        K = conv_w.shape[0]
        xBC = sum(ctx[:, i:i + S] * conv_w[i][None, None].to(x.dtype)
                  for i in range(K)) + conv_b[None, None].to(x.dtype)
        new_conv = _mine(ctx[:, -(K - 1):], cache["conv"], -1, ms)
    xBC = F.silu(xBC)
    xs, Bc, Cc = torch.split(xBC, [d_in, ds, ds], dim=-1)
    xh = xs.reshape(B, S, nh, hd)
    dt = F.softplus(dt.float() + _full(p, "dt_bias")[None, None])
    a_log = -torch.exp(_full(p, "A_log").float())[None, None] * dt

    new_cache = None
    if cache is None:
        y = _ssd_chunked(xh, dt, a_log, Bc, Cc, chunk) if seq is None \
            else _ssd_blocks(xh, dt, a_log, Bc, Cc, chunk, seq)
    else:  # single/few-step decode: recurrent update
        Sst = _whole(cache["ssm"], nh, 1, ms).float()
        xf, Bf, Cf = xh.float(), Bc.float(), Cc.float()
        ys = []
        for t in range(S):
            Sst = Sst * torch.exp(a_log[:, t])[..., None, None] + \
                torch.einsum("bh,bhd,bn->bhdn", dt[:, t], xf[:, t], Bf[:, t])
            ys.append(torch.einsum("bn,bhdn->bhd", Cf[:, t], Sst))
        y = torch.stack(ys, dim=1)
        new_cache = {"conv": new_conv,
                     "ssm": _mine(Sst, cache["ssm"], 1, ms)}

    y = y + _full(p, "D").float()[None, None, :, None] * xh.float()
    y = y.reshape(B, S, d_in).to(x.dtype) * F.silu(z)
    y = rms_norm(y, _full(p, "norm"), cfg.norm_eps)
    sp = _split(p, "w_out", 0)
    if sp is None or seq_tp(sp, seq) is not None:
        return y @ _full(p, "w_out").to(x.dtype), new_cache
    start, n = sp.block(d_in)
    y = copy_to(y, sp)[..., start:start + n]
    return reduce_from(y @ p["w_out"].to(x.dtype), sp), new_cache


def mamba_cache(cfg, B: int, dtype=torch.float32, device=None) -> dict:
    dev = resolve_device(device)
    d_in, nh = mamba_dims(cfg)
    conv_ch = d_in + 2 * cfg.ssm_state
    return {"conv": torch.zeros((B, cfg.conv_width - 1, conv_ch),
                                dtype=dtype, device=dev),
            "ssm": torch.zeros((B, nh, cfg.mamba_head_dim, cfg.ssm_state),
                               dtype=torch.float32, device=dev)}


# ---------------------------------------------------------------------------
# RWKV6 (Finch): data-dependent decay time mix + channel mix
# ---------------------------------------------------------------------------

def init_rwkv(generator: torch.Generator, cfg) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    lora = 64
    nh = d // cfg.rwkv_head_dim

    def full(v):
        return torch.full((d,), v, device=generator.device)

    return {
        "ln1": _zeros(generator, (d,)), "ln2": _zeros(generator, (d,)),
        "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
        "mu_g": full(0.5), "mu_w": full(0.5),
        "w_r": _init(generator, (d, d)), "w_k": _init(generator, (d, d)),
        "w_v": _init(generator, (d, d)), "w_g": _init(generator, (d, d)),
        "w_o": _init(generator, (d, d)),
        "w0": full(-4.0),
        "w_lora_a": _init(generator, (d, lora)),
        "w_lora_b": _init(generator, (lora, d), scale=0.01),
        "u": _zeros(generator, (nh, cfg.rwkv_head_dim)),
        "ln_x": _zeros(generator, (d,)),
        "mu_cr": full(0.5), "mu_ck": full(0.5),
        "w_ck": _init(generator, (d, ff)), "w_cv": _init(generator, (ff, d)),
        "w_cr": _init(generator, (d, d)),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """prev: (B, d) last token of the previous call (zeros at start)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _wkv_scan(r, k, v, w, u, state):
    """WKV6 recurrence.  r,k: (B,S,nh,hk), v: (B,S,nh,hv), w: (B,S,nh,hk)
    decays in (0,1); u: (nh,hk) bonus.  state: (B,nh,hk,hv).  Returns
    (y (B,S,nh,hv), final state), in float32."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    S = state.float()
    uf = u.float()[None, :, :, None]
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], S + uf * kv))
        S = S * w[:, t, ..., None] + kv
    return torch.stack(ys, dim=1), S


def wkv_state_term(r: torch.Tensor, w: torch.Tensor,
                   S_in: torch.Tensor) -> torch.Tensor:
    """The outputs' share of an incoming WKV state S_in (B, nh, hk, hv):
    (r_t ⊙ P_t) · S_in, P_t the per-channel product of the decays w
    (B, S, nh, hk) over the block's steps before t -> (B, S, nh, hv), in
    float32 or wider."""
    f = torch.promote_types(S_in.dtype, torch.float32)
    w = w.to(f)
    P = torch.cumprod(torch.cat([torch.ones_like(w[:, :1]), w[:, :-1]],
                                dim=1), dim=1)
    return torch.einsum("bthk,bhkv->bthv", r.to(f) * P, S_in)


def _wkv_blocks(r, k, v, w, u, state, seq):
    """:func:`_wkv_scan` over this rank's block of a sequence cut over
    ``seq``: the block scanned once from ``state`` (zeros), the earlier
    blocks' states folded in (:func:`fold_states`, :func:`wkv_state_term`)
    -> (y, this block's final state)."""
    y, S_loc = _wkv_scan(r, k, v, w, u, state)
    W = torch.prod(w.float(), dim=1)                       # (B, nh, hk)
    states, decays = _gather_states(S_loc, W, seq)
    S_in = fold_states(states, decays[..., None], seq.index)
    return y + wkv_state_term(r, w, S_in), S_loc + W[..., None] * S_in


def rwkv_block(p, x_in: torch.Tensor, cfg, cache=None):
    """Full residual RWKV6 block: x + time mix + channel mix.  Returns
    (out, new_cache); cache = {"shift_a", "shift_c": (B, d), "wkv":
    (B, nh, hk, hv)}.  The shift caches hold the normed last token."""
    B, S, d = x_in.shape
    hk = cfg.rwkv_head_dim
    nh = d // hk
    x = rms_norm(x_in, _full(p, "ln1"), cfg.norm_eps)
    seq = prompt_split(x_in) if cache is None else None

    def enter(h, sp, key):
        """The rows a mix split over ``sp`` runs on and their token
        shift: the model group's gathered super-block, shifted from the
        previous super-block's last row (zeros where the model axis alone
        cuts the sequence), where ``sp`` is over an axis that cuts it
        (``model_parallel.seq_tp``); else ``h`` itself, shifted from the
        cache's row, the previous block's last or zeros -> (rows,
        shifted rows, the split to copy them to, the
        ``model_parallel.SeqTP`` gathered over or None)."""
        whole = seq_tp(sp, seq)
        if whole is not None:
            rows = tp_enter(h, sp, whole)
            prev = rows.new_zeros((B, d)) if whole.outer is None else \
                halo_rows(rows, 1, whole.outer, "sp_shift")[:, 0]
            return rows, _token_shift(rows, prev), None, whole
        if cache is not None:
            prev = cache[key].to(h.dtype)
        elif seq is not None:
            prev = halo_rows(h, 1, seq, "sp_shift")[:, 0]
        else:
            prev = h.new_zeros((B, d))
        return h, _token_shift(h, prev), sp, None

    def mix(a, shifted, mu):
        return a + (shifted - a) * _full(p, mu).to(x.dtype)[None, None]

    # the WKV heads split over the model axis (this rank's d / M channels);
    # over the axis that cuts the sequence the time mix runs on the
    # group's whole sequences, nothing copied to the group
    sp = _split(p, "w_r", 1)
    if sp is not None and (nh % sp.size or _split(p, "w_o", 0) is None):
        sp = None
    xt, xs, cp, whole = enter(x, sp, "shift_a")
    St = xt.shape[1]
    c0, dl = (0, d) if sp is None else sp.block(d)
    h0, nhl = c0 // hk, dl // hk

    def proj(mu, key):
        return copy_to(mix(xt, xs, mu), cp) @ _weight(p, key, sp).to(x.dtype)

    r, k = proj("mu_r", "w_r"), proj("mu_k", "w_k")
    v, g = proj("mu_v", "w_v"), proj("mu_g", "w_g")
    # data-dependent decay (the Finch contribution)
    wl = torch.tanh(mix(xt, xs, "mu_w")
                    @ _full(p, "w_lora_a").to(x.dtype)) \
        @ _full(p, "w_lora_b").to(x.dtype)
    w = torch.exp(-torch.exp((_full(p, "w0")[None, None] + wl).float()))
    w = copy_to(w, cp)[..., c0:c0 + dl]

    if cache is not None:
        state = cache["wkv"]
        if state.shape[1] != nhl:
            raise ValueError(
                f"the WKV cache holds {state.shape[1]} heads but this rank "
                f"runs {nhl}: make the cache with init_cache under the "
                f"model's sharding context")
    else:
        state = torch.zeros((B, nhl, hk, hk), dtype=torch.float32,
                            device=x.device)
    u = copy_to(_full(p, "u"), cp)[h0:h0 + nhl]
    rkvw = [t.reshape(B, St, nhl, hk) for t in (r, k, v, w)]
    # the blocks this rank's scan is one of: its own, or its super-block
    blocks = seq if whole is None else whole.outer
    if blocks is None:
        y, S_fin = _wkv_scan(*rkvw, u, state)
    else:
        y, S_fin = _wkv_blocks(*rkvw, u, state, blocks)
    y = y.reshape(B, St, dl).to(x.dtype)
    # per-head group norm
    yh = y.reshape(B, St, nhl, hk).float()
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, unbiased=False, keepdim=True)
    yh = (yh - mu) * torch.rsqrt(var + 64e-5)
    ln_x = copy_to(_full(p, "ln_x"), cp)[c0:c0 + dl]
    y = (yh.reshape(B, St, dl) * (1.0 + ln_x[None, None])).to(x.dtype)
    y = y * F.silu(g)
    att = tp_exit(y @ _weight(p, "w_o", sp).to(x.dtype), sp, whole)

    # channel mix on the post-attention residual stream
    res = x_in + att
    x2 = rms_norm(res, _full(p, "ln2"), cfg.norm_eps)
    csp = _split(p, "w_ck", 1)
    if csp is not None and _split(p, "w_cv", 0) is None:
        csp = None
    x2t, xs2t, ccp, cwhole = enter(x2, csp, "shift_c")
    # the gate's rows: this block's of the shifted super-block
    xs2 = xs2t if cwhole is None else xs2t.narrow(1, cwhole.inner.index * S,
                                                  S)
    ck = copy_to(mix(x2t, xs2t, "mu_ck"), ccp) \
        @ _weight(p, "w_ck", csp).to(x.dtype)
    cv = tp_exit(torch.square(F.relu(ck))
                 @ _weight(p, "w_cv", csp).to(x.dtype), csp, cwhole)
    rsp = _split(p, "w_cr", 1)
    if seq_tp(rsp, seq) is not None:     # the gate of the block: w_cr whole
        rsp = None
    cr = torch.sigmoid(copy_to(mix(x2, xs2, "mu_cr"), rsp)
                       @ _weight(p, "w_cr", rsp).to(x.dtype))
    ffn = gather_from(cr, rsp, dim=-1) * cv

    new_cache = None
    if cache is not None:
        new_cache = {"shift_a": x[:, -1], "shift_c": x2[:, -1], "wkv": S_fin}
    return res + ffn, new_cache


def rwkv_cache(cfg, B: int, dtype=torch.float32, device=None) -> dict:
    dev = resolve_device(device)
    d = cfg.d_model
    nh = d // cfg.rwkv_head_dim
    return {"shift_a": torch.zeros((B, d), dtype=dtype, device=dev),
            "shift_c": torch.zeros((B, d), dtype=dtype, device=dev),
            "wkv": torch.zeros((B, nh, cfg.rwkv_head_dim, cfg.rwkv_head_dim),
                               dtype=torch.float32, device=dev)}
