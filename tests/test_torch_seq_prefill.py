"""The blocks of a sequence-parallel prefill and train step (the
reference's ``seq: "model"`` rule) against the whole sequence and
``repro.models``, in one process.

A group of P ranks is simulated: block i runs inside a ``rows_set`` of a
``Rows`` whose ``seq`` is ``Split(None, P, i)``, and every collective a
block issues (all-gather, reduce-scatter, all-reduce) is answered from
the P blocks' inputs to that call, the blocks run again until those
inputs stop changing (a block's later exchanges read its earlier ones).
So the code under test is the layers' own: the attention's gathered keys
and values under the offset causal mask, the convolution's and the token
shifts' halo rows, the Mamba2 SSD and RWKV6 WKV blocks folded by the
state rule, and in training their backward reduce-scatters.  Values at
the reference's rtol 2e-4 / atol 2e-5; the WKV scan runs in float32 as
the reference's does, and the state rule it adds is also held in
float64.  The LM losses, the sig-MMD loss and the train step of the
blocks equal the whole sequence's, losses within 1e-4·max(1, |loss|)
and gradients within 1e-3·|g| + 1e-4·max|g|.  MLA (heads whole and
split), the MoE (experts whole and split, dropless and capacity-bound),
attention with its heads and the MLP with its ``ff`` split over the axis
that cuts the sequence equal the reference's whole sequence, and so do
``mamba_block`` with ``w_in`` / ``w_out`` split over that axis (read
whole on each block), ``rwkv_block`` with its heads and channel-mix
columns split (Megatron sequence parallelism) and whisper's
cross-attention with its heads split, its tokens cut or whole.  Context
parallelism runs on a simulated D x M grid (``in_blocks(..., grid=)``):
the sequence cut over both axes, each collective answered from the
blocks of the group it names, and every family's split layer and the
vocabulary held to the reference in value and gradient at 2 x 2 and
1 x 4.  Decode, and whisper trained with its tokens cut over the model
axis, its frames whole and its encoder split over that axis, refuse a
sequence split.
"""
import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import ssm as JS

from repro_torch import configs as tconfigs
from repro_torch.distributed import batch as DB
from repro_torch.distributed import collectives as C
from repro_torch.distributed import model_parallel as MP
from repro_torch.distributed.model_parallel import Split
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS

VALUE = dict(rtol=2e-4, atol=2e-5)


def normal(shape, seed, scale=1.0, dtype=np.float32):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        dtype)


def split(P: int, i: int) -> Split:
    return Split(None, P, i, ("model",))


class Grid:
    """A simulated D x M mesh of ``("data", "model")`` as block i = d·M +
    m sees it: its splits carry a group label (their axes' names) that
    the simulated collectives answer from, and their mesh is this grid,
    from which ``model_parallel.seq_tp`` makes the split of the data
    axis."""

    def __init__(self, D: int, M: int, i: int):
        self.sizes = {"data": D, "model": M}
        self.coord = dict(zip(("data", "model"), divmod(i, M)))

    def split(self, axes) -> Split:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        size, index = 1, 0
        for a in names:
            size *= self.sizes[a]
            index = index * self.sizes[a] + self.coord[a]
        return Split(names, size, index, names, self)

    def members(self, group) -> list:
        """The blocks of the group labelled ``group`` that holds this
        one, in the group's order (every block for None)."""
        D, M = self.sizes["data"], self.sizes["model"]
        if group is None:
            return list(range(D * M))
        return [j for j in range(D * M)
                if all(dict(zip(("data", "model"), divmod(j, M)))[a]
                       == self.coord[a] for a in ("data", "model")
                       if a not in group)]


_AXES_SPLIT = MP.axes_split


def _axes_split(mesh, axes):
    return mesh.split(axes) if isinstance(mesh, Grid) else \
        _AXES_SPLIT(mesh, axes)


TAGS: set = set()        # the tags of the last in_blocks run's collectives


def in_blocks(P: int, fn, B: int = 1, grid: tuple | None = None) -> list:
    """``fn(i)`` for each block i of a simulated group of P ranks, its
    collectives answered from every block's inputs to the same call
    (iterated to a fixed point) -> the P blocks' outputs.  An all-gather
    concatenates the blocks' inputs, a reduce-scatter keeps block i of
    their sum and an all-reduce writes their sum (or maximum) in place,
    so a block's forward and backward exchanges (``model_parallel.
    seq_gather`` / ``seq_scatter``, a loss's sums) all run as a group's.
    Each block's rows scope holds the B rows of the batch whole; the
    collectives' tags are left in ``TAGS``.  With ``grid`` = (D, M) the
    P = D·M blocks are a D x M mesh (:class:`Grid`) whose sequence is cut
    over both axes, block d·M + m the rank at (d, m), and each collective
    is answered from the blocks of the group it names (the model axis's,
    the data axis's or both); a split layer's model split is the model
    axis's (:class:`SplitTree`).  Without, the sequence and the model
    split are one axis of P."""
    if grid is not None:
        P = grid[0] * grid[1]
    sent = None
    TAGS.clear()
    for _ in range(32):
        got = [[] for _ in range(P)]
        outs = []
        for i in range(P):
            mesh = Grid(*(grid or (1, P)), i)

            def parts(t, tag, group, i=i, mesh=mesh):
                TAGS.add(tag)
                k = len(got[i])
                got[i].append(t.detach().clone())
                who = mesh.members(group)
                if sent is None or k >= len(sent[i]):
                    return [t.detach()] * len(who), who.index(i)
                return [sent[j][k] for j in who], who.index(i)

            def gather(t, group, *, tag="", dim=0):
                return torch.cat(parts(t, tag, group)[0], dim=dim)

            def scatter(t, group, *, tag="", dim=0):
                got_, me = parts(t, tag, group)
                n = t.shape[dim] // len(got_)
                return sum(got_).narrow(dim, me * n, n).contiguous()

            def reduce(t, group, *, tag="", op="sum"):
                got_, _ = parts(t, tag, group)
                return t.copy_(torch.stack(got_).amax(0) if op == "max"
                               else sum(got_))
            if grid is None:
                seq = model = split(P, i)
            else:
                seq, model = mesh.split(("data", "model")), \
                    mesh.split("model")
            rows = DB.Rows(None, B, 0, B, seq)
            with mock.patch.object(C, "all_gather", gather), \
                    mock.patch.object(C, "reduce_scatter", scatter), \
                    mock.patch.object(C, "all_reduce_", reduce), \
                    mock.patch.object(MP, "axes_split", _axes_split), \
                    mock.patch.object(SplitTree, "model", model), \
                    DB.rows_set(rows):
                outs.append(fn(i))
        if sent is not None and all(
                len(a) == len(b) and all(torch.equal(x, y)
                                         for x, y in zip(a, b))
                for a, b in zip(got, sent)):
            return outs
        sent = got
    raise AssertionError("the blocks' collectives did not settle")


def blocks_of(x: np.ndarray, P: int, i: int, dim: int = 1) -> torch.Tensor:
    n = x.shape[dim] // P
    return torch.from_numpy(np.ascontiguousarray(
        np.take(x, range(i * n, (i + 1) * n), axis=dim)))


def joined(outs, dim: int = 1) -> np.ndarray:
    return torch.cat([o.detach() for o in outs], dim=dim).numpy()


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("P", [2, 4])
def test_query_blocks_attend_over_the_gathered_keys(P, causal):
    """``_sdpa`` of each query block with ``q_offset`` against the whole
    keys, and ``_prefill_attend`` of each block (its keys and values
    gathered), equal the reference's ``_sdpa`` of the whole sequence."""
    B, S, Hq, Hkv, hd = 2, 16, 4, 2, 8
    q, k, v = (normal((B, S, H, hd), s) for s, H in
               ((0, Hq), (1, Hkv), (2, Hkv)))
    want = np.asarray(JL._sdpa(*map(jnp.asarray, (q, k, v)), causal))
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    n = S // P
    offset = [TL._sdpa(blocks_of(q, P, i), tk, tv, causal,
                       q_offset=i * n if causal else None)
              for i in range(P)]
    np.testing.assert_allclose(joined(offset), want, **VALUE)
    gathered = in_blocks(P, lambda i: TL._prefill_attend(
        blocks_of(q, P, i), blocks_of(k, P, i), blocks_of(v, P, i), causal,
        DB.current_seq()))
    np.testing.assert_allclose(joined(gathered), want, **VALUE)


# ---------------------------------------------------------------------------
# Mamba2: the SSD blocks, the convolution's halo
# ---------------------------------------------------------------------------

def ssd_inputs(S: int, seed: int = 0):
    B, nh, hd, ds = 2, 3, 4, 5
    xh = normal((B, S, nh, hd), seed)
    dt = np.log1p(np.exp(normal((B, S, nh), seed + 1))).astype(np.float32)
    a_log = (-0.5 * dt).astype(np.float32)
    return xh, dt, a_log, normal((B, S, ds), seed + 2, 0.5), \
        normal((B, S, ds), seed + 3, 0.5)


@pytest.mark.parametrize("S,chunk,P", [(32, 8, 2), (32, 8, 4), (24, 8, 2),
                                       (40, 8, 4)],
                         ids=["16-a-block", "8-a-block", "12-a-block",
                              "10-a-block"])
def test_ssd_blocks_fold_to_the_whole_scan(S, chunk, P):
    """Each block's chunked SSD from a zero state, every block's (final
    state, total log-decay) gathered and folded into its incoming state,
    equals the whole sequence's scan (the port's and the reference's),
    where the block is a multiple of the chunk and where it is not."""
    args = ssd_inputs(S)
    want = np.asarray(JS._ssd_chunked(*map(jnp.asarray, args), chunk))
    whole = TS._ssd_chunked(*map(torch.from_numpy, args), chunk)
    np.testing.assert_allclose(whole.numpy(), want, **VALUE)
    got = in_blocks(P, lambda i: TS._ssd_blocks(
        *(blocks_of(a, P, i) for a in args), chunk, DB.current_seq()))
    np.testing.assert_allclose(joined(got), want, **VALUE)


def test_ssd_final_state_is_the_recurrences():
    """``_ssd_chunked(final=True)``'s state is the step-by-step
    recurrence's (the decode path's update) after S steps."""
    xh, dt, a_log, Bc, Cc = map(torch.from_numpy, ssd_inputs(13, 4))
    _, state = TS._ssd_chunked(xh, dt, a_log, Bc, Cc, 4, final=True)
    S = torch.zeros_like(state)
    for t in range(xh.shape[1]):
        S = S * torch.exp(a_log[:, t])[..., None, None] + torch.einsum(
            "bh,bhd,bn->bhdn", dt[:, t], xh[:, t], Bc[:, t])
    np.testing.assert_allclose(state.numpy(), S.numpy(), **VALUE)


@pytest.mark.parametrize("S,P", [(12, 2), (8, 4)],
                         ids=["6-a-block", "2-a-block"])
def test_causal_conv_and_token_shift_with_halo_rows(S, P):
    """The convolution over each block with the K - 1 rows before it
    (from blocks of 2 as well, shorter than K - 1 = 3) and the token
    shift with the row before it equal the reference's over the whole
    sequence, zeros before the first block."""
    x = normal((2, S, 6), 4)
    w, b = normal((4, 6), 6), normal((6,), 7)
    want = np.asarray(JS._causal_conv(*map(jnp.asarray, (x, w, b))))
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    got = in_blocks(P, lambda i: TS._causal_conv(
        blocks_of(x, P, i), tw, tb, TL.halo_rows(
            blocks_of(x, P, i), 3, DB.current_seq(), "sp_conv")))
    np.testing.assert_allclose(joined(got), want, **VALUE)
    shift = np.asarray(JS._token_shift(jnp.asarray(x),
                                       jnp.zeros((2, 6), jnp.float32)))
    got = in_blocks(P, lambda i: TS._token_shift(
        blocks_of(x, P, i), TL.halo_rows(blocks_of(x, P, i), 1,
                                         DB.current_seq(), "sp_shift")[:, 0]))
    np.testing.assert_array_equal(joined(got), shift)


# ---------------------------------------------------------------------------
# RWKV6: the WKV blocks
# ---------------------------------------------------------------------------

def wkv_inputs(S: int, dtype=np.float64):
    B, nh, hk = 2, 2, 4
    r, k, v = (normal((B, S, nh, hk), s, 0.5, dtype) for s in (0, 1, 2))
    w = np.exp(-np.exp(normal((B, S, nh, hk), 3, 0.5, dtype) - 1.0))
    return r, k, v, w.astype(dtype), normal((nh, hk), 4, 0.5, dtype)


@pytest.mark.parametrize("P", [2, 4])
def test_wkv_blocks_fold_to_the_whole_scan(P):
    """Each block scanned once from zero, then corrected by (r_t ⊙ P_t) ·
    S_in with S_in folded from the earlier blocks' (state, decay
    product) pairs: float64 inputs, the scan in float32 as the
    reference's; the outputs and the final state equal the whole scan's
    (the port's and the reference's)."""
    S = 24
    r, k, v, w, u = wkv_inputs(S)
    state = np.zeros((2, 2, 4, 4))
    want, want_state = JS._wkv_scan(*map(jnp.asarray, (r, k, v, w, u,
                                                         state)))
    whole, whole_state = TS._wkv_scan(*map(torch.from_numpy,
                                           (r, k, v, w, u, state)))
    np.testing.assert_allclose(whole.numpy(), np.asarray(want), **VALUE)
    tu = torch.from_numpy(u)
    got = in_blocks(P, lambda i: TS._wkv_blocks(
        *(blocks_of(a, P, i) for a in (r, k, v, w)), tu,
        torch.zeros((2, 2, 4, 4)), DB.current_seq()))
    np.testing.assert_allclose(joined([y for y, _ in got]),
                               np.asarray(want), **VALUE)
    np.testing.assert_allclose(got[-1][1].numpy(), np.asarray(want_state),
                               **VALUE)
    np.testing.assert_allclose(got[-1][1].numpy(), whole_state.numpy(),
                               **VALUE)


def test_wkv_state_rule_in_float64():
    """In float64, the share of an incoming state S_in that
    ``wkv_state_term`` adds is the recurrence's S ← w_t ⊙ S, y_t = r_t · S
    from S_in, and ``fold_states`` of two blocks' states is the state the
    recurrence carries across both, to 1e-12."""
    r, _, _, w, _ = wkv_inputs(7)
    S_in = normal((2, 2, 4, 3), 9, 1.0, np.float64)
    S, ys = S_in.copy(), []
    for t in range(r.shape[1]):
        ys.append(np.einsum("bhk,bhkv->bhv", r[:, t], S))
        S = S * w[:, t, ..., None]
    got = TS.wkv_state_term(torch.from_numpy(r), torch.from_numpy(w),
                            torch.from_numpy(S_in))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.stack(ys, 1), rtol=1e-12,
                               atol=1e-12)
    S0, S1 = (normal((2, 2, 4, 3), s, 1.0, np.float64) for s in (10, 11))
    W = w.prod(1)
    folded = TS.fold_states(torch.from_numpy(np.stack([S0, S1, S0])),
                            torch.from_numpy(np.stack([W, W, W]))[..., None],
                            2)
    np.testing.assert_allclose(folded.numpy(), S0 * W[..., None] + S1,
                               rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# whole blocks: mamba_block and rwkv_block
# ---------------------------------------------------------------------------

def cfgs(arch):
    return (tconfigs.reduce_config(tconfigs.get_config(arch)),
            jconfigs.reduce_config(jconfigs.get_config(arch)))


def block_params(init, jcfg, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + scale * rng.normal(
        size=x.shape)).astype(np.float32), init(jax.random.PRNGKey(seed),
                                                jcfg))


@pytest.mark.parametrize("arch,name,init", [
    ("zamba2-7b", "mamba_block", JS.init_mamba),
    ("rwkv6-1.6b", "rwkv_block", JS.init_rwkv)], ids=["mamba", "rwkv"])
def test_ssm_blocks_over_a_cut_sequence(arch, name, init):
    """``mamba_block`` (chunk 4 over blocks of 6) and ``rwkv_block`` over
    the blocks of a 12-token sequence equal the reference's block over the
    whole sequence."""
    cfg, jcfg = cfgs(arch)
    p = block_params(init, jcfg)
    x = normal((2, 12, cfg.d_model), 1, 0.5)
    kw = {"chunk": 4} if name == "mamba_block" else {}
    want = np.asarray(jax.jit(lambda p, x: getattr(JS, name)(
        p, x, jcfg, **kw)[0])(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    got = in_blocks(2, lambda i: getattr(TS, name)(
        tp, blocks_of(x, 2, i), cfg, **kw)[0])
    np.testing.assert_allclose(joined(got), want, **VALUE)


# ---------------------------------------------------------------------------
# layers under a sequence split: MLA, the MoE, and the layers split over
# the axis that cuts the sequence (Megatron sequence parallelism)
# ---------------------------------------------------------------------------

class SplitTree(TL.ParamTree):
    """A layer's weights as rank i of the simulated group reads them: each
    key of ``dims`` split on its dimension over the model axis, which
    also cuts the sequence, alone or with the data axis (in a block of
    ``in_blocks`` the split is the block's model ``Split``, or ``over``
    where it is set), every other weight whole.  ``p[key]`` of a split key is this rank's block of
    the one parameter, so the blocks' gradients sum to the whole's, as
    the step's reduction sums them; outside a split every weight is
    whole."""
    over = None         # the model split inside a scope of whole tokens
    model = None        # the model split of an in_blocks block

    def __init__(self, tree: dict, dims: dict):
        super().__init__({k: v for k, v in tree.items()
                          if not isinstance(v, dict)})
        for k, v in tree.items():
            if isinstance(v, dict):
                self[k] = SplitTree(v, dims.get(k, {}))
        self._dims = {k: d for k, d in dims.items() if isinstance(d, int)}

    def split(self, key, dim):
        sp = SplitTree.over
        if sp is None and DB.current_seq() is not None:
            sp = SplitTree.model
        return sp if sp is not None and self._dims.get(key) == dim \
            else None

    def __getitem__(self, key):
        v = super().__getitem__(key)
        sp = self.split(key, self._dims.get(key, -1))
        if sp is None:
            return v
        dim = self._dims[key]
        n = v.shape[dim] // sp.size
        return v.narrow(dim, sp.index * n, n)

    def full(self, key):
        return self._parameters[key]


def split_tree(tree: dict, dims: dict) -> SplitTree:
    """A :class:`SplitTree` of the reference's numpy tree (parameters that
    require grad)."""
    def leaves(t):
        return {k: leaves(v) if isinstance(v, dict) else
                torch.nn.Parameter(torch.from_numpy(np.array(v)))
                for k, v in t.items()}
    return SplitTree(leaves(tree), dims)


MLA_HEADS = {"w_uk": 1, "w_uv": 1, "wq": 1, "w_uq": 1, "wo": 0}
EXPERTS = {"w_gate": 0, "w_up": 0, "w_down": 0,
           "shared": {"w_gate": 1, "w_up": 1, "w_down": 0}}
HEADS = {"wq": 1, "wo": 0}
FF = {"w_gate": 1, "w_up": 1, "w_down": 0}


def mla_case(q_lora: int):
    """Reduced deepseek-v2-lite's MLA (``q_lora`` > 0: the queries'
    low-rank path), its reference parameters, a (2, 8) input and the
    whole sequence's positions."""
    cfg, jcfg = (dataclasses.replace(c, q_lora_rank=q_lora)
                 for c in cfgs("deepseek-v2-lite-16b"))
    p = block_params(JL.init_mla, jcfg)
    x = normal((2, 8, cfg.d_model), 1, 0.5)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8)).copy()
    return cfg, jcfg, p, x, pos


@pytest.mark.parametrize("q_lora", [0, 16], ids=["wq", "w_dq"])
@pytest.mark.parametrize("heads", ["whole", "split"])
@pytest.mark.parametrize("P", [2, 4])
def test_mla_blocks_equal_the_whole_sequence(P, heads, q_lora):
    """``mla_attention`` over the blocks of an 8-token sequence equals the
    reference's over the whole: with the heads whole each block gathers
    the group's latents and rope keys (``sp_latent``) and attends from its
    first position; with the heads split over the axis that cuts the
    sequence each rank gathers the rows (``sp_tp_in``), runs its heads
    from position 0 and reduce-scatters ``wo``'s partial sums
    (``sp_tp_out``)."""
    cfg, jcfg, p, x, pos = mla_case(q_lora)
    want = np.asarray(JL.mla_attention(jax.tree.map(jnp.asarray, p),
                                       jnp.asarray(x), jcfg,
                                       jnp.asarray(pos))[0])
    tree = split_tree(p, MLA_HEADS if heads == "split" else {})
    got = in_blocks(P, lambda i: TL.mla_attention(
        tree, blocks_of(x, P, i), cfg, torch.from_numpy(pos))[0])
    np.testing.assert_allclose(joined(got), want, **VALUE)
    assert TAGS == ({"sp_tp_in", "sp_tp_out"} if heads == "split"
                    else {"sp_latent"})


# (config overrides, (B, S)): one dropless group (T = 16 = 4E), and
# groups of 8 at a tight capacity (T = 32 > 4E: tokens drop)
MOE_CASES = [(dict(), (2, 8)),
             (dict(capacity_factor=0.5, moe_group_size=8), (2, 16))]


def moe_case(kw: dict, shape: tuple):
    cfg, jcfg = (dataclasses.replace(c, **kw)
                 for c in cfgs("deepseek-v2-lite-16b"))
    p = block_params(JL.init_moe, jcfg)
    return cfg, jcfg, p, normal(shape + (cfg.d_model,), 1, 0.3)


@pytest.mark.parametrize("experts", ["whole", "split"])
@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("kw,shape", MOE_CASES, ids=["dropless",
                                                     "capacity"])
def test_moe_blocks_route_whole_sequences(kw, shape, P, experts):
    """``moe`` (reduced deepseek-v2-lite: 4 experts, top-2, a shared
    expert) over the blocks of every sequence equals the reference's over
    the whole batch, dropless and capacity-bound: each block gathers its
    rows' whole sequences (``sp_moe_in``) and routes them in the global
    groups; with the experts and the shared expert's ``ff`` split over the
    axis that cuts the sequence their partial sums are reduce-scattered
    back (``sp_moe_out``), else each block keeps its rows of the whole
    output.  Every block's aux loss is the whole batch's."""
    cfg, jcfg, p, x = moe_case(kw, shape)
    jout, jaux = JL.moe(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    tree = split_tree(p, EXPERTS if experts == "split" else {})
    got = in_blocks(P, lambda i: TL.moe(tree, blocks_of(x, P, i), cfg),
                    B=shape[0])
    np.testing.assert_allclose(joined([o for o, _ in got]),
                               np.asarray(jout), **VALUE)
    for _, aux in got:
        np.testing.assert_allclose(float(aux.detach()), float(jaux), **VALUE)
    want = {"sp_moe_in", "moe_aux"}
    assert TAGS == (want | {"sp_moe_out"} if experts == "split" else want)


def dense_case(kind: str):
    """Reduced qwen3-4b's attention (GQA: 4 query heads over 2 KV heads,
    qk-norm) or its MLP, the reference's function of the whole sequence
    and a (2, 8) input."""
    cfg, jcfg = (dataclasses.replace(c, n_kv_heads=2)
                 for c in cfgs("qwen3-4b"))
    x = normal((2, 8, cfg.d_model), 1, 0.5)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8)).copy()
    if kind == "attention":
        p = block_params(JL.init_attention, jcfg)
        return cfg, p, x, pos, lambda jp, jx: JL.attention(
            jp, jx, jcfg, jnp.asarray(pos))[0]
    p = block_params(lambda key, c: JL.init_mlp(key, c.d_model, c.d_ff,
                                                c.act), jcfg)
    return cfg, p, x, pos, lambda jp, jx: JL.mlp(jp, jx, jcfg.act)


def run_dense(kind: str, tree, x, cfg, pos):
    if kind == "attention":
        return TL.attention(tree, x, cfg, torch.from_numpy(pos))[0]
    return TL.mlp(tree, x, cfg.act)


@pytest.mark.parametrize("kind", ["attention", "mlp"])
@pytest.mark.parametrize("P", [2, 4])
def test_split_layers_over_the_cut_axis_equal_the_whole(P, kind):
    """Attention with its query heads split over the axis that cuts the
    sequence (two ranks sharing a KV head at P = 4) and the MLP with its
    ``ff`` columns split: each rank gathers the group's rows
    (``sp_tp_in``), runs its heads or columns over the whole sequence and
    reduce-scatters the row-parallel sum back to its block
    (``sp_tp_out``); the blocks equal the reference's whole sequence."""
    cfg, p, x, pos, ref = dense_case(kind)
    want = np.asarray(ref(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    tree = split_tree(p, HEADS if kind == "attention" else FF)
    got = in_blocks(P, lambda i: run_dense(kind, tree, blocks_of(x, P, i),
                                           cfg, pos))
    np.testing.assert_allclose(joined(got), want, **VALUE)
    assert TAGS == {"sp_tp_in", "sp_tp_out"}


def assert_grads(got, want, what=""):
    """Gradients within 1e-3·|g| + 1e-4·max|g| (the reference's rule)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-4 * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def block_grads(P: int, fn, inputs: dict, params: dict,
                B: int = 1, grid: tuple | None = None) -> tuple:
    """``fn(block inputs, params) -> loss`` run over the simulated blocks
    of a group of P (each input cut on dimension 1; the rows scope's
    batch of B rows; ``grid``: a D x M grid of P = D·M blocks, as
    :func:`in_blocks` takes it) and over the whole sequence -> ((the
    blocks' losses summed, their input gradients joined, their parameter
    gradients summed), the whole's)."""
    if grid is not None:
        P = grid[0] * grid[1]
    def run(ins):
        ins = {k: v.clone().requires_grad_(v.is_floating_point())
               for k, v in ins.items()}
        loss = fn(ins, params)
        leaves = [v for v in ins.values() if v.requires_grad] + \
            list(params.values())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return (loss.detach(),) + tuple(
            torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, grads))

    whole = run({k: torch.from_numpy(v) for k, v in inputs.items()})
    outs = in_blocks(P, lambda i: run({k: blocks_of(v, P, i)
                                       for k, v in inputs.items()}), B=B,
                     grid=grid)
    n_in = sum(np.issubdtype(v.dtype, np.floating) for v in inputs.values())
    got = [sum(o[0] for o in outs)]
    got += [joined([o[1 + j] for o in outs]) for j in range(n_in)]
    got += [sum(o[j] for o in outs) for j in range(1 + n_in, len(outs[0]))]
    return got, whole


def test_a_differentiated_block_refuses():
    """A differentiated block no longer refuses: its exchanges are
    differentiable, so ``mamba_block`` (conv halo and SSD state) and
    ``rwkv_block`` (token shifts and WKV state) over two blocks of a
    12-token sequence give the whole sequence's gradient of every
    parameter and of the input."""
    for arch, name, init in (("zamba2-7b", "mamba_block", JS.init_mamba),
                             ("rwkv6-1.6b", "rwkv_block", JS.init_rwkv)):
        cfg, jcfg = cfgs(arch)
        p = {k: torch.from_numpy(np.array(v)).requires_grad_()
             for k, v in block_params(init, jcfg).items()}
        x = normal((2, 12, cfg.d_model), 1, 0.5)
        c = torch.from_numpy(normal((2, 12, cfg.d_model), 2))
        kw = {"chunk": 4} if name == "mamba_block" else {}

        def loss(ins, params):
            out = getattr(TS, name)(params, ins["x"], cfg, **kw)[0]
            seq = DB.current_seq()
            cc = c if seq is None else c.narrow(1, *seq.block(12))
            return (out * cc).sum()
        got, want = block_grads(2, loss, {"x": x}, p)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        for g, w, k in zip(got[1:], want[1:], ["x"] + list(p)):
            assert_grads(g, w, f"{name} {k}")


MAMBA_SPLIT = {"w_in": 1, "w_out": 0}
RWKV_SPLIT = {"w_r": 1, "w_k": 1, "w_v": 1, "w_g": 1, "w_o": 0, "w_ck": 1,
              "w_cv": 0, "w_cr": 1}


@pytest.mark.parametrize("arch,name,init,dims,tags", [
    ("zamba2-7b", "mamba_block", JS.init_mamba, MAMBA_SPLIT,
     {"sp_conv", "sp_state"}),
    ("rwkv6-1.6b", "rwkv_block", JS.init_rwkv, RWKV_SPLIT,
     {"sp_tp_in", "sp_tp_out"})], ids=["mamba", "rwkv"])
@pytest.mark.parametrize("P", [2, 4])
def test_ssm_blocks_split_over_the_cut_axis_equal_the_whole(P, arch, name,
                                                           init, dims, tags):
    """``mamba_block`` (chunk 4) with ``w_in``'s columns and ``w_out``'s
    rows split over the axis that cuts a 16-token sequence reads both
    whole on its block, whose convolution halo and SSD state cross the
    blocks as without a split; ``rwkv_block`` with its WKV heads
    (``w_r``/``w_k``/``w_v``/``w_g`` columns, ``w_o`` rows, one head a
    rank at P = 4) and its channel mix (``w_ck``/``w_cr`` columns,
    ``w_cv`` rows) split gathers the group's rows (``sp_tp_in``), scans
    its heads over the whole sequence from zero and reduce-scatters its
    row-parallel sums (``sp_tp_out``), its gate on the block with
    ``w_cr`` whole.  Values and every gradient (the blocks' parameter
    gradients summed, as the step's reduction sums them) equal the
    reference's block over the whole sequence."""
    cfg, jcfg = cfgs(arch)
    p = block_params(init, jcfg)
    S = 16
    x = normal((2, S, cfg.d_model), 1, 0.5)
    kw = {"chunk": 4} if name == "mamba_block" else {}
    want = np.asarray(jax.jit(lambda p, x: getattr(JS, name)(
        p, x, jcfg, **kw)[0])(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    tree = split_tree(p, dims)
    got = in_blocks(P, lambda i: getattr(TS, name)(
        tree, blocks_of(x, P, i), cfg, **kw)[0])
    np.testing.assert_allclose(joined(got), want, **VALUE)
    assert TAGS == tags
    c = torch.from_numpy(normal((2, S, cfg.d_model), 2))

    def loss(ins, params):
        out = getattr(TS, name)(tree, ins["x"], cfg, **kw)[0]
        seq = DB.current_seq()
        return (out * (c if seq is None else c.narrow(1, *seq.block(S)))
                ).sum()
    params = dict(tree.named_parameters())
    got, whole = block_grads(P, loss, {"x": x}, params)
    np.testing.assert_allclose(got[0], whole[0], rtol=1e-5)
    for g, w, k in zip(got[1:], whole[1:], ["x"] + list(params)):
        assert_grads(g, w, f"{name} {k}")


def cross_case():
    """Reduced whisper's cross-attention (4 heads, 4 KV heads), its
    reference parameters, the decoder's (2, 8) rows, the encoder's (2,
    16) frames and the reference's output over all of them."""
    cfg, jcfg = cfgs("whisper-large-v3")
    p = block_params(JL.init_attention, jcfg)
    x = normal((2, 8, cfg.d_model), 1, 0.5)
    enc = normal((2, cfg.n_audio_frames, cfg.d_model), 3, 0.5)
    jp = jax.tree.map(jnp.asarray, p)
    want = np.asarray(JE._cross_attention(jp, jnp.asarray(x), JE.cross_kv(
        jp, jnp.asarray(enc), jcfg), jcfg))
    return cfg, p, x, enc, want


def run_cross(tree, x, enc, cfg):
    """A decoder layer's cross-attention on this block's frames ``enc``
    (its K/V from ``cross_kv``) over the rows ``x``."""
    kv, frames = TE.cross_kv(tree, enc, cfg, seq=DB.current_seq())
    return TE._cross_attention(tree, x, kv, cfg, frames)


@pytest.mark.parametrize("tokens", ["cut", "whole"])
@pytest.mark.parametrize("P", [2, 4])
def test_cross_attention_split_over_the_cut_axis_equals_the_whole(P,
                                                                  tokens):
    """Whisper's cross-attention with its heads split over the axis that
    cuts the 16 frames: ``cross_kv`` gathers the frames (``sp_tp_in``)
    and projects this rank's KV heads over all of them.  With the 8
    decoder tokens cut too, the token block's rows are gathered for the
    queries (``sp_tp_in``) and ``wo``'s partial sums reduce-scattered
    back (``sp_tp_out``): values, and every gradient (the blocks'
    parameter gradients summed), equal the reference's over every frame
    and token.  With the tokens whole (a prefill's layout; training there
    is refused), every rank's queries are the same and ``wo``'s partial
    sums are all-reduced (``tp_out``): every rank's output is the
    reference's."""
    cfg, p, x, enc, want = cross_case()
    tree = split_tree(p, HEADS)
    if tokens == "cut":
        got = in_blocks(P, lambda i: run_cross(tree, blocks_of(x, P, i),
                                               blocks_of(enc, P, i), cfg))
        np.testing.assert_allclose(joined(got), want, **VALUE)
        assert TAGS == {"sp_tp_in", "sp_tp_out"}
        c = torch.from_numpy(normal(x.shape, 2))

        def loss(ins, params):
            seq = DB.current_seq()
            out = run_cross(tree, ins["x"], ins["enc"], cfg)
            return (out * (c if seq is None else c.narrow(
                1, *seq.block(x.shape[1])))).sum()
        params = dict(tree.named_parameters())
        got, whole = block_grads(P, loss, {"x": x, "enc": enc}, params)
        np.testing.assert_allclose(got[0], whole[0], rtol=1e-5)
        for g, w, k in zip(got[1:], whole[1:], ["x", "enc"] + list(params)):
            assert_grads(g, w, f"cross-attention {k}")
        return

    def whole_tokens(i):
        seq = DB.current_seq()
        kv, frames = TE.cross_kv(tree, blocks_of(enc, P, i), cfg, seq=seq)
        assert frames is None
        with DB.rows_set(DB.Rows(None, 1, 0, 1, None)), \
                mock.patch.object(SplitTree, "over", seq):
            return TE._cross_attention(tree, torch.from_numpy(x), kv, cfg,
                                       frames)
    for out in in_blocks(P, whole_tokens):
        np.testing.assert_allclose(out.detach().numpy(), want, **VALUE)
    assert TAGS == {"sp_tp_in", "tp_out"}


# ---------------------------------------------------------------------------
# context parallelism: the sequence cut over both axes of a D x M grid,
# the layers and the vocabulary split over its model axis
# ---------------------------------------------------------------------------

# D x M: two super-blocks of two blocks, and one super-block of four (the
# model axis alone cuts the sequence: the one-axis path)
GRIDS = [(2, 2), (1, 4)]


@dataclasses.dataclass
class CPCase:
    """A layer of the context-parallel tests: its SplitTree, ``run(tree,
    block inputs) -> output`` (the MoE's ``(out, aux)``), the whole
    inputs, the reference's whole output (and aux), the rows scope's
    batch, the forward exchanges' tags on every grid and those made only
    where the data axis cuts the sequence too (between super-blocks)."""
    tree: SplitTree
    run: object
    inputs: dict
    want: object
    B: int
    tags: set
    outer: set = dataclasses.field(default_factory=set)
    aux: float | None = None


def _cp_dense(kind: str) -> CPCase:
    cfg, p, x, pos, ref = dense_case(kind)
    want = np.asarray(ref(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    return CPCase(split_tree(p, HEADS if kind == "attention" else FF),
                  lambda t, ins: run_dense(kind, t, ins["x"], cfg, pos),
                  {"x": x}, want, 1, {"sp_tp_in", "sp_tp_out"},
                  {"sp_kv"} if kind == "attention" else set())


def _cp_mla() -> CPCase:
    cfg, jcfg, p, x, pos = mla_case(16)
    want = np.asarray(JL.mla_attention(jax.tree.map(jnp.asarray, p),
                                       jnp.asarray(x), jcfg,
                                       jnp.asarray(pos))[0])
    tpos = torch.from_numpy(pos)
    return CPCase(split_tree(p, MLA_HEADS),
                  lambda t, ins: TL.mla_attention(t, ins["x"], cfg, tpos)[0],
                  {"x": x}, want, 1, {"sp_tp_in", "sp_tp_out"},
                  {"sp_latent"})


def _cp_moe(kw: dict, shape: tuple) -> CPCase:
    cfg, jcfg, p, x = moe_case(kw, shape)
    jout, jaux = JL.moe(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    return CPCase(split_tree(p, EXPERTS),
                  lambda t, ins: TL.moe(t, ins["x"], cfg), {"x": x},
                  np.asarray(jout), shape[0],
                  {"sp_moe_in", "sp_moe_out", "moe_aux"}, aux=float(jaux))


def _cp_ssm(arch: str, name: str, init, dims: dict, tags: set,
            outer: set) -> CPCase:
    cfg, jcfg = cfgs(arch)
    p = block_params(init, jcfg)
    x = normal((2, 16, cfg.d_model), 1, 0.5)
    kw = {"chunk": 4} if name == "mamba_block" else {}
    want = np.asarray(jax.jit(lambda p, x: getattr(JS, name)(
        p, x, jcfg, **kw)[0])(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    return CPCase(split_tree(p, dims), lambda t, ins: getattr(TS, name)(
        t, ins["x"], cfg, **kw)[0], {"x": x}, want, 1, tags, outer)


def _cp_cross() -> CPCase:
    cfg, p, x, enc, want = cross_case()
    return CPCase(split_tree(p, HEADS),
                  lambda t, ins: run_cross(t, ins["x"], ins["enc"], cfg),
                  {"x": x, "enc": enc}, want, 1, {"sp_tp_in", "sp_tp_out"},
                  {"sp_cross_kv"})


def _cp_vocab(kind: str) -> CPCase:
    """Reduced qwen3-4b's vocabulary split over the model axis: the
    embedding of a block of (2, 8) tokens, or the logits of a block of
    (2, 8) hidden states (through ``lm_head``, untied)."""
    from repro.models import transformer as JT
    from repro_torch.models import transformer as TT
    cfg, jcfg = (dataclasses.replace(c, tie_embeddings=False)
                 for c in cfgs("qwen3-4b"))
    V, d = cfg.vocab_size, cfg.d_model
    p = {"embed": normal((V, d), 0, 0.5), "lm_head": normal((d, V), 1, 0.2)}
    if kind == "embed":
        tokens = np.random.default_rng(2).integers(0, V, (2, 8)).astype(
            np.int32)
        return CPCase(split_tree(p, {"embed": 0}),
                      lambda t, ins: TT.embed(t, ins["tokens"]),
                      {"tokens": tokens}, p["embed"][tokens], 1,
                      {"sp_tokens", "sp_embed"})
    h = normal((2, 8, d), 3, 0.5)
    want = np.asarray(JT.logits_fn(jax.tree.map(jnp.asarray, p), jcfg,
                                   jnp.asarray(h)))

    def run(t, ins):
        logits, sp = TT.vocab_logits(t, cfg, ins["h"])
        assert sp is None           # the block's whole vocabulary
        return logits
    return CPCase(split_tree(p, {"lm_head": 1}), run, {"h": h}, want, 1,
                  {"sp_vocab"})


CP_CASES = {
    "attention": lambda: _cp_dense("attention"),
    "mla": _cp_mla,
    "mlp": lambda: _cp_dense("mlp"),
    "moe_dropless": lambda: _cp_moe(*MOE_CASES[0]),
    "moe_capacity": lambda: _cp_moe(*MOE_CASES[1]),
    "mamba": lambda: _cp_ssm("zamba2-7b", "mamba_block", JS.init_mamba,
                             MAMBA_SPLIT, {"sp_conv", "sp_state"}, set()),
    "rwkv": lambda: _cp_ssm("rwkv6-1.6b", "rwkv_block", JS.init_rwkv,
                            RWKV_SPLIT, {"sp_tp_in", "sp_tp_out"},
                            {"sp_shift", "sp_state"}),
    "cross": _cp_cross,
    "embed": lambda: _cp_vocab("embed"),
    "vocab": lambda: _cp_vocab("logits"),
}
# forward exchanges without a backward collective
NO_GRAD_TAG = {"moe_aux", "sp_tokens"}


@pytest.mark.parametrize("grid", GRIDS, ids=["2x2", "1x4"])
@pytest.mark.parametrize("kind", list(CP_CASES))
def test_context_parallel_blocks_equal_the_whole(kind, grid):
    """Each family's layer, split over the model axis, over a sequence
    cut over the data and model axes of a simulated D x M grid: each
    model group gathers its blocks into a super-block (``sp_tp_in``),
    runs its heads, ``ff`` columns, experts or vocabulary block over it,
    and exchanges what crosses super-blocks over the data axis (the keys
    and values ``sp_kv``, MLA's latents ``sp_latent``, RWKV6's shift row
    and WKV state ``sp_shift`` / ``sp_state``, whisper's cross K/V
    ``sp_cross_kv``); the MoE routes the whole sequences and
    reduce-scatters its super-block's sums over the model axis
    (``sp_moe_out``); Mamba2 reads its split weights whole on its block.
    At 1 x 4 the model axis alone cuts the sequence and nothing crosses
    the data axis.  Values (and the MoE's aux loss, dropless and
    capacity-bound) at rtol 2e-4 / atol 2e-5, and the gradients of the
    inputs and of every weight (the blocks' summed, as the step's
    reduction sums them) within 1e-3·|g| + 1e-4·max|g|, equal the
    reference's whole sequence; the exchanges' tags are the predicted
    ones, forward and backward."""
    case = CP_CASES[kind]()
    P = grid[0] * grid[1]
    fwd = case.tags | (case.outer if grid[0] > 1 else set())
    got = in_blocks(P, lambda i: case.run(case.tree, {
        k: blocks_of(v, P, i) for k, v in case.inputs.items()}), B=case.B,
        grid=grid)
    assert TAGS == fwd, (kind, grid, TAGS)
    if case.aux is not None:
        for _, aux in got:
            np.testing.assert_allclose(float(aux.detach()), case.aux,
                                       **VALUE)
        got = [o for o, _ in got]
    np.testing.assert_allclose(joined(got), case.want, **VALUE)
    S = next(iter(case.inputs.values())).shape[1]
    c = torch.from_numpy(normal(case.want.shape, 9))

    def loss(ins, _):
        out = case.run(case.tree, ins)
        out, aux = out if case.aux is not None else (out, 0.0)
        seq = DB.current_seq()
        return (out * (c if seq is None else c.narrow(1, *seq.block(S)))
                ).sum() + aux
    params = dict(case.tree.named_parameters())
    got, whole = block_grads(P, loss, case.inputs, params, B=case.B,
                             grid=grid)
    assert TAGS == fwd | {t + "_grad" for t in fwd - NO_GRAD_TAG}, \
        (kind, grid, TAGS)
    names = [k for k, v in case.inputs.items()
             if np.issubdtype(v.dtype, np.floating)] + list(params)
    # every block's loss adds the aux loss, which is the whole batch's
    extra = (P - 1) * case.aux if case.aux is not None else 0.0
    np.testing.assert_allclose(float(got[0]) - extra, whole[0], rtol=1e-5,
                               atol=1e-6)
    for g, w, k in zip(got[1:], whole[1:], names):
        assert_grads(g, w, f"{kind} {grid} {k}")


# ---------------------------------------------------------------------------
# the paths that refuse a sequence split, and the losses and the train
# step over one
# ---------------------------------------------------------------------------

def _reduced(arch):
    return tconfigs.reduce_config(tconfigs.get_config(arch))


def _decode():
    from repro_torch import models as M
    from repro_torch.serve.engine import make_serve_step
    cfg = _reduced("qwen3-4b")
    model = M.init_params(0, cfg, device="cpu")
    make_serve_step(cfg)(model, M.init_cache(cfg, 1, 8, torch.float32,
                                             device="cpu"),
                         torch.ones((1, 1), dtype=torch.int32))


def _encdec_tokens_cut():
    """The LM loss of reduced whisper laid out by the default rules (its
    encoder's heads and ``ff`` over the model axis) on a 1 x 2 mesh, its
    8 tokens cut over the model axis and its 7 frames whole (a count the
    split does not divide): each rank's gradient of the encoder's output
    would be its tokens' share, which the encoder's tensor-parallel
    backward takes as the whole."""
    from repro_torch import models as M
    from repro_torch.distributed import model_parallel as MP
    from repro_torch.distributed.ctx import AbstractMesh
    cfg = dataclasses.replace(_reduced("whisper-large-v3"), n_audio_frames=7)
    model = MP.shard_model(M.init_params(0, cfg, device="cpu"),
                           AbstractMesh((1, 2), ("data", "model")), {})
    tokens = torch.ones((1, 8), dtype=torch.int32)
    batch = {"frames": torch.zeros((1, 7, cfg.d_model)), "tokens": tokens,
             "labels": tokens}

    @contextlib.contextmanager
    def scope(placed):      # the tokens' block of 4 of 8, the frames whole
        with DB.rows_set(DB.Rows(None, 1, 0, 1, split(2, 1) if placed is
                                 tokens else None)):
            yield DB.current_rows()
    with mock.patch.object(DB, "rows_scope", scope):
        TE.lm_loss(model, cfg, batch)


@pytest.mark.parametrize("where,run", [
    ("make_serve_step", _decode),
    ("frames not cut over the model axis", _encdec_tokens_cut)],
    ids=["decode", "encdec_tokens_cut"])
def test_paths_refuse_a_sequence_split(where, run):
    """Decode, and whisper's training with its tokens cut over the model
    axis, its frames whole and its encoder split over that axis raise
    ``NotImplementedError`` naming what is left of ROADMAP item 21,
    inside the scope of a batch whose sequence is cut, before computing.
    (MLA and the MoE, which refused until the layers ran a sequence split,
    are the parity cases ``test_mla_blocks_equal_the_whole_sequence`` and
    ``test_moe_blocks_route_whole_sequences``; the hybrid, rwkv and
    encdec families split over the axis that cuts the sequence alone,
    which refused until their layers ran it, are
    ``test_ssm_blocks_split_over_the_cut_axis_equal_the_whole`` and
    ``test_cross_attention_split_over_the_cut_axis_equals_the_whole``;
    every family's layers and the vocabulary under a sequence cut over
    the data and model axes, which refused until the layers ran context
    parallelism, are ``test_context_parallel_blocks_equal_the_whole``.)"""
    with DB.rows_set(DB.Rows(None, 1, 0, 1, split(2, 1))):
        with pytest.raises(NotImplementedError, match="item 21") as e:
            run()
    assert where in str(e.value)
    assert "tensor parallelism" in str(e.value)


def _lm_loss():
    """transformer.lm_loss of reduced qwen3-4b's blocks, each weighted by
    its share of the valid tokens (block 1 of row 0 has none)."""
    from repro_torch import models as M
    from repro_torch.models import transformer
    cfg = _reduced("qwen3-4b")
    model = M.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, cfg.vocab_size, (2, 8)).astype(np.int32)
    labels = rng.integers(1, cfg.vocab_size, (2, 8)).astype(np.int32)
    labels[0, 4:] = -1
    n = max(int((labels >= 0).sum()), 1)

    def loss(ins, params):
        total, m = transformer.lm_loss(model, cfg, ins)
        return total * m["ntok"] / n
    return model, loss, dict(tokens=tokens, labels=labels)


def _encdec_loss():
    """encdec.lm_loss of reduced whisper's blocks of frames and tokens."""
    from repro_torch import models as M
    from repro_torch.models import encdec
    cfg = _reduced("whisper-large-v3")
    model = M.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(4)
    batch = dict(frames=normal((2, cfg.n_audio_frames, cfg.d_model), 5),
                 tokens=rng.integers(1, cfg.vocab_size, (2, 8)).astype(
                     np.int32),
                 labels=rng.integers(1, cfg.vocab_size, (2, 8)).astype(
                     np.int32))
    n = batch["labels"].size

    def loss(ins, params):
        total, m = encdec.lm_loss(model, cfg, ins)
        return total * m["ntok"] / n
    return model, loss, batch


def _sig_mmd_loss():
    """The sig-MMD loss of reduced qwen3-4b with its head, stride 3 over
    blocks of 4 (block 1 starts off the stride) and a ragged mask: every
    block computes the whole path's MMD."""
    from repro_torch import models as M
    from repro_torch.models.sig_head import init_sig_head
    from repro_torch.train.trainer import make_sig_mmd_loss
    cfg = tconfigs.with_sig_head(_reduced("qwen3-4b"), channels=3, depth=2,
                                 stride=3)
    model = M.init_params(0, cfg, device="cpu")
    model["sig_head"] = init_sig_head(1, cfg, 2, device="cpu")
    rng = np.random.default_rng(5)
    mask = (np.arange(8)[None] < np.array([[8], [7], [5], [8]])).astype(
        np.int32)
    batch = dict(tokens=rng.integers(1, cfg.vocab_size, (4, 8)).astype(
        np.int32), mask=mask)
    paths = torch.from_numpy(np.cumsum(normal((5, 6, 3), 6, 0.3), 1))
    fn = make_sig_mmd_loss(cfg)

    def loss(ins, params):
        return fn(model, dict(ins, paths=paths), "dots")[0]
    return model, loss, batch


@pytest.mark.parametrize("run", [_lm_loss, _encdec_loss, _sig_mmd_loss],
                         ids=["lm_loss", "encdec_loss", "sig_mmd_loss"])
def test_paths_run_a_sequence_split(run):
    """The LM loss, the encoder-decoder's and the sig-MMD loss run over
    two blocks of every sequence: the blocks' weighted losses add to the
    whole sequence's loss (the sig-MMD's is the same on every block), and
    the blocks' gradients of every parameter to its gradient."""
    model, loss, batch = run()
    params = dict(model.named_parameters())
    got, want = block_grads(2, loss, batch, params)
    names = list(params)
    summed = float(got[0]) / (2 if run is _sig_mmd_loss else 1)
    assert abs(summed - float(want[0])) <= 1e-4 * max(1.0,
                                                      abs(float(want[0])))
    n_in = len(got) - len(names)
    for g, w, k in zip(got[n_in:], want[n_in:], names):
        assert_grads(g, w, k)


class _Mesh:
    """The simulated group as a 1-D mesh of the model axis."""
    ndim = 1
    mesh_dim_names = ("model",)

    def __init__(self, P):
        self.shape = (P,)

    def get_group(self):
        return None


class _Placed:
    """A batch leaf placed on its sequence over the simulated group: the
    train step reads its loss and gradient groups from it."""

    def __init__(self, P):
        from torch.distributed.tensor import Shard
        self.device_mesh, self.placements = _Mesh(P), (Shard(1),)


def test_train_step_runs_a_sequence_split():
    """``make_train_step``'s SGD step of reduced qwen3-4b on two blocks of
    every sequence (the batch's layout a stand-in placed leaf of the
    simulated group): each block's loss is the whole batch's and each
    block's updated parameters are the whole sequence's step, the
    ignored labels of one block included."""
    import copy
    from repro_torch import optim, train
    from repro_torch.train import trainer
    model, _, batch = _lm_loss()
    opt = optim.sgd(lr=0.1)

    def step(b):
        m = copy.deepcopy(model)
        _, _, metrics = train.make_train_step(_reduced("qwen3-4b"), opt)(
            m, opt.init(m), b)
        return float(metrics["loss"]), {k: v.detach().clone() for k, v in
                                        m.named_parameters()}
    want_loss, want = step({k: torch.from_numpy(v) for k, v in
                            batch.items()})
    with mock.patch.object(trainer, "_placed", lambda b: _Placed(2)):
        outs = in_blocks(2, lambda i: step({k: blocks_of(v, 2, i) for k, v
                                            in batch.items()}))
    for loss, params in outs:
        assert abs(loss - want_loss) <= 1e-4 * max(1.0, abs(want_loss))
        for k, w in want.items():
            start = model.get_parameter(k).detach()
            assert_grads((params[k] - start).numpy(), (w - start).numpy(), k)
