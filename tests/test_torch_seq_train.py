"""The backward of the sequence blocks' exchanges (training under the
reference's ``seq: "model"`` rule) against the whole sequence's autograd
gradient, in one process.

The group of P ranks is simulated as in ``test_torch_seq_prefill.py``
(``in_blocks``: each block's collectives, forward and backward, answered
from every block's inputs to the same call).  Two backward rules are held:

- (a) ``model_parallel.seq_gather``: every rank computes only its own
  block's share from the gathered tensor (the keys and values, the halo
  rows, the recurrences' states, whisper's gathered queries and merged
  partials), so the gradient of each block is summed over the group (a
  reduce-scatter); ``seq_scatter`` (the embedding's reduce-scatter) takes
  an all-gather back;
- (b) ``model_parallel.gather_from``: every rank computes the same value
  from the gathered tensor (the sig-MMD path), so each keeps its own
  block's gradient and nothing is summed.

Where the model axis that cuts the sequence also splits a layer (heads,
``ff`` columns, experts), the layer's entry gathers the block
(``tp_enter``: reduce-scatter backward, which sums the ranks' partial
input gradients) and its exit reduce-scatters the row-parallel sum
(``tp_exit``: all-gather backward); a weight every rank reads whole in
between takes each rank's partial gradient, which the step sums over the
model axis once (here: the blocks' gradients summed).  MLA, the MoE (its
aux loss too), attention and the MLP are held that way, with the layer
whole and split.

Gradients within 1e-3·|g| + 1e-4·max|g|.
"""
import numpy as np
import pytest
import torch

from test_torch_seq_prefill import (EXPERTS, FF, HEADS, MLA_HEADS,
                                    MOE_CASES, assert_grads, block_grads,
                                    cfgs, dense_case, in_blocks, joined,
                                    mla_case, moe_case, normal, run_dense,
                                    split_tree, ssd_inputs, wkv_inputs)

from repro_torch.distributed import batch as DB
from repro_torch.distributed.model_parallel import (gather_from,
                                                    seq_gather, seq_scatter)
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS


def own(x: torch.Tensor, S: int) -> torch.Tensor:
    """This block's rows of a whole-sequence tensor ``x`` (B, S, ...), or
    ``x`` outside a split."""
    seq = DB.current_seq()
    return x if seq is None else x.narrow(1, *seq.block(S))


def check(got, want, names):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    for g, w, k in zip(got[1:], want[1:], names):
        assert_grads(g, w, k)


@pytest.mark.parametrize("P", [2, 4])
def test_gather_sums_the_blocks_gradients(P):
    """Rule (a): each block takes its own rows of a causal running sum of
    the gathered sequence; the blocks' gradients, summed by the
    reduce-scatter, are the whole sequence's."""
    S = 8
    x = normal((2, S, 3), 0)
    c = torch.from_numpy(normal((2, S, 3), 1))

    def loss(ins, _):
        seq = DB.current_seq()
        whole = ins["x"] if seq is None else seq_gather(ins["x"], seq, 1,
                                                         "sp_test")
        return (own(torch.cumsum(whole, 1), S) * own(c, S)).sum()
    check(*block_grads(P, loss, {"x": x}, {}), ["x"])


@pytest.mark.parametrize("P", [2, 4])
def test_gather_from_keeps_each_blocks_gradient(P):
    """Rule (b): every block computes the same loss of the whole gathered
    sequence; each keeps its own block's gradient, and they join to the
    whole's with no sum (a sum would count the loss P times)."""
    S = 8
    x = normal((2, S, 3), 2)
    c = torch.from_numpy(normal((2, S, 3), 3))

    def loss(ins, _):
        seq = DB.current_seq()
        whole = ins["x"] if seq is None else gather_from(ins["x"], seq, 1,
                                                         "sp_path")
        return (torch.cumsum(whole, 1) ** 2 * c).sum()
    got, want = block_grads(P, loss, {"x": x}, {})
    np.testing.assert_allclose(got[0] / P, want[0], rtol=1e-5)
    assert_grads(got[1], want[1], "x")


@pytest.mark.parametrize("P", [2, 4])
def test_scatter_takes_every_blocks_gradient_back(P):
    """``seq_scatter`` (the vocabulary-parallel embedding's reduce-scatter
    of the group's rows): each rank's partial sums over the whole
    sequence take the gradient of every block, all-gathered."""
    S = 8
    parts = [normal((2, S, 3), 10 + i) for i in range(P)]
    c = torch.from_numpy(normal((2, S, 3), 4))
    want = c.numpy()

    def run(i):
        x = torch.from_numpy(parts[i]).requires_grad_()
        y = seq_scatter(x, DB.current_seq(), 1, "sp_embed")
        (g,) = torch.autograd.grad((y * own(c, S)).sum(), [x])
        return y.detach(), g
    outs = in_blocks(P, run)
    np.testing.assert_allclose(joined([y for y, _ in outs]), sum(parts),
                               rtol=1e-6, atol=1e-6)
    for _, g in outs:
        np.testing.assert_array_equal(g.numpy(), want)


@pytest.mark.parametrize("P", [2, 4])
def test_attention_blocks_gradients(P):
    """``_prefill_attend`` (``sp_kv``): each block's queries over the
    gathered keys and values under the offset causal mask; the gradients
    of q, k and v are the whole sequence's."""
    B, S, Hq, Hkv, hd = 2, 16, 4, 2, 8
    ins = {"q": normal((B, S, Hq, hd), 0), "k": normal((B, S, Hkv, hd), 1),
           "v": normal((B, S, Hkv, hd), 2)}
    c = torch.from_numpy(normal((B, S, Hq * hd), 3))

    def loss(t, _):
        out = TL._prefill_attend(t["q"], t["k"], t["v"], True,
                                 DB.current_seq())
        return (out * own(c, S)).sum()
    check(*block_grads(P, loss, ins, {}), list(ins))


@pytest.mark.parametrize("P", [2, 4])
def test_halo_rows_gradients(P):
    """The causal convolution over each block with its halo rows
    (``sp_conv``, K - 1 = 3 rows, from blocks shorter than that at P = 4)
    and the token shift (``sp_shift``): the gradients of the input and the
    weights are the whole sequence's."""
    S = 8
    x = normal((2, S, 6), 4)
    params = {"w": torch.from_numpy(normal((4, 6), 6)).requires_grad_(),
              "b": torch.from_numpy(normal((6,), 7)).requires_grad_()}
    c = torch.from_numpy(normal((2, S, 6), 8))

    def loss(t, p):
        seq = DB.current_seq()
        halo = None if seq is None else TL.halo_rows(t["x"], 3, seq,
                                                     "sp_conv")
        prev = t["x"].new_zeros((2, 6)) if seq is None else \
            TL.halo_rows(t["x"], 1, seq, "sp_shift")[:, 0]
        out = TS._causal_conv(t["x"], p["w"], p["b"], halo) \
            + TS._token_shift(t["x"], prev) ** 2
        return (out * own(c, S)).sum()
    check(*block_grads(P, loss, {"x": x}, params), ["x", "w", "b"])


@pytest.mark.parametrize("P", [2, 4])
def test_ssd_blocks_gradients(P):
    """``_ssd_blocks`` (``sp_state``): the gradient of an incoming state
    reaches the earlier blocks through the reduce-scatter of the gathered
    states; every input's gradient is the whole scan's."""
    S, chunk = 16, 4
    names = ("xh", "dt", "a_log", "Bc", "Cc")
    ins = dict(zip(names, ssd_inputs(S)))
    c = torch.from_numpy(normal(ins["xh"].shape, 9))

    def loss(t, _):
        seq = DB.current_seq()
        args = [t[k] for k in names]
        y = TS._ssd_chunked(*args, chunk) if seq is None else \
            TS._ssd_blocks(*args, chunk, seq)
        return (y * own(c, S)).sum()
    check(*block_grads(P, loss, ins, {}), names)


@pytest.mark.parametrize("P", [2, 4])
def test_wkv_blocks_gradients(P):
    """``_wkv_blocks`` (``sp_state``) in float64: the outputs' gradients
    with respect to r, k, v, the decays and the bonus are the whole
    scan's, and so is the final state's of the last block."""
    S = 12
    r, k, v, w, u = wkv_inputs(S)
    ins = {"r": r, "k": k, "v": v, "w": w}
    params = {"u": torch.from_numpy(u).requires_grad_()}
    c = torch.from_numpy(normal((2, S, 2, 4), 9, 1.0, np.float64))
    cs = torch.from_numpy(normal((2, 2, 4, 4), 10, 1.0, np.float64))
    state = torch.zeros((2, 2, 4, 4))

    def loss(t, p):
        seq = DB.current_seq()
        args = [t[n] for n in ins] + [p["u"], state]
        y, fin = TS._wkv_scan(*args) if seq is None else \
            TS._wkv_blocks(*args, seq)
        last = seq is None or seq.index == seq.size - 1
        return (y * own(c, S)).sum() + (fin * cs).sum() * last
    check(*block_grads(P, loss, ins, params), list(ins) + ["u"])


def test_cross_attention_blocks_gradients():
    """Whisper's cross-attention of a block of the decoder's tokens over
    a block of the frames (``sp_cross_q`` gathers the queries,
    ``sp_cross`` the blocks' softmax partials): the gradients of the
    tokens' states, the frames' keys and values and the weights are the
    whole sequence's."""
    cfg, _ = cfgs("whisper-large-v3")
    H, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    S, F = 8, 16
    ins = {"x": normal((2, S, cfg.d_model), 0), "k": normal((2, F, H, hd),
                                                             1),
           "v": normal((2, F, H, hd), 2)}
    p = {"wq": torch.from_numpy(normal((cfg.d_model, cfg.n_heads * hd), 3,
                                       0.2)).requires_grad_(),
         "wo": torch.from_numpy(normal((cfg.n_heads * hd, cfg.d_model), 4,
                                       0.2)).requires_grad_()}
    c = torch.from_numpy(normal((2, S, cfg.d_model), 5))

    def loss(t, params):
        seq = DB.current_seq()
        out = TE._cross_attention(params, t["x"], (t["k"], t["v"]), cfg,
                                  seq)
        return (out * own(c, S)).sum()
    check(*block_grads(2, loss, ins, p), list(ins) + list(p))


@pytest.mark.parametrize("q_lora", [0, 16], ids=["wq", "w_dq"])
@pytest.mark.parametrize("heads", ["whole", "split"])
@pytest.mark.parametrize("P", [2, 4])
def test_mla_blocks_gradients(P, heads, q_lora):
    """MLA over the blocks of an 8-token sequence, its heads whole (the
    gathered latents, ``sp_latent``) and split over the axis that cuts the
    sequence (``sp_tp_in`` / ``sp_tp_out``; ``w_dkv``, ``w_krope``,
    ``kv_norm``, ``w_dq`` and ``q_norm`` read whole by every rank): the
    gradients of the input and of every weight are the whole
    sequence's."""
    cfg, _, p, x, pos = mla_case(q_lora)
    tree = split_tree(p, MLA_HEADS if heads == "split" else {})
    params = dict(tree.named_parameters())
    c = torch.from_numpy(normal(x.shape, 9))
    tpos = torch.from_numpy(pos)

    def loss(t, _):
        out = TL.mla_attention(tree, t["x"], cfg, tpos)[0]
        return (out * own(c, x.shape[1])).sum()
    check(*block_grads(P, loss, {"x": x}, params), ["x"] + list(params))


@pytest.mark.parametrize("experts", ["whole", "split"])
@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("kw,shape", MOE_CASES, ids=["dropless",
                                                     "capacity"])
def test_moe_blocks_gradients(kw, shape, P, experts):
    """The MoE over the blocks of every sequence, dropless and
    capacity-bound, its experts whole and split over the axis that cuts
    the sequence: the gradients of the input, the router, the experts and
    the shared expert of an output loss plus the aux loss (which every
    block adds, each its own tokens' share of its gradient) are the whole
    batch's."""
    cfg, _, p, x = moe_case(kw, shape)
    tree = split_tree(p, EXPERTS if experts == "split" else {})
    params = dict(tree.named_parameters())
    c = torch.from_numpy(normal(x.shape, 7))

    def loss(t, _):
        out, aux = TL.moe(tree, t["x"], cfg)
        return (out * own(c, shape[1])).sum() + aux
    got, want = block_grads(P, loss, {"x": x}, params, B=shape[0])
    for g, w, k in zip(got[1:], want[1:], ["x"] + list(params)):
        assert_grads(g, w, k)


@pytest.mark.parametrize("kind", ["attention", "mlp"])
@pytest.mark.parametrize("P", [2, 4])
def test_entry_and_exit_of_a_split_layer_gradients(P, kind):
    """The entry/exit pair (``tp_enter`` / ``tp_exit``) around attention
    with its heads split over the axis that cuts the sequence (GQA, two
    ranks sharing a KV head at P = 4; ``wk``, ``wv`` and the qk-norms read
    whole) and around the MLP with its ``ff`` split: the gradients of the
    input and of every weight are the whole computation's."""
    cfg, p, x, pos, _ = dense_case(kind)
    tree = split_tree(p, HEADS if kind == "attention" else FF)
    params = dict(tree.named_parameters())
    c = torch.from_numpy(normal(x.shape, 8))

    def loss(t, _):
        return (run_dense(kind, tree, t["x"], cfg, pos)
                * own(c, x.shape[1])).sum()
    check(*block_grads(P, loss, {"x": x}, params), ["x"] + list(params))
