"""The port's ``sig_gram`` module and ``ops.gram`` against the reference.

On the CPU the wrapper runs its plain version (the word-blocked product);
it is held against the JAX Pallas kernel ``sig_gram_tiles`` in interpret
mode over ragged edges, and ``ops.gram``'s values and its three gradients
against the reference dispatch on the ``jax`` and ``pallas_interpret``
engines.  Tolerances: the reference's Gram acceptance |G − G_ref| <=
1e-5·max|G_ref| for values, and rtol 2e-4, atol 2e-4 for the gradients
(``tests/test_sigkernel.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.sig_gram import sig_gram_tiles
from repro_torch.kernels import ops
from repro_torch.kernels import sig_gram as sg


def _operands(seed, Bx, By, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(Bx, D)).astype(np.float32),
            rng.normal(size=(By, D)).astype(np.float32),
            rng.uniform(0.2, 2.0, D).astype(np.float32))


def _close(got, want, scale=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=scale * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("D", [1, 37, 130])
@pytest.mark.parametrize("Bx,By", [(1, 1), (1, 9), (5, 5), (9, 1), (9, 5)])
def test_plain_matches_pallas_interpret_on_ragged_edges(Bx, By, D):
    x, y, w = _operands(Bx * 100 + By * 10 + D, Bx, By, D)
    for block in (16, 512):
        want = sig_gram_tiles(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                              k_tile=block, interpret=True)
        got = sg.sig_gram_plain(torch.from_numpy(x), torch.from_numpy(y),
                                torch.from_numpy(w), block)
        assert got.shape == (Bx, By) and got.dtype == torch.float32
        _close(got.numpy(), want)


def test_wrapper_runs_the_plain_version_on_cpu():
    x, y, w = _operands(1, 6, 4, 70)
    tx, ty, tw = map(torch.from_numpy, (x, y, w))
    before = sg.launches
    got = sg.sig_gram(tx.double(), ty, tw)
    assert got.dtype == torch.float32 and sg.launches == before
    _close(got.numpy(), sg.sig_gram_plain(tx.double(), ty.double(),
                                          tw.double()).numpy())
    _close(got.numpy(), (x * w) @ y.T)


@pytest.mark.parametrize("shapes", [((3, 5), (4, 6), (5,)),
                                    ((3, 5), (4, 5), (4,)),
                                    ((5,), (4, 5), (5,))])
def test_wrapper_shape_checks(shapes):
    a, b, c = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match="shape mismatch"):
        sg.sig_gram(a, b, c)


def _jax_grads(fn, x, y, w):
    return jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) ** 2),
                    argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(w))


def _torch_grads(fn, x, y, w):
    tx, ty, tw = (torch.tensor(a, requires_grad=True) for a in (x, y, w))
    out = fn(tx, ty, tw)
    (out ** 2).sum().backward()
    return out, (tx.grad, ty.grad, tw.grad)


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32"])
@pytest.mark.parametrize("backend", ["jax", "pallas_interpret"])
def test_gram_values_and_grads_match_reference(backend, precision):
    x, y, w = _operands(7, 5, 4, 37)

    def ref(a, b, c):
        return jops.gram(a, b, c, backend=backend, block_words=16,
                         precision=precision)

    def ours(a, b, c):
        return ops.gram(a, b, c, backend="torch", block_words=16,
                        precision=precision, device="cpu")

    out, g = _torch_grads(ours, x, y, w)
    _close(out.detach().numpy(), ref(*map(jnp.asarray, (x, y, w))))
    for got, want in zip(g, _jax_grads(ref, x, y, w)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)


def test_gram_of_one_operand_sums_both_gradients():
    x, _, w = _operands(8, 6, 1, 20)
    ref = _jax_grads(lambda a, b, c: jops.gram(a, a, c, backend="jax"),
                     x, x, w)
    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(
        w, requires_grad=True)
    (ops.gram(tx, tx, tw, device="cpu") ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref[0]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(ref[2]),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("block", [1, 7, 512, None])
def test_gram_block_width_and_hybrid_do_not_change_values(block):
    x, y, w = _operands(9, 3, 8, 45)
    want = (x.astype(np.float64) * w) @ y.T.astype(np.float64)
    for backend in ("auto", "torch", "hybrid"):
        got = ops.gram(torch.from_numpy(x), torch.from_numpy(y),
                       torch.from_numpy(w), backend=backend,
                       block_words=block, device="cpu")
        _close(got.numpy(), want)


@pytest.mark.parametrize("kw,err", [
    (dict(block_words=0), "block_words"), (dict(bx_tile=0), "bx_tile"),
    (dict(by_tile=-1), "by_tile"), (dict(backend="cuda"), "CUDA device"),
    (dict(backend="nope"), "unknown backend"),
    (dict(precision="fp8"), "unknown precision")])
def test_gram_argument_errors(kw, err):
    x, y, w = map(torch.from_numpy, _operands(10, 2, 2, 4))
    with pytest.raises(ValueError, match=err):
        ops.gram(x, y, w, device="cpu", **kw)


def test_gram_shape_errors():
    x, y, w = map(torch.from_numpy, _operands(11, 2, 2, 4))
    with pytest.raises(ValueError, match="gram needs"):
        ops.gram(x, y[:, :3], w, device="cpu")
    with pytest.raises(ValueError, match="gram needs"):
        ops.gram(x, y, w[:3], device="cpu")


# --- the launch planner: tiles, split-K word slices, copy widths ---------

@pytest.mark.parametrize("Bx,By,D", [(1, 1, 1), (64, 2048, 9330),
                                     (2048, 2048, 9330), (128, 128, 1685),
                                     (129, 7, 1025), (300, 300, 512),
                                     (5, 5, 513), (64, 64, 511)])
def test_word_slices_cover_the_words_in_whole_blocks(Bx, By, D):
    slices = sg.word_slices(Bx, By, D)
    assert slices[0][0] == 0 and slices[-1][1] == D
    for (lo, hi), (nxt, _) in zip(slices, slices[1:]):
        assert hi == nxt and lo < hi and (hi - lo) % sg.KBLOCK == 0
    width = slices[0][1] - slices[0][0]
    assert all(hi - lo == width for lo, hi in slices[:-1])
    assert 0 < slices[-1][1] - slices[-1][0] <= width


@pytest.mark.parametrize("Bx,By,D", [(2048, 2048, 9330), (4096, 1024, 9330),
                                     (1536, 1536, 1685)])
def test_one_word_slice_when_the_tiles_fill_the_card(Bx, By, D):
    rows = sg.tile_rows(Bx, By)
    assert rows == 128
    assert -(-Bx // rows) * -(-By // sg.TILE_N) >= sg.SMS
    assert sg.word_slices(Bx, By, D) == [(0, D)]


def test_short_and_wide_grams_are_split_to_fill_a_wave():
    # the scoring path's cross-Gram: 16 tiles of 64 x 128, 19 blocks
    slices = sg.word_slices(64, 2048, 9330)
    assert sg.tile_rows(64, 2048) == 64 and len(slices) >= 2
    assert 16 * len(slices) >= sg.SMS * sg.BLOCKS_PER_SM[64]
    # the projected-MMD Gram: as many slices as blocks of words
    assert len(sg.word_slices(128, 128, 1685)) == 4
    # fewer SMs need fewer slices
    assert len(sg.word_slices(64, 2048, 9330, sms=8)) == 1


@pytest.mark.parametrize("Bx,By,rows", [(1, 9, 64), (64, 4096, 64),
                                        (65, 2048, 64), (300, 300, 64),
                                        (2048, 2048, 128), (1100, 2048, 128)])
def test_tile_rows(Bx, By, rows):
    assert sg.tile_rows(Bx, By) == rows


@pytest.mark.parametrize("D,ptrs,vec", [
    (9330, (0, 256), 2), (9328, (0, 256), 4), (9328, (0, 264), 2),
    (1685, (0, 0), 1), (512, (4, 0), 1), (512, (8, 16), 2), (512, (), 4)])
def test_copy_width_from_the_pitch_and_the_pointers(D, ptrs, vec):
    assert sg.copy_width(D, *ptrs) == vec


# --- the kernel's 3xTF32 arithmetic, emulated -----------------------------

_MASK = np.int64(0xFFFFE000)


def _tf32_round(a):
    """Round fp32 to TF32 on the bits, to nearest, ties away from zero."""
    b = a.astype(np.float32).view(np.uint32).astype(np.int64)
    return ((b + 0x1000) & _MASK).astype(np.uint32).view(np.float32)


def _tf32_read(a):
    """What a tensor core reads of an fp32 register: its top 19 bits."""
    b = a.astype(np.float32).view(np.uint32).astype(np.int64)
    return (b & _MASK).astype(np.uint32).view(np.float32)


def _truncate_fp32(v):
    """float64 -> float32 toward zero, as the tensor cores accumulate."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _gram_3xtf32(x, y, w, slices, passes=3):
    """The kernel's arithmetic on fp32 operands: S_x·ω and S_y split into
    TF32 halves; per 8 words, lo·hi, hi·lo, then hi·hi through truncating
    fp32 accumulation; the partial added to a rounded fp32 sum every 32
    words; the slices summed in order.  ``passes=1`` is one TF32 product."""
    a = (x * w).astype(np.float32)
    ah, bh = _tf32_round(a), _tf32_round(y)
    al, bl = _tf32_read(a - ah), _tf32_read(y - bh)
    products = [(al, bh), (ah, bl), (ah, bh)][3 - passes:]
    G = np.zeros((x.shape[0], y.shape[0]), np.float32)
    for lo, hi in slices:
        acc = np.zeros_like(G)
        for k0 in range(lo, hi, 32):
            part = np.zeros_like(G)
            for k in range(k0, min(k0 + 32, hi), 8):
                for p, q in products:
                    s = slice(k, min(k + 8, hi))
                    part = _truncate_fp32(part + p[:, s].astype(np.float64)
                                          @ q[:, s].T.astype(np.float64))
            acc = (acc + part).astype(np.float32)
        G = (G + acc).astype(np.float32)
    return G


def _brownian_signatures(seed, B, M=1024, d=6, depth=5):
    rng = np.random.default_rng(seed)
    incs = torch.tensor(rng.normal(size=(B, M, d)) / np.sqrt(M))
    return ops.signature(incs, depth, backend="torch",
                         device="cpu").float().numpy()


def test_3xtf32_arithmetic_meets_the_gram_acceptance():
    """d = 6, N = 5 Brownian signatures of 1,024 steps with anisotropic
    weights (the scoring configuration): the emulated kernel is within
    1e-5·max|G_64| of the float64 Gram, and far closer than one TF32
    product, which is why the kernel pays for three."""
    from repro_torch.sigkernel import word_weights
    S = _brownian_signatures(0, 12)
    x, y = S[:4], S[4:]
    w = word_weights(6, 5, gamma=np.linspace(0.5, 2.0, 6)).astype(np.float32)
    want = (x.astype(np.float64) * w) @ y.T.astype(np.float64)
    scale = np.abs(want).max()
    slices = sg.word_slices(*x.shape[:1], y.shape[0], x.shape[1])
    err3 = np.abs(_gram_3xtf32(x, y, w, slices) - want).max() / scale
    err1 = np.abs(_gram_3xtf32(x, y, w, slices, passes=1)
                  - want).max() / scale
    assert err3 <= 1e-5
    assert err3 * 20 < err1


@pytest.mark.parametrize("D", [511, 1025])
def test_3xtf32_arithmetic_across_split_boundaries(D):
    x, y, w = _operands(D, 3, 5, D)
    want = (x.astype(np.float64) * w) @ y.T.astype(np.float64)
    for width in (512, 1024, -(-D // 512) * 512):
        slices = [(k, min(D, k + width)) for k in range(0, D, width)]
        got = _gram_3xtf32(x, y, w, slices)
        _close(got, want)
