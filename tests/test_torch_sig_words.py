"""The port's ``sig_words`` module against the reference word kernel.

On the CPU the wrapper runs its plain version (the padded per-tile
word-table scan); it is held against the JAX Pallas kernel in interpret
mode (non-streamed), the JAX projected stream engine (the reference's
streamed Pallas cell does not run on the installed jax) and the oracles.
The tile tables and the gather index that the CUDA kernel's output goes
through are tested here against the reference's ``tile_idx``/``row_idx``.
Tolerances: rtol 2e-4, atol 2e-5 for fp32; n·2^-8 per full level for
bf16_fp32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import words as jw
from repro.core.projection import projected_signature_from_increments as jpsi
from repro.kernels import ref as jref
from repro.kernels.sig_words import sig_words as j_sig_words
from repro_torch.core import words as tw
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sig_words as sw

TOL = dict(rtol=2e-4, atol=2e-5)
ANISO = jw.anisotropic_words((1.0, 2.0, 1.5), 4.0)
SPARSE = [(0,), (3, 2), (1, 1, 1, 1), (2, 0, 3), (3, 3), (3, 2)]


def _incs(seed, B, M, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, M, d)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("max_rows", [8, 32, 512])
def test_plain_matches_pallas_interpret(max_rows):
    x = _incs(max_rows, 3, 9, 3)
    want = np.asarray(j_sig_words(jnp.asarray(x),
                                  jw.make_tiled_plan(ANISO, 3, max_rows),
                                  batch_tile=8, interpret=True))
    got = sw.sig_words(torch.from_numpy(x),
                       tw.make_tiled_plan(ANISO, 3, max_rows))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("max_rows", [2, 8, 64])
def test_plain_matches_oracles_with_repeated_words(max_rows):
    x = _incs(3, 4, 11, 4)
    got = sw.sig_words(torch.from_numpy(x),
                       tw.make_tiled_plan(SPARSE, 4, max_rows))
    want = np.asarray(jref.sig_words_ref(jnp.asarray(x), SPARSE, 4))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        tref.sig_words_ref(torch.from_numpy(x), SPARSE, 4).numpy(), want,
        **TOL)
    np.testing.assert_array_equal(got[:, 1].numpy(), got[:, 5].numpy())


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("max_rows", [4, 256])
def test_plain_stream_matches_jax_stream_engine(stride, max_rows):
    x = _incs(stride, 3, 8, 3)
    want = np.asarray(jpsi(jnp.asarray(x), jw.make_plan(ANISO, 3),
                           stream=True, stream_stride=stride, backend="jax"))
    got = sw.sig_words(torch.from_numpy(x),
                       tw.make_tiled_plan(ANISO, 3, max_rows), stream=True,
                       stream_stride=stride)
    assert got.shape == want.shape == (3, -(-8 // stride), len(ANISO))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("max_rows", [8, 32, 512])
def test_gather_index_matches_reference(max_rows):
    """The flat index the kernel's (T, 1 + W_pad) output is read with is the
    reference's tile_idx/row_idx pair (sig_words.py:192-194)."""
    for d, words in [(3, ANISO), (4, SPARSE), (2, jw.all_words(2, 5))]:
        jt = jw.make_tiled_plan(words, d, max_rows)
        tt = tw.make_tiled_plan(words, d, max_rows)
        tab = sw.tile_tables(tt)
        tile_idx = np.asarray([t for t, _ in jt.gather])
        row_idx = np.asarray([jt.tiles[t].out_rows[k] for t, k in jt.gather])
        np.testing.assert_array_equal(
            tab.gather, tile_idx * (1 + tab.w_pad) + row_idx)
        # read the reference's own closure states back through the index
        blocks = np.random.default_rng(0).normal(
            size=(2, len(jt.tiles), 1 + tab.w_pad))
        np.testing.assert_array_equal(
            blocks.reshape(2, -1)[:, tab.gather],
            blocks[:, tile_idx, row_idx])


def test_tile_tables_pad_and_mask():
    tt = tw.make_tiled_plan(ANISO, 3, 8)
    tab = sw.tile_tables(tt)
    assert tab.n_tiles == len(tt.tiles)
    assert tab.w_pad == max(p.closure_size for p in tt.tiles)
    assert tab.depth == max(p.depth for p in tt.tiles)
    for t, p in enumerate(tt.tiles):
        W = p.closure_size
        np.testing.assert_array_equal(tab.lengths[t, :W], p.lengths)
        assert not tab.lengths[t, W:].any()
        np.testing.assert_array_equal(tab.prefix_idx[t, :p.depth, :W],
                                      p.prefix_idx.T)
        np.testing.assert_array_equal(tab.letters[t, :p.depth, :W],
                                      p.letters.T)
        np.testing.assert_array_equal(tab.inv[t, :p.depth, :W], p.inv.T)
        # steps past a word's length and padding rows never contribute
        j = np.arange(tab.depth)[:, None]
        assert not tab.inv[t][j >= tab.lengths[t][None, :]].any()
        assert (tab.prefix_idx[t] <= W).all()


def test_launch_geometry_limits():
    tab = sw.tile_tables(tw.make_tiled_plan(ANISO, 3, 256))
    threads, smem = sw.launch_geometry(tab, 3)
    assert threads == 32 and threads * sw.ROWS_PER_THREAD >= tab.w_pad
    assert smem == 4 * (1 + tab.w_pad + 3 * tab.depth * tab.w_pad
                        + tab.w_pad + sw.CHUNK * 3)
    deep = sw.tile_tables(tw.make_tiled_plan([(0,) * 17], 1))
    with pytest.raises(ValueError, match="MAX_DEPTH"):
        sw.launch_geometry(deep, 1)
    wide = sw.tile_tables(tw.make_tiled_plan(jw.all_words(4, 6), 4, 10**6))
    with pytest.raises(ValueError, match="max_rows"):
        sw.launch_geometry(wide, 4)
    with pytest.raises(ValueError, match="letters"):
        sw.sig_words(torch.zeros(1, 2, 2), tw.make_tiled_plan(ANISO, 3))


def test_bf16_within_per_level_bound_and_agrees_with_reference():
    d, N = 3, 4
    x = _incs(7, 4, 20, d)
    tx = torch.from_numpy(x)
    tp = tw.make_tiled_plan(jw.all_words(d, N), d, 16)
    ref = sw.sig_words(tx.double(), tp).numpy()
    got = sw.sig_words(tx, tp, precision="bf16_fp32").numpy()
    off = 0
    for n in range(1, N + 1):
        g, r = got[:, off:off + d**n], ref[:, off:off + d**n]
        assert np.linalg.norm(g - r) / np.linalg.norm(r) <= n * 2.0**-8
        off += d**n
    jx = jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    want = np.asarray(jref.sig_words_ref(jx, jw.all_words(d, N), d))
    np.testing.assert_allclose(got, want, **TOL)
    stream = sw.sig_words(tx, tp, stream=True, stream_stride=3,
                          precision="bf16_fp32")
    assert torch.equal(stream, stream.to(torch.bfloat16).float())


def test_float64_runs_in_fp32_and_zero_steps():
    tp = tw.make_tiled_plan(SPARSE, 4, 4)
    x = torch.from_numpy(_incs(3, 2, 5, 4)).double()
    out = sw.sig_words(x, tp)
    assert out.dtype == torch.float64
    assert torch.equal(out, sw.sig_words(x.float(), tp).double())
    assert sw.sig_words(torch.zeros(3, 0, 4), tp).shape == (3, len(SPARSE))
    assert not sw.sig_words(torch.zeros(3, 0, 4), tp).any()
    assert sw.sig_words(torch.zeros(3, 0, 4), tp,
                        stream=True).shape == (3, 0, len(SPARSE))


def test_cuda_cell_backward_raises(monkeypatch):
    """The launch is stubbed with the plain version so the autograd node
    runs on the CPU; its backward must raise, never drop gradients."""
    monkeypatch.setattr(sw, "_launch", lambda incs, tplan, *a:
                        sw.sig_words_plain(incs.detach(), tplan))
    tp = tw.make_tiled_plan(SPARSE, 4)
    x = torch.from_numpy(_incs(0, 2, 4, 4)).requires_grad_()
    out = sw.SigWordsFunction.apply(x, tp, False, 1, "fp32")
    assert out.grad_fn is not None
    with pytest.raises(NotImplementedError, match="inverse backward"):
        out.sum().backward()


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        sw.sig_words(torch.zeros(1, 2, 4, device="meta"),
                     tw.make_tiled_plan(SPARSE, 4))
