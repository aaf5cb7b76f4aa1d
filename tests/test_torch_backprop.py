"""Backprop through the port's signatures (paper §4.2) against the
reference.

``torch.autograd.grad`` through the port's ``backward="inverse"`` (the
torch engine's plain §4.2 sweep) is held against ``jax.grad`` through the
reference's ``"inverse"`` and ``"autodiff"``, on the same numpy inputs and
linear cotangents: terminal and streamed cells, ragged lengths,
bf16_fp32, truncated and projected.  Terminal cells are also held against
the reference's Pallas cell in interpret mode; its streamed Pallas cells
do not run on the installed jax, so streamed cases are held against its
jax engine.  Then the memory law and the reconstruction drift, as the
reference's ``tests/test_backprop.py`` states them.  Tolerance: the
reference's gradient tolerance, rtol 1e-3, atol 1e-5.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import words as jw
from repro_torch.core import projection as tp
from repro_torch.core import signature as ts
from repro_torch.core import words as tw

js = importlib.import_module("repro.core.signature")
jproj = importlib.import_module("repro.core.projection")

GTOL = dict(rtol=1e-3, atol=1e-5)
CELLS = [(False, 1), (True, 1), (True, 3)]   # (stream, stride)


def _incs(seed, B, M, d, scale=0.3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, M, d)) * scale).astype(np.float32)


def _cotangent(seed, shape):
    return np.random.default_rng(seed + 1000).normal(size=shape).astype(
        np.float32)


def _torch_grad(fn, x, co):
    tx = torch.from_numpy(x).requires_grad_()
    out = fn(tx)
    g, = torch.autograd.grad(out, tx, torch.from_numpy(co).to(out.dtype))
    return g.numpy()


def _jax_grad(fn, x, co):
    _, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(vjp(jnp.asarray(co))[0])


def _sig_dim(d, N):
    return sum(d**n for n in range(1, N + 1))


def _shape(B, M, D, stream, stride):
    return (B, -(-M // stride), D) if stream else (B, D)


@pytest.mark.parametrize("stream,stride", CELLS)
@pytest.mark.parametrize("d,N,M", [(2, 2, 1), (2, 4, 7), (3, 3, 33),
                                   (3, 2, 7), (2, 3, 33)])
def test_truncated_inverse_gradient_matches_reference(d, N, M, stream,
                                                      stride):
    x = _incs(d * 100 + N * 10 + M, 3, M, d)
    co = _cotangent(M, _shape(3, M, _sig_dim(d, N), stream, stride))
    kw = dict(stream=stream, stream_stride=stride)
    got = _torch_grad(lambda t: ts.signature_from_increments(
        t, N, backend="torch", device="cpu", **kw), x, co)
    for backward in ("inverse", "autodiff"):
        want = _jax_grad(lambda a: js.signature_from_increments(
            a, N, backward=backward, **kw), x, co)
        np.testing.assert_allclose(got, want, **GTOL, err_msg=backward)


@pytest.mark.parametrize("stream,stride", CELLS)
@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32"])
def test_truncated_ragged_and_bf16_gradients_match_reference(
        stream, stride, precision):
    d, N, M = 3, 3, 9
    x = _incs(5, 3, M, d)
    lengths = np.array([9, 4, 1])
    co = _cotangent(5, _shape(3, M, _sig_dim(d, N), stream, stride))
    kw = dict(stream=stream, stream_stride=stride, lengths=lengths,
              precision=precision)
    got = _torch_grad(lambda t: ts.signature_from_increments(
        t, N, backend="torch", device="cpu", **kw), x, co)
    want = _jax_grad(lambda a: js.signature_from_increments(
        a, N, **kw), x, co)
    np.testing.assert_allclose(got, want, **GTOL)
    assert not got[1, 4:].any() and not got[2, 1:].any()


@pytest.mark.parametrize("d,N,M", [(2, 3, 7), (3, 2, 5)])
def test_truncated_gradient_matches_the_pallas_cell(d, N, M):
    """The reference's kernel forward (interpret mode) with its §4.2
    custom VJP."""
    x = _incs(11 * d + N, 2, M, d)
    co = _cotangent(N, (2, _sig_dim(d, N)))
    got = _torch_grad(lambda t: ts.signature_from_increments(
        t, N, backend="torch", device="cpu"), x, co)
    want = _jax_grad(lambda a: js.signature_from_increments(
        a, N, backend="pallas_interpret"), x, co)
    np.testing.assert_allclose(got, want, **GTOL)


SETS = {
    "sparse": (3, [(0,), (2, 1), (1, 1, 1), (2, 0, 2), (2, 2), (2, 1)]),
    "all_words": (2, jw.all_words(2, 3)),
}


@pytest.mark.parametrize("stream,stride", CELLS)
@pytest.mark.parametrize("name", sorted(SETS))
@pytest.mark.parametrize("M", [1, 7, 33])
def test_projected_inverse_gradient_matches_reference(name, M, stream,
                                                      stride):
    d, words = SETS[name]
    x = _incs(M + len(words), 2, M, d)
    co = _cotangent(M, _shape(2, M, len(words), stream, stride))
    kw = dict(stream=stream, stream_stride=stride)
    plan, jplan = tw.make_plan(words, d), jw.make_plan(words, d)
    got = _torch_grad(lambda t: tp.projected_signature_from_increments(
        t, plan, backend="torch", device="cpu", **kw), x, co)
    for backward in ("inverse", "autodiff"):
        want = _jax_grad(lambda a: jproj.projected_signature_from_increments(
            a, jplan, backward=backward, **kw), x, co)
        np.testing.assert_allclose(got, want, **GTOL, err_msg=backward)


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32"])
def test_projected_ragged_gradient_matches_the_pallas_cell(precision):
    d, words = SETS["sparse"]
    x = _incs(3, 3, 8, d)
    lengths = np.array([8, 3, 5])
    co = _cotangent(3, (3, len(words)))
    kw = dict(lengths=lengths, precision=precision)
    plan, jplan = tw.make_plan(words, d), jw.make_plan(words, d)
    got = _torch_grad(lambda t: tp.projected_signature_from_increments(
        t, plan, backend="torch", device="cpu", **kw), x, co)
    want = _jax_grad(lambda a: jproj.projected_signature_from_increments(
        a, jplan, backend="pallas_interpret", **kw), x, co)
    np.testing.assert_allclose(got, want, **GTOL)
    assert not got[1, 3:].any()


def _saved_bytes(fn, x):
    """Bytes of every tensor autograd saves for the backward of fn(x)."""
    total = 0

    def pack(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(x)
    return total


@pytest.mark.parametrize("name", ["truncated", "projected"])
def test_backward_memory_is_M_independent(name):
    """The paper's memory law (§4.2, Table 2): the inverse cell saves the
    increments and the terminal state only; autodiff saves every step."""
    d, N = 2, 4
    plan = tw.make_plan(tw.all_words(d, N), d)

    def saved(backward, M):
        x = torch.zeros(1, M, d, requires_grad=True)
        if name == "truncated":
            return _saved_bytes(lambda t: ts.signature_from_increments(
                t, N, backward=backward, backend="torch", device="cpu"), x)
        return _saved_bytes(lambda t: tp.projected_signature_from_increments(
            t, plan, backward=backward, backend="torch", device="cpu"), x)

    inc_growth = (256 - 32) * d * 4
    grow_inv = saved("inverse", 256) - saved("inverse", 32)
    grow_ad = saved("autodiff", 256) - saved("autodiff", 32)
    assert grow_inv <= inc_growth, (grow_inv, inc_growth)
    assert grow_ad > 10 * inc_growth, (grow_ad, inc_growth)


def _saved_storage_bytes(fn, x):
    """Bytes of the distinct storages behind the tensors autograd saves for
    the backward of fn(x): a saved view keeps its whole base alive."""
    storages = {}

    def pack(t):
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(x)
    return sum(storages.values())


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("kernel", ["sig_trunc", "sig_words"])
def test_kernel_cells_save_only_the_terminal_state(kernel, stream,
                                                   monkeypatch):
    """The memory law for the CUDA cells' autograd nodes, their launches
    stubbed by the plain versions so that they run here: what they keep
    for the backward beyond the increments does not grow with M, so a
    streamed cell keeps a (B, W) copy of its last emission and never the
    storage of the whole stream."""
    from repro_torch.kernels import sig_trunc as st
    from repro_torch.kernels import sig_words as sw
    monkeypatch.setattr(st, "_launch",
                        lambda incs, depth, split, stream, stride, *a:
                        st.sig_trunc_plain(incs.detach(), depth,
                                           stream=stream,
                                           stream_stride=stride))
    monkeypatch.setattr(sw, "_launch", lambda incs, tplan, stream, stride, *a:
                        sw.sig_words_plain(incs.detach(), tplan,
                                           stream=stream,
                                           stream_stride=stride))
    d, N = 2, 4
    plan = tw.make_plan(tw.all_words(d, N), d)   # its own closure
    tplan = tw.make_tiled_plan(plan.closure, d, max_rows=8)

    def saved(M):
        x = torch.zeros(1, M, d, requires_grad=True)
        if kernel == "sig_trunc":
            return _saved_storage_bytes(lambda t: st.SigTruncFunction.apply(
                t, N, None, stream, 1, "fp32"), x)
        return _saved_storage_bytes(lambda t: sw.SigWordsFunction.apply(
            t, tplan, stream, 1, "fp32", plan), x)

    inc_growth = (256 - 32) * d * 4
    grow = saved(256) - saved(32)
    assert grow <= inc_growth, (grow, inc_growth)


def test_inverse_reconstruction_drift_bounded():
    """Long-path drift of the reconstruction (§4.2 note): the fp32 sweep
    against float64 autodiff at M = 800, scale 0.05, to a relative 5e-3."""
    rng = np.random.default_rng(0)
    path = np.cumsum(rng.normal(size=(1, 801, 2)) * 0.05, axis=1)
    incs = np.diff(path, axis=1)

    def grad(x, backward):
        x = torch.from_numpy(x).requires_grad_()
        s = ts.signature_from_increments(x, 3, backward=backward,
                                         backend="torch", device="cpu")
        w = torch.arange(s.shape[-1], dtype=s.dtype) * 1e-2
        g, = torch.autograd.grad((torch.tanh(s) * w).sum(), x)
        return g.double().numpy()

    g_inv = grad(incs.astype(np.float32), "inverse")
    g_ad = grad(incs, "autodiff")
    rel = np.abs(g_inv - g_ad).max() / (np.abs(g_ad).max() + 1e-12)
    assert rel < 5e-3, rel


@pytest.mark.parametrize("stride,M", [(1, None), (1, 9), (2, 9), (3, 9)])
def test_ragged_terminal_matches_reference(stride, M):
    """Each example's true terminal state from a streamed output."""
    out = np.random.default_rng(stride).normal(
        size=(3, -(-9 // stride), 5)).astype(np.float32)
    lengths = np.array([9, 4, 1])
    got = ts.ragged_terminal(torch.from_numpy(out), lengths, stride, M)
    want = js.ragged_terminal(jnp.asarray(out), lengths, stride, M)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # on a streamed signature it is the unpadded terminal signature
    x = _incs(9, 3, 9, 2)
    s = ts.signature_from_increments(torch.from_numpy(x), 3, stream=True,
                                     stream_stride=stride, lengths=lengths,
                                     backend="torch", device="cpu")
    for b, L in enumerate(lengths):
        one = ts.signature_from_increments(torch.from_numpy(x[b:b + 1, :L]),
                                           3, backend="torch", device="cpu")
        np.testing.assert_allclose(ts.ragged_terminal(
            s, lengths, stride, 9)[b].numpy(), one[0].numpy(), rtol=2e-4,
            atol=2e-5)
