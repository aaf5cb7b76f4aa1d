"""Parity of the port's projection path with the reference:
``core.projection``, ``ops.projected`` / ``ops.projected_forward_only``
and the §8 transforms.

Values are held against ``ops.projected(backend="pallas_interpret")`` and
the JAX projected stream engine (the reference's streamed Pallas cell does
not run on the installed jax); gradients of the torch engine against
``jax.grad`` of the reference's jax engine.  The ``cuda`` engine's dispatch
(closure tiles, ``out_rows``, the streamed cell) is driven on the CPU by
routing the engine choice to ``cuda``, where ``sig_words`` runs its plain
version.  Tolerances: rtol 2e-4, atol 2e-5 for fp32.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import words as jw
from repro.kernels import ops as jops
from repro_torch.core import projection as tp
from repro_torch.core import transforms as ttr
from repro_torch.core import words as tw
from repro_torch.kernels import ops

jproj = importlib.import_module("repro.core.projection")
jtr = importlib.import_module("repro.core.transforms")

TOL = dict(rtol=2e-4, atol=2e-5)
SETS = {
    "sparse": (4, [(0,), (3, 2), (1, 1, 1, 1), (2, 0, 3), (3, 3)]),
    "aniso": (3, jw.anisotropic_words((1.0, 2.0, 1.5), 4.0)),
    "lyndon": (2, jw.all_words(2, 3) + [w for w in jw.lyndon_words(2, 4)
                                         if len(w) == 4]),
}


@pytest.fixture(autouse=True)
def _autotune_off(monkeypatch):
    monkeypatch.setenv("PATHSIG_AUTOTUNE", "off")


@pytest.fixture
def cuda_engine(monkeypatch):
    """Route ``backend="auto"`` to the cuda engine on CPU tensors, so the
    kernel's dispatch runs with sig_words's plain version."""
    real = ops.resolve_backend
    monkeypatch.setattr(ops, "resolve_backend",
                        lambda b, dev: "cuda" if b == "auto" else real(b, dev))


def _incs(seed, B, M, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, M, d)) * 0.3).astype(np.float32)


def _path(seed, B, M, d):
    return np.cumsum(_incs(seed, B, M + 1, d), axis=1)


@pytest.mark.parametrize("name", sorted(SETS))
def test_projected_and_forward_only_match_pallas_interpret(name):
    d, words = SETS[name]
    x = _incs(len(name), 3, 7, d)
    lengths = np.array([7, 4, 1])
    jt = jw.make_tiled_plan(words, d, max_rows=8)
    want = np.asarray(jops.projected(jnp.asarray(x), jt, lengths=lengths,
                                     backend="pallas_interpret",
                                     batch_tile=8))
    tt = tw.make_tiled_plan(words, d, max_rows=8)
    tx = torch.from_numpy(x)
    for plan in (tt, tw.make_plan(words, d), words):
        got = ops.projected(tx, plan, lengths=lengths, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        got = ops.projected_forward_only(tx, plan, lengths=lengths,
                                         device="cpu")
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("max_rows", [4, 256])
@pytest.mark.parametrize("name", sorted(SETS))
def test_cuda_engine_dispatch_on_plain_kernel(cuda_engine, name, max_rows):
    d, words = SETS[name]
    x = _incs(7, 3, 9, d)
    lengths = np.array([9, 5, 2])
    want = np.asarray(jops.projected(jnp.asarray(x), words, lengths=lengths,
                                     backend="jax"))
    tx = torch.from_numpy(x)
    for fn in (ops.projected, ops.projected_forward_only):
        got = fn(tx, words, lengths=lengths, max_rows=max_rows, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    for stride in (1, 3):
        want = np.asarray(jops.projected(
            jnp.asarray(x), words, lengths=lengths, backend="jax",
            stream=True, stream_stride=stride))
        got = ops.projected(tx, words, lengths=lengths, max_rows=max_rows,
                            stream=True, stream_stride=stride, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32"])
def test_streamed_projection_matches_jax_engine(stride, precision):
    d, words = SETS["aniso"]
    x = _incs(stride, 3, 8, d)
    lengths = np.array([8, 3, 5])
    want = np.asarray(jproj.projected_signature_from_increments(
        jnp.asarray(x), jw.make_plan(words, d), stream=True,
        stream_stride=stride, backend="jax", lengths=lengths,
        precision=precision))
    got = tp.projected_signature_from_increments(
        torch.from_numpy(x), tw.make_plan(words, d), stream=True,
        stream_stride=stride, lengths=lengths, precision=precision,
        device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_lengths_match_unpadded_answers(engine, monkeypatch):
    if engine == "cuda":
        monkeypatch.setattr(ops, "resolve_backend", lambda b, dev: "cuda")
    d, words = SETS["sparse"]
    path = _path(4, 3, 10, d)
    lengths = [10, 6, 2]
    got = tp.projected_signature(torch.from_numpy(path), words,
                                 lengths=lengths, device="cpu")
    for b, L in enumerate(lengths):
        one = tp.projected_signature(torch.from_numpy(path[b, :L + 1]),
                                     words, device="cpu")
        np.testing.assert_allclose(got[b].numpy(), one.numpy(), **TOL)
        np.testing.assert_allclose(one.numpy(), np.asarray(
            jproj.projected_signature(jnp.asarray(path[b, :L + 1]), words)),
            **TOL)


def test_projected_signature_accepts_ragged_paths():
    from repro_torch.ragged import RaggedPaths
    d, words = SETS["aniso"]
    path = _path(5, 1, 6, d)[0]
    rp = RaggedPaths.from_list([path, path[:4]], device="cpu")
    got = tp.projected_signature(rp, words, device="cpu")
    np.testing.assert_allclose(got[1].numpy(), np.asarray(
        jproj.projected_signature(jnp.asarray(path[:4]), words)), **TOL)


@pytest.mark.parametrize("backward", ["inverse", "autodiff"])
@pytest.mark.parametrize("stream", [False, True])
def test_torch_engine_gradients_match_reference(backward, stream):
    d, words = SETS["aniso"]
    path = _path(3, 2, 6, d)
    n = len(words)
    co = np.random.default_rng(4).normal(
        size=(2, 3, n) if stream else (2, n)).astype(np.float32)
    kw = dict(stream=stream, stream_stride=2, backward=backward,
              lengths=np.array([6, 4]))
    gj = jax.grad(lambda p: jnp.vdot(
        jproj.projected_signature(p, words, **kw), co))(jnp.asarray(path))
    tpath = torch.from_numpy(path).requires_grad_()
    torch.vdot(tp.projected_signature(tpath, words, device="cpu",
                                      **kw).flatten(),
               torch.from_numpy(co).flatten()).backward()
    np.testing.assert_allclose(tpath.grad.numpy(), np.asarray(gj), **TOL)


def test_cuda_engine_backward_raises_and_autodiff_differentiates(
        cuda_engine, monkeypatch):
    """The kernel's autograd node runs on the CPU with its launch stubbed
    by the plain version: the dispatch must keep it on the graph."""
    from repro_torch.kernels import sig_words as sw
    monkeypatch.setattr(sw, "_launch", lambda incs, tplan, *a:
                        sw.sig_words_plain(incs.detach(), tplan))
    monkeypatch.setattr(ops, "sig_words", lambda incs, tplan, stream=False,
                        stream_stride=1, precision="fp32":
                        sw.SigWordsFunction.apply(incs, tplan, stream,
                                                  stream_stride, precision))
    d, words = SETS["sparse"]
    x = torch.from_numpy(_incs(1, 2, 5, d)).requires_grad_()
    out = ops.projected(x, words, device="cpu")
    with pytest.raises(NotImplementedError, match="inverse backward"):
        out.sum().backward()
    g, = torch.autograd.grad(
        ops.projected(x, words, backward="autodiff", device="cpu").sum(), x)
    assert torch.isfinite(g).all() and g.abs().sum() > 0


def test_projection_zero_steps_and_unbatched():
    d, words = SETS["sparse"]
    out = ops.projected(torch.zeros(2, 0, d), words, stream=True,
                        device="cpu")
    assert out.shape == (2, 0, len(words))
    assert not ops.projected(torch.zeros(2, 0, d), words, device="cpu").any()
    path = _path(8, 1, 5, d)[0]
    np.testing.assert_allclose(
        tp.projected_signature(torch.from_numpy(path), words,
                               device="cpu").numpy(),
        np.asarray(jproj.projected_signature(jnp.asarray(path), words)),
        **TOL)


# ---------------------------------------------------------------------------
# the §8 transforms
# ---------------------------------------------------------------------------

def test_lead_lag_matches_reference():
    path = _path(9, 3, 6, 2)
    np.testing.assert_array_equal(ttr.lead_lag(torch.from_numpy(path)),
                                  np.asarray(jtr.lead_lag(jnp.asarray(path))))
    np.testing.assert_array_equal(
        ttr.lead_lag(torch.from_numpy(path[0])),
        np.asarray(jtr.lead_lag(jnp.asarray(path[0]))))


def test_lead_lag_with_lengths_matches_reference():
    path = _path(10, 3, 6, 2)
    lengths = np.array([6, 2, 4])
    got, gl = ttr.lead_lag(torch.from_numpy(path), lengths)
    want, wl = jtr.lead_lag(jnp.asarray(path), lengths)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(
        ttr.freeze_tail(torch.from_numpy(path), lengths).numpy(),
        np.asarray(jtr.freeze_tail(jnp.asarray(path), lengths)))


def test_sparse_leadlag_words_project_like_the_reference():
    d = 3
    assert ttr.sparse_leadlag_generators(d) == \
        jtr.sparse_leadlag_generators(d)
    words = tw.generated_words(ttr.sparse_leadlag_generators(d), 3)
    path = _path(11, 2, 5, d)
    incs = torch.diff(ttr.lead_lag(torch.from_numpy(path)), dim=1)
    got = tp.projected_signature_from_increments(
        incs, tw.make_plan(words, 2 * d), device="cpu")
    jincs = jnp.diff(jtr.lead_lag(jnp.asarray(path)), axis=1)
    want = jproj.projected_signature_from_increments(
        jincs, jw.make_plan(words, 2 * d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
