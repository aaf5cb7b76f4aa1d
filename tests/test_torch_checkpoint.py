"""The √M checkpoint backward and time-chunked signatures of the port
against the reference.

Mirrors the checkpoint cases of ``tests/test_backprop.py`` and
``tests/test_dispatch.py``: the same numpy inputs through the reference's
``jax`` engine (and ``pallas_interpret`` for its kernel cells, at tiny
sizes) and through the port on two routes:

- ``torch``: the torch engine (:class:`CheckpointSignatureFunction`, the
  chunk replay; whole paths under ``time_chunks``);
- ``card``: the ``cuda`` cells of the dispatch on CPU tensors, with
  ``SigTruncFunction``'s launch replaced by the kernel's plain version and
  the launches and sweeps counted, so the folded chunks, the Chen tree,
  the saved tensors and the one ``sig_sweep`` backward run here as on the
  card.

Values rtol 2e-4, atol 2e-5; gradients rtol 1e-3, atol 1e-5.  The memory
law: what the checkpoint cells save beyond the increments grows like √M
(``saved_tensors_hooks``).
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
from repro_torch.core import signature as ts
from repro_torch.core import words as tw
from repro_torch.kernels import ops
from repro_torch.kernels import sig_trunc as st
from repro_torch.kernels import sig_words as sw

js = importlib.import_module("repro.core.signature")
jproj = importlib.import_module("repro.core.projection")

TOL = dict(rtol=2e-4, atol=2e-5)
GTOL = dict(rtol=1e-3, atol=1e-5)
ROUTES = ["torch", "card"]


@pytest.fixture(autouse=True)
def _autotune_off(monkeypatch):
    monkeypatch.setenv("PATHSIG_AUTOTUNE", "off")


@pytest.fixture
def card(monkeypatch):
    """Run the dispatch's cuda cells on CPU tensors through the kernels'
    autograd nodes, their launches replaced by the plain versions; returns
    the counts of launches and of backward sweeps."""
    n = dict(trunc=0, words=0, sweep=0)
    resolve = ops.resolve_backend
    monkeypatch.setattr(ops, "resolve_backend", lambda backend, device:
                        "cuda" if backend == "auto" else resolve(backend,
                                                                 device))

    def trunc_launch(incs, depth, split, stream, stride, precision,
                     plan=None, transform=None, taux=None):
        n["trunc"] += 1
        storage = st._storage_dtype(precision)
        out = st.sig_trunc_plain(incs.detach().to(storage).float(), depth,
                                 stream=stream, stream_stride=stride,
                                 transform=transform, taux=taux)
        return out.to(storage) if stream else out

    def words_launch(incs, tplan, stream, stride, precision, plan=None,
                     transform=None, taux=None):
        n["words"] += 1
        return sw.sig_words_plain(incs.detach().float(), tplan,
                                  stream=stream, stream_stride=stride,
                                  transform=transform, taux=taux)

    sweep = st.sig_sweep

    def counted_sweep(*a, **kw):
        n["sweep"] += 1
        return sweep(*a, **kw)

    monkeypatch.setattr(st, "_launch", trunc_launch)
    monkeypatch.setattr(sw, "_launch", words_launch)
    monkeypatch.setattr(st, "sig_sweep", counted_sweep)
    monkeypatch.setattr(sw, "sig_sweep", counted_sweep)

    def sig_trunc(x, depth, *, split=None, stream=False, stream_stride=1,
                  precision="fp32", transform=None, taux=None):
        return st.SigTruncFunction.apply(x, depth, split, stream,
                                         stream_stride, precision, transform,
                                         taux).to(x.dtype)

    def sig_words(x, tplan, *, stream=False, stream_stride=1,
                  precision="fp32", closure=None, transform=None, taux=None):
        return sw.SigWordsFunction.apply(x, tplan, stream, stream_stride,
                                         precision, closure, transform,
                                         taux).to(x.dtype)

    monkeypatch.setattr(ops, "sig_trunc", sig_trunc)
    monkeypatch.setattr(ops, "sig_words", sig_words)
    return n


@pytest.fixture
def route(request):
    """``torch`` or ``card`` (see the module docstring)."""
    if request.param == "card":
        request.getfixturevalue("card")
    return request.param


def _incs(seed, B, M, d, scale=0.3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, M, d)) * scale).astype(np.float32)


def _cotangent(seed, shape):
    return np.random.default_rng(seed + 1000).normal(size=shape).astype(
        np.float32)


def _torch_vjp(fn, x, co):
    tx = torch.from_numpy(x).requires_grad_()
    out = fn(tx)
    g, = torch.autograd.grad(out, tx, torch.from_numpy(co).to(out.dtype))
    return out.detach().numpy(), g.numpy()


def _jax_vjp(fn, x, co):
    out, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(co))[0])


def _sig_dim(d, N):
    return sum(d**n for n in range(1, N + 1))


def _check(got, want):
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **GTOL)


# ---------------------------------------------------------------------------
# the torch engine's checkpoint cell against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [0, 1, 5, 16, 50])
def test_default_chunk_and_fold_match_reference(M):
    assert ts.default_chunk(M) == js.default_chunk(M)
    x = _incs(M, 2, M, 3)
    c = ts.default_chunk(M)
    np.testing.assert_array_equal(
        ts._fold_chunks(torch.from_numpy(x), c).numpy(),
        np.asarray(js._fold_chunks(jnp.asarray(x), c)))


@pytest.mark.parametrize("d,N,M", [(2, 4, 13), (3, 3, 21), (4, 2, 7),
                                   (2, 3, 1), (3, 2, 16)])
def test_checkpoint_matches_reference(d, N, M):
    x = _incs(d * 100 + N * 10 + M, 3, M, d)
    co = _cotangent(M, (3, _sig_dim(d, N)))
    got = _torch_vjp(lambda t: ts.signature_from_increments(
        t, N, backward="checkpoint", backend="torch", device="cpu"), x, co)
    for backward in ("checkpoint", "autodiff"):
        _check(got, _jax_vjp(lambda a: js.signature_from_increments(
            a, N, backward=backward), x, co))


def test_checkpoint_bwd_scan_matches_reference():
    """The chunk replay alone, from the same boundary states."""
    d, N, M = 3, 3, 11
    x = _incs(3, 2, M, d)
    chunk = ts.default_chunk(M)
    fwd = ts.CheckpointSignatureFunction.forward
    ctx = type("Ctx", (), {"save_for_backward": lambda self, *a:
                           setattr(self, "saved", a)})()
    fwd(ctx, torch.from_numpy(x), N, chunk)
    bounds = ctx.saved[1]
    g = _cotangent(4, (2, _sig_dim(d, N)))
    got = ts.checkpoint_bwd_scan(torch.from_numpy(x), bounds,
                                 torch.from_numpy(g), N, chunk)
    jb = [jnp.asarray(lv.numpy()) for lv in
          ts.tops.flat_to_levels(bounds, d, N)]
    want = js.checkpoint_bwd_scan(jnp.asarray(x), jb, jnp.asarray(g), N,
                                  chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GTOL)


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32"])
def test_checkpoint_ragged_and_bf16_match_reference(precision):
    d, N, M = 3, 3, 9
    x = _incs(5, 3, M, d)
    lengths = np.array([9, 4, 1])
    co = _cotangent(5, (3, _sig_dim(d, N)))
    kw = dict(backward="checkpoint", lengths=lengths, precision=precision)
    got = _torch_vjp(lambda t: ts.signature_from_increments(
        t, N, backend="torch", device="cpu", **kw), x, co)
    _check(got, _jax_vjp(lambda a: js.signature_from_increments(
        a, N, **kw), x, co))
    assert not got[1][1, 4:].any() and not got[1][2, 1:].any()


@pytest.mark.parametrize("tname", ["lead_lag", "time_augment+lead_lag",
                                   "basepoint+time_augment"])
@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_checkpoint_with_a_transform_matches_reference(tname, route):
    d, N, M = 2, 3, 10
    x = _incs(7, 3, M, d)
    x0 = _incs(8, 3, 1, d)[:, 0]
    lengths = np.array([10, 6, 0])
    out = jops.signature(jnp.asarray(x), N, backend="jax", transform=tname,
                         x0=x0, lengths=lengths)
    co = _cotangent(9, out.shape)
    kw = dict(backward="checkpoint", transform=tname, lengths=lengths)
    got = _torch_vjp(lambda t: ops.signature(
        t, N, x0=torch.from_numpy(x0), device="cpu",
        backend="auto" if route == "card" else "torch", **kw), x, co)
    want = _jax_vjp(lambda a: jops.signature(a, N, backend="jax", x0=x0,
                                             **kw), x, co)
    _check(got, want)


def test_stream_checkpoint_raises():
    x = torch.zeros(1, 3, 2)
    for fn in (lambda: ts.signature_from_increments(
            x, 2, stream=True, backward="checkpoint", backend="torch",
            device="cpu"),
               lambda: ops.signature(x, 2, stream=True, backward="checkpoint",
                                     device="cpu"),
               lambda: tp.projected_signature_from_increments(
                   x, tw.make_plan([(0,)], 2), stream=True,
                   backward="checkpoint", backend="torch", device="cpu")):
        with pytest.raises(NotImplementedError, match="stream=True"):
            fn()


# ---------------------------------------------------------------------------
# the cuda checkpoint cell and time_chunks, on CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,N,M", [(2, 3, 7), (3, 2, 16), (2, 2, 1)])
def test_checkpoint_cell_matches_the_pallas_cell(d, N, M, card):
    """The reference's kernel chunk forward with its √M custom VJP
    (interpret mode); one forward launch and one sweep a value and
    gradient."""
    x = _incs(11 * d + N + M, 2, M, d)
    co = _cotangent(N, (2, _sig_dim(d, N)))
    got = _torch_vjp(lambda t: ops.signature(t, N, backward="checkpoint",
                                             device="cpu"), x, co)
    assert (card["trunc"], card["sweep"]) == (1, 1)
    _check(got, _jax_vjp(lambda a: js.signature_from_increments(
        a, N, backend="pallas_interpret", backward="checkpoint"), x, co))


@pytest.mark.parametrize("backward", ["inverse", "checkpoint"])
@pytest.mark.parametrize("C", [2, 4, 16])
@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_time_chunks_match_reference(C, backward, route):
    """The reference's jax engine runs whole paths (time_chunks is a
    kernel knob there too); the card route folds C chunks into one
    launch.  M = 13 leaves a ragged last chunk for C = 2, 4 and C > M for
    C = 16."""
    d, N, M = 2, 3, 13
    x = _incs(C, 3, M, d)
    co = _cotangent(C, (3, _sig_dim(d, N)))
    got = _torch_vjp(lambda t: ops.signature(
        t, N, time_chunks=C, backward=backward, device="cpu",
        backend="auto" if route == "card" else "torch"), x, co)
    _check(got, _jax_vjp(lambda a: jops.signature(
        a, N, backend="jax", time_chunks=C, backward=backward), x, co))


@pytest.mark.parametrize("C", [2, 5])
def test_time_chunks_cell_matches_the_pallas_cell(C, card):
    d, N, M = 2, 3, 9
    x = _incs(20 + C, 2, M, d)
    co = _cotangent(C, (2, _sig_dim(d, N)))
    got = _torch_vjp(lambda t: ops.signature(t, N, time_chunks=C,
                                             device="cpu"), x, co)
    assert (card["trunc"], card["sweep"]) == (1, 1)
    _check(got, _jax_vjp(lambda a: jops.signature(
        a, N, backend="pallas_interpret", time_chunks=C), x, co))


@pytest.mark.parametrize("C", [1, 3, 8])
@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_signature_time_parallel_matches_reference(C, route):
    d, N, M = 3, 2, 11
    x = _incs(30 + C, 2, M, d)
    co = _cotangent(C, (2, _sig_dim(d, N)))
    got = _torch_vjp(lambda t: ops.signature_time_parallel(
        t, N, C, device="cpu",
        backend="auto" if route == "card" else "torch"), x, co)
    _check(got, _jax_vjp(lambda a: jops.signature_time_parallel(
        a, N, C, backend="jax"), x, co))


def test_time_chunks_with_a_transform_match_reference(card):
    d, N, M = 2, 3, 8
    x = _incs(40, 2, M, d)
    co = _cotangent(40, (2, _sig_dim(5, N)))
    kw = dict(time_chunks=3, transform="time_augment+lead_lag")
    got = _torch_vjp(lambda t: ops.signature(t, N, device="cpu", **kw),
                     x, co)
    assert (card["trunc"], card["sweep"]) == (1, 1)
    _check(got, _jax_vjp(lambda a: jops.signature(a, N, backend="jax", **kw),
                         x, co))


# ---------------------------------------------------------------------------
# projected checkpoint
# ---------------------------------------------------------------------------

SETS = {
    "sparse": (3, [(0,), (2, 1), (1, 1, 1), (2, 0, 2), (2, 2), (2, 1)]),
    "all_words": (2, jw.all_words(2, 3)),
}


@pytest.mark.parametrize("name", sorted(SETS))
@pytest.mark.parametrize("M", [1, 7, 33])
@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_projected_checkpoint_matches_reference(name, M, route):
    d, words = SETS[name]
    x = _incs(M, 2, M, d)
    co = _cotangent(M, (2, len(words)))
    got = _torch_vjp(lambda t: ops.projected(
        t, words, backward="checkpoint", device="cpu",
        backend="auto" if route == "card" else "torch"), x, co)
    jplan = jw.make_plan(words, d)
    _check(got, _jax_vjp(lambda a: jproj.projected_signature_from_increments(
        a, jplan, backward="checkpoint"), x, co))


def test_projected_checkpoint_cell_launches_no_kernel(card):
    """The word kernel emits no boundary closure states: the cuda cell
    runs the torch engine's checkpoint on the device's tensors, with a
    transform after materialising the augmented increments."""
    d, words = SETS["sparse"]
    x = _incs(3, 2, 9, 2)
    plan = tw.make_plan(words, 4)
    out = _torch_vjp(lambda t: ops.projected(
        t, plan, backward="checkpoint", transform="lead_lag", device="cpu"),
        x, _cotangent(3, (2, len(words))))
    assert card == dict(trunc=0, words=0, sweep=0)
    want = _jax_vjp(lambda a: jops.projected(
        a, jw.make_plan(words, 4), backend="jax", backward="checkpoint",
        transform="lead_lag"), x, _cotangent(3, (2, len(words))))
    _check(out, want)


# ---------------------------------------------------------------------------
# the memory law: O(√M) saved beyond the increments
# ---------------------------------------------------------------------------

def _saved_storage_bytes(fn, x):
    """Bytes of the distinct storages behind the tensors autograd saves for
    the backward of fn(x): a saved view keeps its whole base alive."""
    storages = {}

    def pack(t):
        s = t.untyped_storage()
        storages[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(x)
    return sum(storages.values())


@pytest.mark.parametrize("cell", ["torch", "card", "projected"])
def test_checkpoint_saves_sqrt_M_states(cell, request):
    """Beyond the increments, the checkpoint cells save O(√M) states: from
    M = 64 to M = 1024 (√M × 4) the excess grows 3-6×, where autodiff's
    grows with M (× 16)."""
    if cell == "card":
        request.getfixturevalue("card")
    d, N = 2, 3
    plan = tw.make_plan(tw.all_words(d, N), d)

    def excess(M, backward):
        x = torch.zeros(1, M, d, requires_grad=True)
        if cell == "projected":
            fn = lambda t: ops.projected(t, plan, backward=backward,  # noqa
                                         backend="torch", device="cpu")
        else:
            fn = lambda t: ops.signature(  # noqa: E731
                t, N, backward=backward, device="cpu",
                backend="auto" if cell == "card" else "torch")
        return _saved_storage_bytes(fn, x) - M * d * 4

    grow = excess(1024, "checkpoint") / excess(64, "checkpoint")
    assert 3 <= grow <= 6, grow
    assert excess(1024, "autodiff") / excess(64, "autodiff") > 12


# ---------------------------------------------------------------------------
# the Chen product behind the combine tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,N", [(2, 4), (3, 3), (4, 1), (1, 5)])
def test_signature_combine_matches_reference(d, N):
    """The tree's product on (B, C, D_sig) halves, against the
    reference's signature_combine: values and both operands' gradients."""
    D = _sig_dim(d, N)
    a = _incs(d + N, 3, 2, D)
    b = _incs(d * N, 3, 2, D)
    co = _cotangent(d, (3, 2, D))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = ts.signature_combine(ta, tb, d, N)
    ga, gb = torch.autograd.grad(out, (ta, tb), torch.from_numpy(co))
    want, vjp = jax.vjp(lambda x, y: js.signature_combine(x, y, d, N),
                        jnp.asarray(a), jnp.asarray(b))
    wa, wb = vjp(jnp.asarray(co))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **GTOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **GTOL)
