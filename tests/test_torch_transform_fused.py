"""The fused transform cells of the port against the reference.

Mirrors ``tests/test_transform_fused.py``: raw increments plus
``transform=`` into the port's dispatch, held against the reference's
``jax`` engine on the same numpy inputs, and against ``pallas_interpret``
for the terminal cells (the reference's streamed Pallas cells fail on
``pl.store`` in this JAX, ROADMAP queue 3).  Two routes through the port:

- ``torch``: the torch engine (the fused scan for signatures, the
  materialising route for projections);
- ``card``: the ``cuda`` cells of the dispatch on CPU tensors, their
  autograd nodes (``SigTruncFunction``, ``SigWordsFunction``) with the
  launch replaced by the kernel's plain version, so the raw increments,
  ``taux``, the saved tensors and the fused backward (``fused_augment``,
  the sweep, ``fused_adjoint``) run here as on the card.

A numpy model of the kernels' staging (raw chunk -> augmented staged
slots, at the geometry the wrappers pass) equals ``fused_augment``.
Values rtol 2e-4, atol 2e-5; gradients rtol 1e-3, atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.transforms import as_transform as j_as_transform
from repro.core.transforms import transform_dim as j_transform_dim
from repro.core.words import all_words as j_all_words
from repro.kernels import ops as jops
from repro_torch.core import signature as ts
from repro_torch.core import transforms as tt
from repro_torch.core import words as tw
from repro_torch.core.projection import projected_signature
from repro_torch.kernels import ops
from repro_torch.kernels import sig_trunc as st
from repro_torch.kernels import sig_words as sw
from repro_torch.serve import DynamicBatcher

TOL = dict(rtol=2e-4, atol=2e-5)
GTOL = dict(rtol=1e-3, atol=1e-5)
B, M, d, DEPTH = 5, 11, 2, 3
LENGTHS = np.asarray([11, 7, 1, 0, 5])
TRANSFORMS = ["time_augment", "lead_lag", "basepoint",
              "time_augment+lead_lag", "basepoint+lead_lag+time_augment"]
ROUTES = ["torch", "card"]


@pytest.fixture(autouse=True)
def _autotune_off(monkeypatch):
    monkeypatch.setenv("PATHSIG_AUTOTUNE", "off")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    path = (rng.standard_normal((B, M + 1, d)) * 0.3).astype(np.float32)
    return path, np.diff(path, axis=1), path[:, 0]


def _plain_trunc_launch(incs, depth, split, stream, stride, precision,
                        plan=None, transform=None, taux=None):
    """The sig_trunc launch replaced by its plain version on the same
    stored values (bf16 increments, fp32 time row, bf16 emissions)."""
    storage = st._storage_dtype(precision)
    out = st.sig_trunc_plain(incs.detach().to(storage).float(), depth,
                             stream=stream, stream_stride=stride,
                             transform=transform, taux=taux)
    return out.to(storage) if stream else out


def _plain_words_launch(incs, tplan, stream, stride, precision, plan=None,
                        transform=None, taux=None):
    storage = st._storage_dtype(precision)
    out = sw.sig_words_plain(incs.detach().to(storage).float(), tplan,
                             stream=stream, stream_stride=stride,
                             transform=transform, taux=taux)
    return out.to(storage) if stream else out


@pytest.fixture
def card(monkeypatch):
    """Run the dispatch's cuda cells on CPU tensors through the kernels'
    autograd nodes, their launches replaced by the plain versions."""
    resolve = ops.resolve_backend
    monkeypatch.setattr(ops, "resolve_backend", lambda backend, device:
                        "cuda" if backend == "auto" else resolve(backend,
                                                                 device))
    monkeypatch.setattr(st, "_launch", _plain_trunc_launch)
    monkeypatch.setattr(sw, "_launch", _plain_words_launch)

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


@pytest.fixture
def route(request):
    """``torch`` or ``card`` (see the module docstring)."""
    if request.param == "card":
        request.getfixturevalue("card")
    return request.param


def _t(a, grad=False):
    return torch.tensor(np.asarray(a)).requires_grad_(grad)


def _jl(ragged):
    return jnp.asarray(LENGTHS) if ragged else None


# ---------------------------------------------------------------------------
# truncated signatures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("tname", TRANSFORMS)
def test_fused_signature_matches_reference(data, tname, ragged, route):
    _, incs, x0 = data
    lens = LENGTHS if ragged else None
    got = ops.signature(_t(incs), DEPTH, transform=tname, x0=_t(x0),
                        lengths=lens, device="cpu")
    for backend in ("jax", "pallas_interpret"):
        want = jops.signature(jnp.asarray(incs), DEPTH, backend=backend,
                              transform=tname, x0=jnp.asarray(x0),
                              lengths=_jl(ragged), batch_tile=8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("tname", ["time_augment+lead_lag", "lead_lag",
                                   "basepoint+time_augment"])
def test_fused_stream_matches_jax_engine(data, tname, stride, ragged, route):
    _, incs, x0 = data
    lens = LENGTHS if ragged else None
    kw = dict(stream=True, stream_stride=stride, transform=tname)
    x = _t(incs, True)
    got = ops.signature(x, DEPTH, x0=_t(x0), lengths=lens, device="cpu",
                        **kw)
    want = jops.signature(jnp.asarray(incs), DEPTH, backend="jax",
                          x0=jnp.asarray(x0), lengths=_jl(ragged), **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    co = np.random.default_rng(2).standard_normal(want.shape).astype(
        np.float32)
    g, = torch.autograd.grad(got, x, _t(co))
    gw = jax.grad(lambda a: jnp.vdot(jops.signature(
        a, DEPTH, backend="jax", x0=jnp.asarray(x0), lengths=_jl(ragged),
        **kw), co))(jnp.asarray(incs))
    np.testing.assert_allclose(g.numpy(), np.asarray(gw), **GTOL)


@pytest.mark.parametrize("bwd,route", [("inverse", "torch"),
                                       ("autodiff", "torch"),
                                       ("inverse", "card"),
                                       ("autodiff", "card")],
                         indirect=["route"])
def test_fused_signature_grads(data, bwd, route):
    _, incs, x0 = data
    tname = "basepoint+lead_lag+time_augment"
    spec = j_as_transform(tname)
    co = np.random.default_rng(1).standard_normal(
        (B, sum(j_transform_dim(spec, d) ** n for n in range(1, DEPTH + 1)))
    ).astype(np.float32)
    x, x0t = _t(incs, True), _t(x0, True)
    out = ops.signature(x, DEPTH, backward=bwd, transform=tname, x0=x0t,
                        lengths=LENGTHS, device="cpu")
    gi, gx = torch.autograd.grad(out, (x, x0t), _t(co))

    def ref(a, a0):
        return jnp.vdot(jops.signature(a, DEPTH, backend="jax", backward=bwd,
                                       transform=tname, x0=a0,
                                       lengths=jnp.asarray(LENGTHS)), co)

    ri, rx = jax.grad(ref, argnums=(0, 1))(jnp.asarray(incs),
                                          jnp.asarray(x0))
    np.testing.assert_allclose(gi.numpy(), np.asarray(ri), **GTOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(rx), **GTOL)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("stream", [False, True])
def test_bf16_with_a_time_channel(data, stream, route):
    """bf16_fp32 rounds the raw increments only: the time channel stays
    fp32, as the reference's fused cells keep it.  Streamed emissions are
    stored in bf16, so two fp32 sums a few ulps apart may round to
    neighbouring bf16 values: those are held within one bf16 ulp (rtol
    2^-7)."""
    _, incs, x0 = data
    kw = dict(transform="time_augment+lead_lag", precision="bf16_fp32",
              stream=stream, stream_stride=2)
    got = ops.signature(_t(incs), DEPTH, lengths=LENGTHS, device="cpu", **kw)
    backends = ["jax"] if stream else ["jax", "pallas_interpret"]
    tol = dict(rtol=2.0**-7, atol=2e-5) if stream else TOL
    for backend in backends:
        want = jops.signature(jnp.asarray(incs), DEPTH, backend=backend,
                              lengths=jnp.asarray(LENGTHS), batch_tile=8,
                              **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_kernel_wrappers_on_cpu_tensors_match_reference(data):
    """sig_trunc and sig_words on CPU tensors (their plain versions) with a
    kernel-level transform and taux, against the reference's kernels in
    interpret mode on the same raw increments."""
    from repro.core.transforms import transform_time_aux as j_taux
    from repro.kernels.sig_trunc import sig_trunc as j_sig_trunc
    from repro.kernels.sig_words import sig_words as j_sig_words
    _, incs, _ = data
    jspec = j_as_transform("time_augment+lead_lag")
    spec = tt.as_transform("time_augment+lead_lag")
    lens = LENGTHS
    jt_ = j_taux(jspec, B, M, jnp.asarray(lens))
    tx = tt.transform_time_aux(spec, B, M, lens)
    got = st.sig_trunc(_t(incs), DEPTH, transform=spec, taux=tx)
    want = j_sig_trunc(jnp.asarray(incs), DEPTH, batch_tile=8,
                       transform=jspec, taux=jt_)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    words = tuple(j_all_words(j_transform_dim(jspec, d), 2))[:20]
    got = sw.sig_words(_t(incs), tw.make_tiled_plan(words, 5, max_rows=8),
                       transform=spec, taux=tx)
    from repro.core.words import make_tiled_plan as j_tiled
    want = j_sig_words(jnp.asarray(incs), j_tiled(words, 5, max_rows=8),
                       batch_tile=8, transform=jspec, taux=jt_)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="taux"):
        st.sig_trunc(_t(incs), DEPTH, transform=spec)
    with pytest.raises(ValueError, match="basepoint"):
        st.sig_trunc(_t(incs), DEPTH,
                     transform=tt.as_transform("basepoint+lead_lag"))


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def _words(spec):
    return tuple(j_all_words(j_transform_dim(j_as_transform(spec), d),
                             3))[:40]


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("tname", ["time_augment+lead_lag",
                                   "basepoint+lead_lag+time_augment"])
def test_fused_projected_matches_reference(data, tname, ragged, route):
    _, incs, x0 = data
    words = _words(tname)
    lens = LENGTHS if ragged else None
    x = _t(incs, True)
    got = ops.projected(x, words, transform=tname, x0=_t(x0), lengths=lens,
                        device="cpu")
    for backend in ("jax", "pallas_interpret"):
        want = jops.projected(jnp.asarray(incs), words, backend=backend,
                              transform=tname, x0=jnp.asarray(x0),
                              lengths=_jl(ragged), batch_tile=8)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
    co = np.random.default_rng(3).standard_normal(want.shape).astype(
        np.float32)
    g, = torch.autograd.grad(got, x, _t(co))
    gw = jax.grad(lambda a: jnp.vdot(jops.projected(
        a, words, backend="jax", transform=tname, x0=jnp.asarray(x0),
        lengths=_jl(ragged)), co))(jnp.asarray(incs))
    np.testing.assert_allclose(g.numpy(), np.asarray(gw), **GTOL)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("stride", [1, 3])
def test_fused_projected_stream_and_forward_only(data, stride, route):
    _, incs, x0 = data
    tname = "time_augment+lead_lag"
    words = _words(tname)
    x = _t(incs, True)
    kw = dict(stream=True, stream_stride=stride, transform=tname)
    got = ops.projected(x, words, lengths=LENGTHS, device="cpu", **kw)
    want = jops.projected(jnp.asarray(incs), words, backend="jax",
                          lengths=jnp.asarray(LENGTHS), **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    co = np.random.default_rng(4).standard_normal(want.shape).astype(
        np.float32)
    g, = torch.autograd.grad(got, x, _t(co))
    gw = jax.grad(lambda a: jnp.vdot(jops.projected(
        a, words, backend="jax", lengths=jnp.asarray(LENGTHS), **kw),
        co))(jnp.asarray(incs))
    np.testing.assert_allclose(g.numpy(), np.asarray(gw), **GTOL)
    gotf = ops.projected_forward_only(_t(incs), words, transform=tname,
                                      lengths=LENGTHS, device="cpu")
    for backend in ("jax", "pallas_interpret"):
        wantf = jops.projected_forward_only(
            jnp.asarray(incs), words, backend=backend, transform=tname,
            lengths=jnp.asarray(LENGTHS), batch_tile=8)
        np.testing.assert_allclose(gotf.numpy(), np.asarray(wantf), **TOL)


@pytest.mark.parametrize("route,backend", [("torch", "jax"),
                                           ("card", "pallas_interpret")],
                         indirect=["route"])
def test_fused_projected_bf16_with_a_time_channel(data, route, backend):
    """The reference's materialising projected route (its jax engine)
    rounds the time channel with the increments under bf16_fp32, its fused
    Pallas cell keeps it fp32; the port's torch and card routes follow
    them in turn."""
    _, incs, x0 = data
    tname = "time_augment+lead_lag"
    words = _words(tname)
    kw = dict(transform=tname, precision="bf16_fp32")
    got = ops.projected(_t(incs), words, lengths=LENGTHS, device="cpu", **kw)
    want = jops.projected(jnp.asarray(incs), words, backend=backend,
                          lengths=jnp.asarray(LENGTHS), batch_tile=8, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the path-level entry points, serving, the saved tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_core_entry_points_pass_x0_automatically(data, route):
    path, _, _ = data
    tname = "basepoint+time_augment"
    spec = j_as_transform(tname)
    from repro.core.signature import signature as j_signature
    from repro.core.projection import projected_signature as j_projected
    got = ts.signature(_t(path), DEPTH, transform=tname, device="cpu")
    want = j_signature(jnp.asarray(path), DEPTH, transform=tname,
                       backend="pallas_interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    words = tuple(j_all_words(j_transform_dim(spec, d), 2))
    got = projected_signature(_t(path), words, transform=tname, device="cpu")
    want = j_projected(jnp.asarray(path), words, transform=tname)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = ts.signature_from_increments(_t(np.diff(path, axis=1)), DEPTH,
                                       transform=tname, x0=_t(path[:, 0]),
                                       backend="torch", device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(
        j_signature(jnp.asarray(path), DEPTH, transform=tname)), **TOL)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("tname", ["time_augment", "basepoint+lead_lag"])
def test_signature_service_with_a_transform(tname, route):
    """Each served answer is the request's own transformed signature: the
    per-example dt of a ragged micro-batch and the basepoint start."""
    from repro.core.signature import signature as j_signature
    rng = np.random.default_rng(8)
    reqs = [np.cumsum(rng.normal(size=(n + 1, 3)) * 0.3, 0).astype(
        np.float32) for n in (3, 9, 17, 30, 1)]
    svc = DynamicBatcher.signature_service(d=3, depth=DEPTH, max_len=32,
                                           transform=tname, device="cpu")
    tickets = [svc.submit(p) for p in reqs]
    out = svc.flush()
    for t, p in zip(tickets, reqs):
        want = j_signature(jnp.asarray(p), DEPTH, transform=tname)
        np.testing.assert_allclose(out[t].numpy(), np.asarray(want), **TOL)


def _saved_storage_bytes(fn, x: torch.Tensor) -> int:
    """Bytes of the distinct storages behind the tensors autograd saves for
    the backward of fn(x)."""
    storages = {}

    def pack(t):
        s = t.untyped_storage()
        storages[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(x)
    return sum(storages.values())


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("kernel", ["sig_trunc", "sig_words"])
def test_fused_cells_save_the_raw_increments(kernel, stream, card):
    """The autograd nodes of the fused cells keep the raw increments, taux
    and a (B, W) terminal state: never the augmented tensor, whatever M."""
    spec = tt.as_transform("time_augment+lead_lag")
    N = 3
    d_aug = tt.transform_dim(spec, d)
    plan = tw.make_plan(tw.all_words(d_aug, N), d_aug)
    tplan = tw.make_tiled_plan(plan.closure, d_aug, max_rows=8)
    W = plan.closure_size

    def saved(n):
        x = torch.zeros(1, n, d, requires_grad=True)
        taux = tt.transform_time_aux(spec, 1, n)
        if kernel == "sig_trunc":
            fn = lambda t: st.SigTruncFunction.apply(  # noqa: E731
                t, N, None, stream, 1, "fp32", spec, taux)
        else:
            fn = lambda t: sw.SigWordsFunction.apply(  # noqa: E731
                t, tplan, stream, 1, "fp32", plan, spec, taux)
        return _saved_storage_bytes(fn, x)

    for n in (8, 200):
        assert saved(n) == 4 * (n * d + 2 + W), n


# ---------------------------------------------------------------------------
# the kernels' staging, modelled in numpy at the wrappers' geometry
# ---------------------------------------------------------------------------

def _aug_source(ja, ch, d_raw, ll, time):
    """csrc/fused_aug.cuh::aug_source."""
    if time:
        if ch == 0:
            return -2
        ch -= 1
    if not ll:
        return ja * d_raw + ch
    row = (ja >> 1) * d_raw
    if ch < d_raw:
        return row + ch if ja & 1 else -1
    return -1 if ja & 1 else row + ch - d_raw


def _aug_value(x, taux, b, ja, ch, d_raw, ll, time):
    src = _aug_source(ja, ch, d_raw, ll, time)
    if src >= 0:
        return x[b].reshape(-1)[src]
    if src == -2:
        return taux[b, 0] if np.float32(ja) < taux[b, 1] else 0.0
    return 0.0


def _staged_trunc(x, taux, spec, depth):
    """csrc/sig_trunc.cu's staging: a thread t of T (plan_launch's) walks
    the chunk's elements e = t, t + T, ... stepping (step, channel) by
    (T // d, T % d), and writes dx/k at dxs[step][k-1][channel]."""
    Bn, Mr, d_raw = x.shape
    ll, time = spec.lead_lag, spec.time
    dd = tt.transform_dim(spec, d_raw)
    Ma = Mr * (2 if ll else 1)
    plan = st.plan_launch(Bn, dd, depth)
    T, CH = plan.threads, st.CHUNK
    qT, rT = divmod(T, dd)
    out = np.full((Bn, Ma, dd), np.nan, np.float32)
    for b in range(Bn):
        for j0 in range(0, Ma, CH):
            TC = min(CH, Ma - j0)
            dxs = np.full((CH, depth, dd), np.nan, np.float32)
            for t in range(T):
                s_, i = divmod(t, dd)
                for e in range(t, TC * dd, T):
                    v = _aug_value(x, taux, b, j0 + s_, i, d_raw, ll, time)
                    for k in range(depth):
                        dxs[s_, k, i] = np.float32(v) * np.float32(
                            1.0 / (k + 1))
                    s_, i = s_ + qT, i + rT
                    if i >= dd:
                        s_, i = s_ + 1, i - dd
            out[b, j0:j0 + TC] = dxs[:TC, 0]   # k = 1: dx itself
    return out


def _staged_words(x, taux, spec, tplan):
    """csrc/sig_words.cu's fused staging at plan_words_launch's chunk and
    threads: both buffers zeroed once; the first chunk's raw elements
    staged whole, each later chunk's prefetched SW_PREFETCH a thread from
    raw step jn/sub on; each raw element at its lead (or only) slot and,
    under lead-lag, at its lag slot one step on; the time channel a step
    at a time."""
    Bn, Mr, d_raw = x.shape
    ll, time = spec.lead_lag, spec.time
    sub = 2 if ll else 1
    dd = tt.transform_dim(spec, d_raw)
    Ma = Mr * sub
    plan = sw.plan_words_launch(Bn, sw.tile_tables(tplan), dd, lead_lag=ll)
    T, C, PF = plan.threads, plan.chunk, sw.PREFETCH
    assert C % sub == 0 and C * dd <= PF * T
    lead = int(time) + (d_raw if ll else 0)
    out = np.full((Bn, Ma, dd), np.nan, np.float32)
    for b in range(Bn):
        raw = x[b].reshape(-1)
        buf = [np.zeros((C, dd), np.float32) for _ in range(2)]

        def stage_raw(bb, e, v):
            r, c = divmod(e, d_raw)
            bb[sub * r, lead + c] = v
            if ll:
                bb[sub * r + 1, int(time) + c] = v

        def stage_time(bb, j, n):
            for s_ in range(n):
                bb[s_, 0] = taux[b, 0] if np.float32(j + s_) < taux[b, 1] \
                    else 0.0

        C0 = min(C, Ma)
        for e in range(C0 // sub * d_raw):
            stage_raw(buf[0], e, raw[e])
        if time:
            stage_time(buf[0], 0, C0)
        for c, j0 in enumerate(range(0, Ma, C)):
            n = min(C, Ma - j0)
            out[b, j0:j0 + n] = buf[c & 1][:n]
            jn = j0 + C
            Cn = min(C, Ma - jn)
            En = Cn // sub * d_raw
            nxt = buf[(c + 1) & 1]
            for t in range(T):
                for p in range(PF):
                    e = t + p * T
                    if e < En:
                        stage_raw(nxt, e, raw[jn // sub * d_raw + e])
            if time and Cn > 0:
                stage_time(nxt, jn, Cn)
    return out


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("tname", ["time_augment", "lead_lag",
                                   "time_augment+lead_lag"])
def test_kernel_staging_model_equals_fused_augment(tname, ragged):
    spec = tt.as_transform(tname)
    rng = np.random.default_rng(9)
    Bn, Mr, d_raw = 3, 37, 3
    x = rng.normal(size=(Bn, Mr, d_raw)).astype(np.float32)
    lens = np.array([37, 20, 0]) if ragged else None
    taux = tt.transform_time_aux(spec, Bn, Mr, lens).numpy()
    want = tt.fused_augment(torch.from_numpy(x), torch.from_numpy(taux),
                            spec).numpy()
    np.testing.assert_array_equal(_staged_trunc(x, taux, spec, 3), want)
    dd = tt.transform_dim(spec, d_raw)
    tplan = tw.make_tiled_plan(tw.all_words(dd, 2), dd, max_rows=8)
    np.testing.assert_array_equal(_staged_words(x, taux, spec, tplan), want)


# ---------------------------------------------------------------------------
# the reference file's error cases
# ---------------------------------------------------------------------------

def test_basepoint_without_x0_raises(data):
    _, incs, _ = data
    with pytest.raises(ValueError, match="x0"):
        ops.signature(_t(incs), DEPTH, transform="basepoint", device="cpu")
    with pytest.raises(ValueError, match="x0"):
        ops.projected(_t(incs), _words("basepoint+lead_lag"),
                      transform="basepoint+lead_lag", device="cpu")


def test_projected_plan_over_raw_alphabet_raises(data):
    _, incs, _ = data
    plan = tw.make_plan(tuple(tw.all_words(d, 2)), d)
    for fn in (ops.projected, ops.projected_forward_only):
        with pytest.raises(ValueError, match="augmented alphabet"):
            fn(_t(incs), plan, transform="time_augment+lead_lag",
               device="cpu")


def test_checkpoint_with_a_transform_names_the_roadmap(data):
    _, incs, _ = data
    with pytest.raises(NotImplementedError, match="stream=True"):
        ops.signature(_t(incs), DEPTH, transform="lead_lag", stream=True,
                      backward="checkpoint", device="cpu")
    with pytest.raises(NotImplementedError, match="stream=True"):
        ts.signature_from_increments(_t(incs), DEPTH, transform="lead_lag",
                                     stream=True, backward="checkpoint",
                                     backend="torch", device="cpu")


def test_lead_lag_plans_stage_whole_raw_steps():
    """A lead-lag launch of sig_words stages whole raw steps: every
    partition's chunk is even, and a plan with an odd chunk is refused
    before anything is built or launched."""
    spec = tt.as_transform("lead_lag")
    for d_raw, N in ((1, 4), (3, 3), (5, 4)):
        da = tt.transform_dim(spec, d_raw)
        tp = tw.make_tiled_plan(tw.all_words(da, min(N, 3)), da, max_rows=32)
        table = sw.tile_tables(tp)
        plans = sw.partition_variants(5, table, da, lead_lag=True)
        assert plans and all(p.chunk % 2 == 0 and p.chunk >= 2
                             for p in plans)
        odd = [p for p in sw.partition_variants(5, table, da)
               if p.chunk % 2]
        for p in odd:
            with pytest.raises(ValueError, match="even"):
                sw._launch(torch.zeros(5, 3, d_raw), tp, False, 1, "fp32", p,
                           spec)


@pytest.mark.parametrize("tname", ["lead_lag", "time_augment+lead_lag"])
def test_fused_projection_saves_the_raw_increments(tname, card):
    """ops.projected's fused cuda cell onto a prefix-closed set keeps the
    raw increments, taux, the (B, W) closure state and the int64 read-out
    index of its W words for the backward: never the augmented tensor,
    whatever M."""
    spec = tt.as_transform(tname)
    d_aug = tt.transform_dim(spec, d)
    plan = tw.make_plan(tw.make_plan(tw.all_words(d_aug, 3), d_aug).closure,
                        d_aug)
    W = len(plan.words)

    def saved(n):
        x = torch.zeros(1, n, d, requires_grad=True)
        return _saved_storage_bytes(
            lambda t: ops.projected(t, plan, transform=tname, device="cpu"),
            x)

    for n in (8, 200):
        assert saved(n) == 4 * (n * d + 2 * spec.time + W) + 8 * W, n
