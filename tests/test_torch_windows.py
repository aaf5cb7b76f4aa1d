"""Windowed signatures of the port (paper §5) against the reference.

Mirrors ``tests/test_windows.py`` and the window cases of
``tests/test_stream.py``: the same numpy paths through the reference's
``jax`` engine and through the port's ``windowed_signature`` /
``windowed_projection`` on two routes: the torch engine, and ``card``, the
``cuda`` cells of the dispatch on CPU tensors with the kernels' launches
replaced by their plain versions and counted (one launch a route, one
sweep a backward).  The chen route is held against the reference's
``jax`` engine, because its streamed Pallas cells fail here (ROADMAP
queue 3).  ``select_route`` is held to what it shares with the reference
(explicit routes, checkpoint and transforms pin fold, the empty set gives
fold, ``chen_cost_scale``) and to the picks of the card's calibration run.

Values rtol 2e-4, atol 2e-5 (the chen route's S^-1 ⊗ S against fold:
rtol 1e-3, atol 1e-4, the reference's); gradients rtol 1e-3, atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import windows as jwin
from repro.core.words import make_plan as j_make_plan
from repro_torch.core import signature as ts
from repro_torch.core import windows as tw
from repro_torch.core.transforms import transform_dim
from repro_torch.core.words import flat_index, make_plan, sig_dim
from repro_torch.kernels import ops
from repro_torch.kernels import sig_trunc as st
from repro_torch.kernels import sig_words as sw

TOL = dict(rtol=2e-4, atol=2e-5)
CHEN_TOL = dict(rtol=1e-3, atol=1e-4)
GTOL = dict(rtol=1e-3, atol=1e-5)
ROUTES = ["torch", "card"]


@pytest.fixture(autouse=True)
def _autotune_off(monkeypatch):
    monkeypatch.setenv("PATHSIG_AUTOTUNE", "off")


@pytest.fixture
def card(monkeypatch):
    """The dispatch's cuda cells on CPU tensors, their launches replaced by
    the plain versions; returns the counts of launches and sweeps."""
    n = dict(trunc=0, stream=0, words=0, sweep=0)
    resolve = ops.resolve_backend
    monkeypatch.setattr(ops, "resolve_backend", lambda backend, device:
                        "cuda" if backend == "auto" else resolve(backend,
                                                                 device))

    def trunc_launch(incs, depth, split, stream, stride, precision,
                     plan=None, transform=None, taux=None):
        n["stream" if stream else "trunc"] += 1
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
    monkeypatch.setattr(ops, "sig_trunc", lambda x, depth, *, split=None,
                        stream=False, stream_stride=1, precision="fp32",
                        transform=None, taux=None: st.SigTruncFunction.apply(
                            x, depth, split, stream, stream_stride,
                            precision, transform, taux).to(x.dtype))
    monkeypatch.setattr(ops, "sig_words", lambda x, tplan, *, stream=False,
                        stream_stride=1, precision="fp32", closure=None,
                        transform=None, taux=None: sw.SigWordsFunction.apply(
                            x, tplan, stream, stream_stride, precision,
                            closure, transform, taux).to(x.dtype))
    return n


@pytest.fixture
def route(request):
    if request.param == "card":
        return request.getfixturevalue("card")
    return None


def _path(seed, B, M, d):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(size=(B, M + 1, d)) * 0.3,
                     axis=1).astype(np.float32)


def _ours(path, windows, N, **kw):
    return tw.windowed_signature(torch.from_numpy(path), windows, N,
                                 device="cpu", **kw).numpy()


def _theirs(path, windows, N, **kw):
    return np.asarray(jwin.windowed_signature(jnp.asarray(path), windows, N,
                                              **kw))


WINDOWS = np.asarray([[0, 20], [0, 5], [5, 12], [11, 20], [7, 8]], np.int32)


# ---------------------------------------------------------------------------
# values
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("rname", ["fold", "chen", "auto"])
def test_routes_match_reference(rname, route):
    path = _path(0, 3, 20, 3)
    got = _ours(path, WINDOWS, 3, route=rname)
    np.testing.assert_allclose(got, _theirs(path, WINDOWS, 3, route=rname),
                               **TOL)
    np.testing.assert_allclose(got, _theirs(path, WINDOWS, 3, route="fold"),
                               **(TOL if rname != "chen" else CHEN_TOL))
    if route is not None:   # one launch a route
        chen = tw.select_route(rname, WINDOWS, 20) == "chen"
        assert (route["trunc"], route["stream"]) == (0 if chen else 1,
                                                     1 if chen else 0)


def test_matches_per_window_signatures():
    path = _path(1, 3, 20, 3)
    want = np.stack([ts.signature(torch.from_numpy(path[:, lo:hi + 1]), 3,
                                  backend="torch", device="cpu").numpy()
                     for lo, hi in WINDOWS], axis=1)
    np.testing.assert_allclose(_ours(path, WINDOWS, 3, route="fold"), want,
                               **TOL)


def test_expanding_windows_equal_stream():
    path = _path(2, 2, 10, 2)
    ws = _ours(path, tw.expanding_windows(10), 3)
    stream = ts.signature(torch.from_numpy(path), 3, stream=True,
                          backend="torch", device="cpu").numpy()
    np.testing.assert_allclose(ws, stream, **TOL)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("rname", ["fold", "chen", "auto"])
def test_windowed_projection_matches_reference(rname, route):
    d = 3
    path = _path(4, 2, 24, d)
    windows = tw.sliding_windows(24, 12, stride=3)
    words = [(0,), (2, 1), (1, 1, 0)]
    got = tw.windowed_projection(torch.from_numpy(path), windows,
                                 make_plan(words, d), route=rname,
                                 device="cpu").numpy()
    want = np.asarray(jwin.windowed_projection(
        jnp.asarray(path), windows, j_make_plan(words, d), route=rname))
    np.testing.assert_allclose(got, want, **TOL)
    full = _ours(path, windows, 3, route="fold")
    picked = tw.select_route(rname, windows, 24, chen_cost_scale=sig_dim(
        d, 3) / (1 + make_plan(words, d).closure_size))
    np.testing.assert_allclose(got, full[..., [flat_index(w, d)
                                               for w in words]],
                               **(TOL if picked == "fold" else CHEN_TOL))
    if route is not None:
        assert (route["words"], route["stream"]) == (
            (1, 0) if picked == "fold" else (0, 1))


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("tr", ["time_augment", "lead_lag", "basepoint",
                                "time_augment+lead_lag"])
def test_windowed_transform_matches_reference(tr, route):
    """The transform applies per window: the reference's fold route, and
    signature(window_slice, transform=...) window by window."""
    path = _path(5, 3, 20, 2)
    got = _ours(path, WINDOWS, 3, transform=tr)
    np.testing.assert_allclose(got, _theirs(path, WINDOWS, 3, transform=tr),
                               **TOL)
    want = np.stack([ts.signature(
        torch.from_numpy(path[:, lo:hi + 1]), 3, transform=tr,
        backend="torch", device="cpu").numpy() for lo, hi in WINDOWS], 1)
    np.testing.assert_allclose(got, want, **TOL)
    if route is not None:
        assert route["trunc"] == 1 and route["stream"] == 0


def test_windowed_transform_projection_subset():
    d = 2
    path = _path(6, 2, 16, d)
    windows = np.asarray([[0, 8], [4, 16]], np.int32)
    d_aug = transform_dim("lead_lag", d)
    words = [(0,), (2, 1), (1, 3, 0)]
    proj = tw.windowed_projection(torch.from_numpy(path), windows,
                                  make_plan(words, d_aug),
                                  transform="lead_lag", device="cpu").numpy()
    want = np.asarray(jwin.windowed_projection(
        jnp.asarray(path), windows, j_make_plan(words, d_aug),
        transform="lead_lag"))
    np.testing.assert_allclose(proj, want, **TOL)
    full = _ours(path, windows, 3, transform="lead_lag")
    np.testing.assert_allclose(
        proj, full[..., [flat_index(w, d_aug) for w in words]], **TOL)


def test_windowed_transform_pins_route_to_fold():
    path = torch.from_numpy(_path(7, 1, 12, 2))
    windows = np.asarray([[0, 6], [3, 12]], np.int32)
    with pytest.raises(NotImplementedError, match="chen"):
        tw.windowed_signature(path, windows, 3, transform="time_augment",
                              route="chen", device="cpu")
    out = tw.windowed_signature(path, windows, 3, transform="time_augment",
                                route="auto", device="cpu")
    assert out.shape[1] == 2


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("rname,tr", [("fold", None), ("chen", None),
                                      ("fold", "time_augment+basepoint")])
def test_ragged_windows_match_reference(rname, tr, route):
    """Window [l, r] clips to [min(l, L_b), min(r, L_b)] before the
    transform applies, on both routes (chen takes no transform)."""
    path = _path(8, 3, 14, 2)
    lens = np.asarray([14, 9, 3], np.int32)
    windows = np.asarray([[0, 14], [2, 11], [5, 6]], np.int32)
    kw = dict(transform=tr, lengths=lens, route=rname)
    got = _ours(path, windows, 3, **kw)
    np.testing.assert_allclose(got, _theirs(path, windows, 3, **kw),
                               **(TOL if rname == "fold" else CHEN_TOL))
    for b, L in enumerate(lens):
        for k, (lo, hi) in enumerate(windows):
            lb, rb = min(lo, L), min(hi, L)
            want = ts.signature(torch.from_numpy(path[b:b + 1, lb:rb + 1]),
                                3, transform=tr, backend="torch",
                                device="cpu").numpy()[0]
            np.testing.assert_allclose(got[b, k], want,
                                       **(TOL if rname == "fold"
                                          else CHEN_TOL))


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32"])
@pytest.mark.parametrize("rname", ["fold", "chen"])
def test_precision_threads_through_both_routes(rname, precision):
    path = _path(9, 2, 16, 3)
    windows = tw.sliding_windows(16, 8, stride=4)
    kw = dict(route=rname, precision=precision)
    # through the dispatch on both sides: it rounds bf16 emissions
    np.testing.assert_allclose(_ours(path, windows, 3, **kw),
                               _theirs(path, windows, 3, backend="auto",
                                       **kw), **TOL)


def test_single_point_window_is_the_segment_signature():
    path = _path(10, 1, 10, 2)
    out = _ours(path, np.asarray([[4, 5]], np.int32), 2)
    seg = ts.signature(torch.from_numpy(path[:, 4:6]), 2, backend="torch",
                       device="cpu").numpy()
    np.testing.assert_allclose(out[:, 0], seg, rtol=1e-5, atol=1e-6)


def test_unbatched_path_and_ragged_paths():
    from repro_torch.ragged import RaggedPaths
    path = _path(11, 2, 12, 2)
    windows = np.asarray([[0, 6], [3, 12]], np.int32)
    one = tw.windowed_signature(torch.from_numpy(path[0]), windows, 3,
                                device="cpu").numpy()
    np.testing.assert_allclose(one, _ours(path, windows, 3)[0], **TOL)
    lens = np.asarray([12, 5])
    rp = RaggedPaths(torch.from_numpy(path), torch.from_numpy(lens))
    got = tw.windowed_signature(rp, windows, 3, device="cpu").numpy()
    np.testing.assert_allclose(got, _theirs(path, windows, 3, lengths=lens),
                               **TOL)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def _torch_grad(fn, path):
    p = torch.from_numpy(path).requires_grad_()
    g, = torch.autograd.grad((fn(p) ** 2).sum(), p)
    return g.numpy()


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("rname", ["fold", "chen", "auto"])
def test_route_gradients_match_reference(rname, route):
    path = _path(12, 2, 24, 3)
    windows = tw.sliding_windows(24, 12, stride=2)   # heavy overlap
    got = _torch_grad(lambda p: tw.windowed_signature(
        p, windows, 3, route=rname, device="cpu"), path)
    want = np.asarray(jax.grad(lambda p: jnp.sum(jwin.windowed_signature(
        p, windows, 3, route="fold", backward="autodiff") ** 2))(
        jnp.asarray(path)))
    np.testing.assert_allclose(got, want, **GTOL)
    if route is not None:
        assert route["sweep"] == 1


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_projection_and_transform_gradients_match_reference(route):
    path = _path(13, 2, 16, 2)
    windows = np.asarray([[0, 8], [4, 16], [3, 9]], np.int32)
    words = [(0,), (2, 1), (1, 3, 0)]
    got = _torch_grad(lambda p: tw.windowed_projection(
        p, windows, make_plan(words, 4), transform="lead_lag", device="cpu"),
        path)
    want = np.asarray(jax.grad(lambda p: jnp.sum(jwin.windowed_projection(
        p, windows, j_make_plan(words, 4), transform="lead_lag") ** 2))(
        jnp.asarray(path)))
    np.testing.assert_allclose(got, want, **GTOL)
    if route is not None:
        assert (route["words"], route["sweep"]) == (1, 1)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_windowed_checkpoint_stays_on_fold(route):
    path = _path(14, 2, 24, 3)
    heavy = tw.sliding_windows(24, 12, stride=1)
    assert tw.select_route("auto", heavy, 24, backward="checkpoint") == "fold"
    got = _torch_grad(lambda p: tw.windowed_signature(
        p, heavy, 3, backward="checkpoint", device="cpu"), path)
    want = np.asarray(jax.grad(lambda p: jnp.sum(jwin.windowed_signature(
        p, heavy, 3, backward="checkpoint") ** 2))(jnp.asarray(path)))
    np.testing.assert_allclose(got, want, **GTOL)
    plan = make_plan([(0,), (2, 1), (1, 1, 0)], 3)
    out = tw.windowed_projection(torch.from_numpy(path), heavy, plan,
                                 backward="checkpoint", device="cpu")
    assert out.shape == (2, len(heavy), 3)


# ---------------------------------------------------------------------------
# window sets and route selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,stride", [(10, 1), (10, 2), (10, 3), (4, 7)])
def test_expanding_windows_match_reference(M, stride):
    np.testing.assert_array_equal(tw.expanding_windows(M, stride),
                                  J.expanding_windows(M, stride))


@pytest.mark.parametrize("M,length,stride", [(10, 4, 3), (8, 8, 1),
                                             (24, 12, 2), (2048, 256, 8)])
def test_sliding_windows_match_reference(M, length, stride):
    np.testing.assert_array_equal(tw.sliding_windows(M, length, stride),
                                  J.sliding_windows(M, length, stride))


@pytest.mark.parametrize("M,levels", [(8, 3), (10, 4), (3, 3), (5, 0)])
def test_dyadic_windows_match_reference(M, levels):
    np.testing.assert_array_equal(tw.dyadic_windows(M, levels),
                                  J.dyadic_windows(M, levels))


def test_window_validation_matches_reference():
    with pytest.raises(ValueError, match="length"):
        tw.sliding_windows(8, 9)
    with pytest.raises(ValueError, match="stride"):
        tw.sliding_windows(8, 4, stride=0)
    with pytest.raises(ValueError):
        tw.expanding_windows(0)
    path = torch.from_numpy(_path(15, 1, 10, 2))
    with pytest.raises(ValueError, match="window indices"):
        tw.windowed_signature(path, np.asarray([[0, 11]]), 2, device="cpu")
    with pytest.raises(ValueError, match="l <= r"):
        tw.windowed_signature(path, np.asarray([[5, 3]]), 2, device="cpu")


def test_empty_window_set_returns_empty_result():
    path = torch.from_numpy(_path(16, 2, 10, 3))
    empty = np.zeros((0, 2), np.int32)
    assert tw.windowed_signature(path, empty, 3, device="cpu").shape == (
        2, 0, sig_dim(3, 3))
    assert tw.windowed_signature(path, empty, 2, transform="lead_lag",
                                 device="cpu").shape == (2, 0, sig_dim(6, 2))
    plan = make_plan([(0,), (2, 1)], 3)
    assert tw.windowed_projection(path, empty, plan,
                                  device="cpu").shape == (2, 0, 2)
    assert tw.select_route("auto", empty, 10) == "fold"


def test_route_selection_shares_the_reference_rules():
    heavy = tw.sliding_windows(64, 32, stride=2)
    light = np.asarray([[0, 4], [30, 34], [60, 64]], np.int32)
    for w in (heavy, light):
        assert tw.select_route("fold", w, 64) == "fold"
        assert tw.select_route("chen", w, 64) == "chen"
        assert tw.select_route("auto", w, 64, backward="checkpoint") == \
            jwin.select_route("auto", w, 64, backward="checkpoint") == "fold"
    with pytest.raises(ValueError, match="route"):
        tw.select_route("nope", light, 64)
    # a dearer streamed pass never turns a fold pick into chen
    for M, length, stride in FIG3:
        w = tw.sliding_windows(M, length, stride)
        picks = [tw.select_route("auto", w, M, chen_cost_scale=s)
                 for s in (1e-9, 0.01, 0.25, 1.0, 4.0, 64.0, 1e9)]
        assert picks[0] == "chen" == jwin.select_route(
            "auto", w, M, chen_cost_scale=1e-9)
        assert picks[-1] == "fold" == jwin.select_route(
            "auto", w, M, chen_cost_scale=1e9)
        assert "chen" not in picks[picks.index("fold"):]
    # transforms pin auto to fold and refuse chen
    assert tw._pin_transform_route("auto", J.transforms.as_transform(
        "lead_lag")) == "fold"
    assert tw._pin_transform_route("chen", None) == "chen"


# the Fig. 3 grid of benchmarks/fig3_windows.py (non-quick): window length
# 16, stride 8, K in {4, 16, 64, 256, 1024}, and the heavy-overlap cell
FIG3 = [(16 * K // 2 + 16, 16, 8) for K in (4, 16, 64, 256, 1024)] \
    + [(2048, 256, 8)]
# the faster measured route at each cell of the card's calibration run
# (chip_smoke.py windows phase, NVIDIA H100 80GB HBM3, 700.00 W; fold
# against chen ms: 0.691 / 1.236, 0.614 / 1.081, 0.455 / 1.056,
# 0.578 / 2.321, 0.745 / 7.351, heavy overlap 1.771 / 3.214)
CARD_PICKS = ["fold", "fold", "fold", "fold", "fold", "fold"]


@pytest.mark.parametrize("i", range(len(FIG3)))
def test_auto_picks_the_card_calibration_route(i):
    M, length, stride = FIG3[i]
    assert tw.select_route("auto", tw.sliding_windows(M, length, stride),
                           M) == CARD_PICKS[i]


def test_auto_takes_chen_where_windows_dwarf_the_path():
    """Long, heavily overlapping windows: 10,000 expanding windows of a
    10,000-step path cost the fold route 10^8 padded window-steps against
    10^4 streamed steps."""
    assert tw.select_route("auto", tw.expanding_windows(10_000),
                           10_000) == "chen"
    assert tw.select_route("auto", tw.expanding_windows(10_000), 10_000,
                           backward="checkpoint") == "fold"
