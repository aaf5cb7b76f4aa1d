"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

The kernels have no CPU mode, so these skip without a card; elsewhere their
plain versions are tested on the CPU.  This file imports nothing of JAX, so
it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import sigkernel as SK
from repro_torch.core import words as tw
from repro_torch.core.logsignature import logsignature_projected
from repro_torch.kernels import ops
from repro_torch.kernels import sig_gram as sg
from repro_torch.kernels import sig_trunc as st
from repro_torch.kernels import sig_words as sw
from repro_torch.serve import DynamicBatcher, SigScoreEngine

TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernel has no "
                    "CPU mode (its plain version is tested on the CPU)")
    return torch.device("cuda")


def _incs(seed, B, M, d, device):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.normal(size=(B, M, d)) * 0.3,
                        dtype=torch.float32, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("stream,stride", [(False, 1), (True, 1), (True, 3)])
def test_kernel_matches_plain_at_every_split(cuda, stream, stride):
    x = _incs(1, 5, 37, 3, cuda)
    want = st.sig_trunc_plain(x.double(), 4, stream=stream,
                              stream_stride=stride)
    for s in range(4):
        got = st.sig_trunc(x, 4, split=s, stream=stream,
                           stream_stride=stride)
        torch.testing.assert_close(got.double(), want, **TOL)


@pytest.mark.cuda
def test_dispatch_launches_the_kernel_once_per_call(cuda):
    x = _incs(2, 3, 9, 2, cuda)
    st.launches = st.stream_launches = 0
    out = ops.signature(x, 3, lengths=torch.tensor([9, 4, 1]))
    assert out.device.type == "cuda"
    ops.signature(x, 3, stream=True, stream_stride=2)
    assert (st.launches, st.stream_launches) == (1, 1)
    ops.signature(x, 3, backend="torch")
    ops.signature(x[:, :0], 3)  # no steps: zeros, no launch
    assert (st.launches, st.stream_launches) == (1, 1)
    torch.testing.assert_close(out, ops.signature(x, 3, backend="torch",
                                                  lengths=[9, 4, 1]), **TOL)


@pytest.mark.cuda
def test_kernel_backward_raises_on_card(cuda):
    """The backward no longer raises: one sig_sweep launch, equal to the
    plain sweep from the same terminal signature (fp32 sums whose atomic
    order varies: rtol 1e-3, atol 1e-5), and autodiff still runs."""
    from repro_torch.core.signature import truncation_closure
    from repro_torch.kernels import sig_sweep as ss
    x = _incs(3, 2, 5, 2, cuda).requires_grad_()
    out = ops.signature(x, 3)
    co = torch.randn(out.shape, generator=torch.Generator().manual_seed(3)
                     ).to(cuda)
    ss.launches = 0
    g, = torch.autograd.grad(out, x, co)
    assert ss.launches == 1
    want = ss.sig_sweep_plain(x.detach().double(), truncation_closure(2, 3),
                              out.detach().double(), co.double())
    torch.testing.assert_close(g.double(), want, rtol=1e-3, atol=1e-5)
    g, = torch.autograd.grad(ops.signature(x, 3, backward="autodiff").sum(),
                             x)
    assert torch.isfinite(g).all()


ANISO = tw.anisotropic_words((1.0, 2.0, 1.5), 4.0)
SPARSE = [(0,), (3, 2), (1, 1, 1, 1), (2, 0, 3), (3, 3), (3, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("stream,stride", [(False, 1), (True, 1), (True, 3)])
def test_words_kernel_matches_plain_at_several_tilings(cuda, stream, stride):
    for d, words in [(3, ANISO), (4, SPARSE), (2, tw.all_words(2, 5))]:
        x = _incs(d, 5, 37, d, cuda)
        for max_rows in (2, 8, 32, 256, 1024):
            tp = tw.make_tiled_plan(words, d, max_rows)
            want = sw.sig_words_plain(x.double(), tp, stream=stream,
                                      stream_stride=stride)
            got = sw.sig_words(x, tp, stream=stream, stream_stride=stride)
            torch.testing.assert_close(got.double(), want, **TOL)


@pytest.mark.cuda
def test_projected_launches_the_words_kernel_once_per_call(cuda):
    x = _incs(4, 3, 9, 3, cuda)
    sw.launches = sw.stream_launches = 0
    out = ops.projected(x, ANISO, lengths=torch.tensor([9, 4, 1]))
    assert out.device.type == "cuda"
    ops.projected(x, ANISO, stream=True, stream_stride=2)
    ops.projected_forward_only(x, ANISO)
    assert (sw.launches, sw.stream_launches) == (2, 1)
    ops.projected(x, ANISO, backend="torch")
    ops.projected(x[:, :0], ANISO)  # no steps: zeros, no launch
    assert (sw.launches, sw.stream_launches) == (2, 1)
    torch.testing.assert_close(out, ops.projected(
        x, ANISO, backend="torch", lengths=[9, 4, 1]), **TOL)


@pytest.mark.cuda
def test_words_kernel_backward_raises_on_card(cuda):
    """The backward of ops.projected no longer raises: one sig_sweep
    launch, equal to the plain sweep from the closure state; that of
    projected_forward_only over a set that is not its own closure still
    raises, and autodiff still runs."""
    from repro_torch.core.projection import _scan_closure
    from repro_torch.kernels import sig_sweep as ss
    x = _incs(5, 2, 5, 4, cuda).requires_grad_()
    out = ops.projected(x, SPARSE)
    co = torch.randn(out.shape, generator=torch.Generator().manual_seed(5)
                     ).to(cuda)
    ss.launches = 0
    g, = torch.autograd.grad(out, x, co)
    assert ss.launches == 1
    plan = tw.make_plan(SPARSE, 4)
    S_T = _scan_closure(x.detach().double(), plan, False)[1][:, 1:]
    want = ss.sig_sweep_plain(x.detach().double(), plan, S_T, co.double())
    torch.testing.assert_close(g.double(), want, rtol=1e-3, atol=1e-5)
    with pytest.raises(NotImplementedError, match="inverse backward"):
        ops.projected_forward_only(x, SPARSE).sum().backward()
    g, = torch.autograd.grad(
        ops.projected(x, SPARSE, backward="autodiff").sum(), x)
    assert torch.isfinite(g).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d,N", [(2, 5), (4, 4), (6, 3)])
def test_logsignature_projected_on_card_matches_torch_engine(cuda, d, N):
    path = torch.cumsum(_incs(d * N, 4, 21, d, cuda), dim=1)
    sw.launches = 0
    got = logsignature_projected(path, N)
    assert sw.launches == 1
    torch.testing.assert_close(
        got, logsignature_projected(path, N, backend="torch"), **TOL)


def _gram_operands(seed, Bx, By, D, device):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.normal(size=(Bx, D)), device=device),
            torch.tensor(rng.normal(size=(By, D)), device=device),
            torch.tensor(rng.uniform(0.2, 2.0, D), device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 15, 16, 17, 513])
def test_gram_kernel_matches_plain_on_ragged_edges(cuda, D):
    """|G − G_64| <= 1e-5·max|G_64|, the reference's Gram acceptance."""
    for Bx, By in [(1, 1), (63, 65), (64, 64), (65, 130), (130, 1)]:
        x, y, w = _gram_operands(Bx + By + D, Bx, By, D, cuda)
        want = sg.sig_gram_plain(x, y, w)
        got = sg.sig_gram(x.float(), y.float(), w.float())
        torch.cuda.synchronize()
        assert got.shape == (Bx, By) and got.dtype == torch.float32
        assert (got.double() - want).abs().max() <= 1e-5 * want.abs().max()


def _gram_close(got, want):
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got.double() - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [511, 512, 513, 1025, 1685, 9330])
def test_gram_kernel_matches_plain_across_split_boundaries(cuda, D):
    """Both sides of the 64- and 128-row tiles and of the 512-word blocks
    of the split-K slices, in float64 against the plain version."""
    sizes = (1, 63, 64, 65, 128, 129)
    x, y, w = _gram_operands(D, max(sizes), max(sizes), D, cuda)
    for Bx in sizes:
        for By in sizes:
            want = sg.sig_gram_plain(x[:Bx], y[:By], w)
            _gram_close(sg.sig_gram(x[:Bx].float(), y[:By].float(),
                                    w.float()), want)


@pytest.mark.cuda
@pytest.mark.parametrize("Bx,By,D", [(129, 130, 1025), (65, 1, 513),
                                     (128, 128, 1024), (3, 129, 9330)])
def test_gram_kernel_every_tile_split_and_copy_width(cuda, Bx, By, D):
    x, y, w = _gram_operands(Bx * By + D, Bx, By, D, cuda)
    want = sg.sig_gram_plain(x, y, w)
    xf, yf, wf = x.float(), y.float(), w.float()
    top = sg.copy_width(D, xf.data_ptr(), yf.data_ptr())
    for rows in (64, 128):
        for width in sorted({512, 1024, -(-D // 512) * 512}):
            for vec in (v for v in (1, 2, 4) if v <= top):
                _gram_close(sg._launch(xf, yf, wf, rows, width, vec), want)


@pytest.mark.cuda
def test_gram_kernel_reads_an_operand_4_bytes_off_16(cuda):
    x, y, w = _gram_operands(6, 70, 90, 1024, cuda)
    buf = torch.empty(70 * 1024 + 1, dtype=torch.float32, device=cuda)
    xo = buf[1:].view(70, 1024)
    xo.copy_(x)
    assert xo.is_contiguous() and xo.data_ptr() % 16 == 4
    assert sg.copy_width(1024, xo.data_ptr(), y.data_ptr()) == 1
    sg.launches = 0
    _gram_close(ops.gram(xo, y.float(), w.float()),
                sg.sig_gram_plain(x, y, w))
    _gram_close(ops.gram(y.float(), xo, w.float()),
                sg.sig_gram_plain(y, x, w))
    assert sg.launches == 2


@pytest.mark.cuda
def test_gram_kernel_split_k_is_deterministic(cuda):
    x, y, w = (a.float() for a in _gram_operands(7, 64, 700, 9330, cuda))
    assert len(sg.word_slices(64, 700, 9330)) > 1
    sg.launches = 0
    first = ops.gram(x, y, w)
    again = ops.gram(x, y, w)
    assert sg.launches == 2
    assert torch.equal(first, again)


@pytest.mark.cuda
def test_gram_dispatch_launches_the_kernel_once_per_call(cuda):
    x, y, w = (a.float().requires_grad_() for a in
               _gram_operands(3, 9, 5, 40, cuda))
    sg.launches = 0
    out = ops.gram(x, y, w)
    ops.gram(x, x, w)
    assert sg.launches == 2
    ref = ops.gram(x, y, w, backend="torch")
    assert sg.launches == 2
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    g = torch.autograd.grad((out ** 2).sum(), (x, y, w))
    g_ref = torch.autograd.grad((ref ** 2).sum(), (x, y, w))
    for a, b in zip(g, g_ref):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_gram_build_or_launch_failure_raises(cuda, monkeypatch):
    x, y, w = (a.float() for a in _gram_operands(4, 3, 3, 8, cuda))

    def no_build(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(sg._build, "library", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ops.gram(x, y, w)

    class Refusing:
        @staticmethod
        def sig_gram_launch(*args):
            return 9   # cudaErrorInvalidConfiguration

    monkeypatch.setattr(sg, "_lib", lambda: Refusing)
    before = sg.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.gram(x, y, w)
    assert sg.launches == before


@pytest.mark.cuda
def test_scoring_on_card_matches_torch_engine_on_cpu(cuda):
    rng = np.random.default_rng(5)
    refs = np.cumsum(rng.normal(size=(6, 17, 2)) * 0.2, axis=1).astype(
        np.float32)
    kw = dict(d=2, depth=3, batch=1, references=refs, gamma=(0.5, 2.0),
              targets=np.linspace(-1, 1, 6, dtype=np.float32))
    card = SigScoreEngine(**kw)
    cpu = SigScoreEngine(backend="torch", device="cpu", **kw)
    torch.testing.assert_close(card.ref_gram.cpu(), cpu.ref_gram,
                               rtol=2e-4, atol=2e-5)
    reqs = [np.cumsum(rng.normal(size=(L + 1, 2)) * 0.2, axis=0)
            for L in (3, 16, 9, 30)]
    for mode in ("scores", "nearest"):
        a = DynamicBatcher.scoring_service(card, max_len=32, mode=mode)
        b = DynamicBatcher.scoring_service(cpu, max_len=32, mode=mode)
        ta, tb = [a.submit(p) for p in reqs], [b.submit(p) for p in reqs]
        st.launches = sg.launches = 0
        got, want = a.flush(), b.flush()
        assert st.launches == sg.launches == a.stats()["batches"]
        for t, u in zip(ta, tb):
            torch.testing.assert_close(got[t].cpu(), want[u], rtol=2e-4,
                                       atol=2e-5)
    mmd = SK.sig_mmd(torch.tensor(refs[:3]), torch.tensor(refs[3:]), 3)
    want = SK.sig_mmd(torch.tensor(refs[:3]), torch.tensor(refs[3:]), 3,
                      backend="torch", device="cpu")
    torch.testing.assert_close(mmd.cpu(), want, rtol=2e-4, atol=2e-5)


def _level_relerr(got, want, d, depth):
    errs, off = [], 0
    for n in range(1, depth + 1):
        g, w = got[..., off:off + d**n], want[..., off:off + d**n]
        errs.append(float((g - w).norm() / w.norm().clamp_min(1e-30)))
        off += d**n
    return errs


# (B, M, d, N): B off the examples a block shares, M off the 32 staged
# steps, d from 1 to 10 (d = 10, N = 5 has a split whose top level stays in
# shared memory), depth up to 16
RAGGED = [(3, 37, 1, 4), (7, 33, 2, 5), (5, 45, 6, 4), (3, 40, 10, 3),
          (3, 35, 10, 4), (2, 9, 2, 16), (2, 31, 1, 16), (2, 33, 10, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,d,N", RAGGED)
def test_every_partition_variant_at_ragged_shapes(cuda, B, M, d, N):
    x = _incs(B * M + d, B, M, d, cuda)
    cells = [(False, 1), (True, 1), (True, 3), (True, M)]
    want = {c: st.sig_trunc_plain(x.double(), N, stream=c[0],
                                  stream_stride=c[1]) for c in cells}
    for plan in st.partition_variants(B, d, N):
        for stream, stride in cells:
            got = st._launch(x, N, None, stream, stride, "fp32", plan)
            assert got.shape == want[(stream, stride)].shape, plan
            torch.testing.assert_close(got.double(), want[(stream, stride)],
                                       **TOL, msg=lambda m: f"{plan}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,d,N", RAGGED[:5])
def test_bf16_within_its_level_bound_at_every_partition(cuda, B, M, d, N):
    x = _incs(B + M * d, B, M, d, cuda)
    want = st.sig_trunc_plain(x.double(), N)
    wstream = st.sig_trunc_plain(x.double(), N, stream=True, stream_stride=3)
    for plan in st.partition_variants(B, d, N):
        got = st._launch(x, N, None, False, 1, "bf16_fp32", plan)
        stream = st._launch(x, N, None, True, 3, "bf16_fp32", plan)
        assert stream.dtype == torch.bfloat16
        for out, w in ((got, want), (stream, wstream)):
            rel = _level_relerr(out.double(), w, d, N)
            assert all(e <= n * 2.0**-8 for n, e in enumerate(rel, 1)), \
                (plan, rel)


@pytest.mark.cuda
def test_two_runs_are_bitwise_equal(cuda):
    x = _incs(9, 64, 130, 6, cuda)
    for plan in st.partition_variants(64, 6, 5):
        a = st._launch(x, 5, None, False, 1, "fp32", plan)
        assert torch.equal(a, st._launch(x, 5, None, False, 1, "fp32",
                                         plan)), plan
    a = st.sig_trunc(x, 5, stream=True, stream_stride=7)
    assert torch.equal(a, st.sig_trunc(x, 5, stream=True, stream_stride=7))


# (B, M, d, words, max_rows): B off the examples a block holds, M off the
# staged chunk, d from 1 to 10, depth 16, repeated words, and a tile of
# 1,022 rows that runs at 4 rows a thread
def _words_cases():
    rng = np.random.default_rng(18)
    deep = [tuple(int(c) for c in rng.integers(0, 2, n)) for n in
            (16, 16, 12, 9, 3, 1)]
    return [(3, 37, 1, [(0,) * n for n in range(1, 17)], 4),
            (7, 33, 2, tw.all_words(2, 5), 8),
            (5, 45, 4, SPARSE, 2),
            (3, 40, 10, tw.all_words(10, 2) + [(1, 2, 3), (9, 0, 9)], 8),
            (2, 9, 2, deep, 32),
            (2, 31, 4, tw.all_words(4, 3) + SPARSE, 32),
            (3, 19, 2, tw.all_words(2, 9), 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(7))
def test_every_words_partition_at_ragged_shapes(cuda, case):
    B, M, d, words, max_rows = _words_cases()[case]
    tp = tw.make_tiled_plan(words, d, max_rows)
    x = _incs(B * M + d, B, M, d, cuda)
    cells = [(False, 1), (True, 1), (True, 3), (True, M)]
    want = {c: sw.sig_words_plain(x.double(), tp, stream=c[0],
                                  stream_stride=c[1]) for c in cells}
    plans = sw.partition_variants(B, sw.tile_tables(tp), d)
    assert len(plans) >= 2
    for plan in plans:
        for stream, stride in cells:
            got = sw._launch(x, tp, stream, stride, "fp32", plan)
            assert got.shape == want[(stream, stride)].shape, plan
            torch.testing.assert_close(got.double(), want[(stream, stride)],
                                       **TOL, msg=lambda m: f"{plan}: {m}")


@pytest.mark.cuda
def test_words_tile_of_1022_rows_runs_at_4_rows_a_thread(cuda):
    tp = tw.make_tiled_plan(tw.all_words(2, 9), 2, 1024)
    plan = sw.plan_words_launch(3, sw.tile_tables(tp), 2)
    assert (plan.r_pad, plan.rows_per_thread, plan.depth_slots) == \
        (1022, 4, 16)
    x = _incs(7, 3, 19, 2, cuda)
    torch.testing.assert_close(sw.sig_words(x, tp).double(),
                               sw.sig_words_plain(x.double(), tp), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [1, 3, 5])
def test_words_bf16_within_its_level_bound_at_every_partition(cuda, case):
    B, M, d, words, max_rows = _words_cases()[case]
    full = tw.all_words(d, 2)
    tp = tw.make_tiled_plan(full + [w for w in words if len(w) > 2], d,
                            max_rows)
    x = _incs(B + M, B, M, d, cuda)
    want = sw.sig_words_plain(x.double(), tp)
    wstream = sw.sig_words_plain(x.double(), tp, stream=True,
                                 stream_stride=3)
    for plan in sw.partition_variants(B, sw.tile_tables(tp), d):
        got = sw._launch(x, tp, False, 1, "bf16_fp32", plan)
        stream = sw._launch(x, tp, True, 3, "bf16_fp32", plan)
        assert got.dtype == torch.float32 and stream.dtype == torch.bfloat16
        for out, w in ((got, want), (stream, wstream)):
            rel = _level_relerr(out.double()[..., :len(full)],
                                w[..., :len(full)], d, 2)
            assert all(e <= n * 2.0**-8 for n, e in enumerate(rel, 1)), \
                (plan, rel)


@pytest.mark.cuda
def test_words_repeated_words_read_one_row(cuda):
    words = SPARSE + [(0,), (3, 2), (1, 1, 1, 1)]
    tp = tw.make_tiled_plan(words, 4, 2)
    x = _incs(31, 6, 40, 4, cuda)
    for plan in sw.partition_variants(6, sw.tile_tables(tp), 4):
        for stream in (False, True):
            got = sw._launch(x, tp, stream, 7, "fp32", plan)
            for a, b in [(0, 6), (1, 5), (1, 7), (2, 8)]:
                assert torch.equal(got[..., a], got[..., b]), plan


@pytest.mark.cuda
def test_words_two_runs_are_bitwise_equal(cuda):
    tp = tw.make_tiled_plan(tw.all_words(6, 4) + [(5, 4, 3, 2, 1)], 6)
    x = _incs(9, 64, 130, 6, cuda)
    for plan in sw.partition_variants(64, sw.tile_tables(tp), 6):
        for stream, stride in ((False, 1), (True, 7)):
            a = sw._launch(x, tp, stream, stride, "fp32", plan)
            assert torch.equal(a, sw._launch(x, tp, stream, stride, "fp32",
                                             plan)), plan


# ---------------------------------------------------------------------------
# the §4.2 reverse sweep kernel (sig_sweep)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("stream,stride", [(False, 1), (True, 1), (True, 3)])
@pytest.mark.parametrize("d,N", [(2, 3), (1, 16), (3, 6), (10, 5), (40, 3)])
def test_sweep_kernel_matches_plain(cuda, d, N, stream, stride):
    """Every instance (4, 8, 16 link slots), shared memory and the
    device-memory scratch ((10, 5): 111,110 rows; (40, 3): 65,640),
    terminal and streamed.  fp32 sums in atomic order: |err| <= 1e-3·|g| + 1e-4·max|g|
    against the float64 plain sweep."""
    from repro_torch.core.signature import truncation_closure
    from repro_torch.kernels import sig_sweep as ss
    plan = truncation_closure(d, N)
    x = _incs(d * N, 3, 7, d, cuda)
    S_T = st.sig_trunc_plain(x.double(), N)
    shape = (3, -(-7 // stride), S_T.shape[1]) if stream else S_T.shape
    co = torch.randn(shape, generator=torch.Generator().manual_seed(N),
                     dtype=torch.float64).to(cuda)
    ss.launches = 0
    got = ss.sig_sweep(x, plan, S_T.float(), co.float(), stream=stream,
                       stream_stride=stride)
    assert ss.launches == 1 and got.dtype == torch.float32
    want = ss.sig_sweep_plain(x.double(), plan, S_T, co, stream=stream,
                              stream_stride=stride)
    err = (got.double() - want).abs()
    assert bool((err <= 1e-3 * want.abs()
                 + 1e-4 * want.abs().max()).all()), float(err.max())


@pytest.mark.cuda
def test_sweep_kernel_repeated_words_and_no_steps(cuda):
    """A word requested twice adds both cotangents onto its row; no steps
    launch nothing."""
    from repro_torch.kernels import sig_sweep as ss
    plan = tw.make_plan(SPARSE, 4)
    x = _incs(7, 4, 9, 4, cuda)
    S_T = torch.randn(4, plan.closure_size, device=cuda) * 0.1
    co = torch.randn(4, 2, len(SPARSE), device=cuda)
    got = ss.sig_sweep(x, plan, S_T, co, stream=True, stream_stride=5)
    want = ss.sig_sweep_plain(x.double(), plan, S_T.double(), co.double(),
                              stream=True, stream_stride=5)
    torch.testing.assert_close(got.double(), want, rtol=1e-3, atol=1e-5)
    ss.launches = 0
    assert not ss.sig_sweep(x[:, :0], plan, S_T, co[:, 0]).any()
    assert ss.launches == 0
