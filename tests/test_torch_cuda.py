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


# every partition of the levelwise sweep at ragged shapes: truncation
# closures (shared memory and, at (10, 5) and (40, 3), the device-memory
# scratch), ragged word sets with rows that have no children below the top
# level, a repeated word, and a set of letters alone (depth 1)
SWEEP_PLANS = [("trunc", 3, 4), ("trunc", 1, 16), ("trunc", 6, 5),
               ("trunc", 10, 5), ("trunc", 40, 3), ("words", 4, SPARSE),
               ("words", 3, [(0,), (1, 2, 0, 1, 2), (2,), (2, 2)]),
               ("words", 5, [(4,), (0,), (2,), (0,)])]


def _sweep_plan(kind, d, arg):
    from repro_torch.core.signature import truncation_closure
    return truncation_closure(d, arg) if kind == "trunc" \
        else tw.make_plan(arg, d)


def _sweep_inputs(plan, B, M, stride, device, seed):
    x = _incs(seed, B, M, plan.d, device)
    S_T = torch.randn(B, plan.closure_size, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(seed)) * 0.1
    shape = (B, -(-M // stride), len(plan.words)) if stride \
        else (B, len(plan.words))
    co = torch.randn(shape, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(seed + 1))
    return x, S_T.to(device), co.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [0, 3])
@pytest.mark.parametrize("k", range(len(SWEEP_PLANS)))
def test_sweep_every_partition_matches_plain(cuda, k, stride):
    """Each partition the planner can choose (its own, one warp and the
    most threads an example, shared memory or scratch), forced: |err| <=
    1e-3·|g| + 1e-4·max|g| against the float64 plain sweep, as the
    kernel's other tests."""
    from repro_torch.kernels import sig_sweep as ss
    plan = _sweep_plan(*SWEEP_PLANS[k])
    B = 3 if plan.closure_size > 20_000 else 7
    x, S_T, co = _sweep_inputs(plan, B, 11, stride, cuda, k)
    want = ss.sig_sweep_plain(x.double(), plan, S_T, co, stream=bool(stride),
                              stream_stride=stride or 1)
    variants = ss.partition_variants(plan)
    assert {p.in_smem for p in variants} >= {False}
    for p in variants:
        got = ss._launch(x, plan, S_T.float(), co.float(), stride, p)
        torch.cuda.synchronize()
        err = (got.double() - want).abs()
        assert bool((err <= 1e-3 * want.abs()
                     + 1e-4 * want.abs().max()).all()), (p, float(err.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(SWEEP_PLANS)))
def test_sweep_two_runs_are_bitwise_equal(cuda, k):
    """No atomics: every partition gives the same bits on a second run."""
    from repro_torch.kernels import sig_sweep as ss
    plan = _sweep_plan(*SWEEP_PLANS[k])
    x, S_T, co = _sweep_inputs(plan, 5, 9, 2, cuda, 50 + k)
    for p in ss.partition_variants(plan):
        a = ss._launch(x, plan, S_T.float(), co.float(), 2, p)
        assert torch.equal(a, ss._launch(x, plan, S_T.float(), co.float(),
                                         2, p)), p


# ---------------------------------------------------------------------------
# fused transforms: raw increments and time rows into the kernels
# ---------------------------------------------------------------------------

FUSED = ["lead_lag", "time_augment", "time_augment+lead_lag"]


def _fused_inputs(seed, B, M, d, spec, device):
    """Raw increments and the time rows of a ragged batch."""
    from repro_torch.core.transforms import transform_time_aux
    x = _incs(seed, B, M, d, device)
    lengths = torch.tensor(np.random.default_rng(seed).integers(
        0, M + 1, size=B), device=device)
    return x, transform_time_aux(spec, B, M, lengths, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("stream,stride", [(False, 1), (True, 1), (True, 3)])
@pytest.mark.parametrize("tname", FUSED)
def test_fused_trunc_kernel_matches_plain_at_every_partition(cuda, tname,
                                                             stream, stride):
    from repro_torch.core.transforms import as_transform, transform_dim
    spec = as_transform(tname)
    for d, N in [(1, 4), (2, 3), (5, 3)]:
        x, taux = _fused_inputs(d, 5, 37, d, spec, cuda)
        want = st.sig_trunc_plain(x.double(), N, stream=stream,
                                  stream_stride=stride, transform=spec,
                                  taux=taux)
        for plan in st.partition_variants(5, transform_dim(spec, d), N):
            got = st._launch(x, N, None, stream, stride, "fp32", plan, spec,
                             taux)
            torch.testing.assert_close(got.double(), want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("stream,stride", [(False, 1), (True, 1), (True, 3)])
@pytest.mark.parametrize("tname", FUSED)
def test_fused_words_kernel_matches_plain_at_every_partition(cuda, tname,
                                                             stream, stride):
    from repro_torch.core.transforms import (as_transform,
                                             sparse_leadlag_generators,
                                             transform_dim)
    spec = as_transform(tname)
    d = 3
    da = transform_dim(spec, d)
    words = tw.generated_words(sparse_leadlag_generators(d), 4) \
        if tname == "lead_lag" else tw.all_words(da, 3)
    x, taux = _fused_inputs(7, 5, 37, d, spec, cuda)
    for max_rows in (8, 256):
        tp = tw.make_tiled_plan(words, da, max_rows)
        want = sw.sig_words_plain(x.double(), tp, stream=stream,
                                  stream_stride=stride, transform=spec,
                                  taux=taux)
        for plan in sw.partition_variants(5, sw.tile_tables(tp), da,
                                          lead_lag=spec.lead_lag):
            got = sw._launch(x, tp, stream, stride, "fp32", plan, spec, taux)
            torch.testing.assert_close(got.double(), want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("tname", ["basepoint+lead_lag+time_augment",
                                   "time_augment+lead_lag"])
def test_fused_dispatch_one_launch_and_the_torch_engine(cuda, tname):
    """ops.signature and ops.projected with a transform: one fused launch
    each, one sig_sweep a backward, values and gradients as the torch
    engine's (fp32 sums: gradients rtol 1e-3, atol 1e-5)."""
    from repro_torch.core.transforms import as_transform, transform_dim
    from repro_torch.kernels import sig_sweep as ss
    spec = as_transform(tname)
    x = _incs(11, 4, 23, 2, cuda).requires_grad_()
    x0 = _incs(12, 4, 1, 2, cuda)[:, 0]
    lengths = torch.tensor([23, 9, 1, 0], device=cuda)
    words = tw.all_words(transform_dim(spec, 2), 3)[:50]
    for fn, kernel in ((lambda v, **k: ops.signature(v, 3, **k), st),
                       (lambda v, **k: ops.projected(v, words, **k), sw)):
        kernel.launches = kernel.fused_launches = ss.launches = 0
        out = fn(x, transform=tname, x0=x0, lengths=lengths)
        co = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            1)).to(cuda)
        g, = torch.autograd.grad(out, x, co)
        assert (kernel.launches, kernel.fused_launches, ss.launches) == (
            1, 1, 1)
        x64 = x.detach().double().requires_grad_()
        want = fn(x64, transform=tname, x0=x0.double(), lengths=lengths,
                  backend="torch")
        g64, = torch.autograd.grad(want, x64, co.double())
        torch.testing.assert_close(out.double(), want, **TOL)
        torch.testing.assert_close(g.double(), g64, rtol=1e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# the session pool on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_session_pool_on_the_card_matches_the_torch_engine(cuda):
    """The same traffic through a pool on the card and one on the CPU
    (torch engine): one sig_trunc launch a flush bucket, rings, lengths and
    liveness equal, signatures within TOL; a checkpoint round-trips the
    card's pool bitwise."""
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import session_tick_stream
    from repro_torch.serve import SessionStore
    kw = dict(ring_capacity=48, initial_sessions=16, max_ticks=8,
              max_rows=16)
    card = SessionStore(3, 3, device=cuda, **kw)
    cpu = SessionStore(3, 3, device="cpu", backend="torch", **kw)
    traffic = session_tick_stream(40, 3, seed=2, max_ticks=12)
    for _ in range(3):
        r = next(traffic)
        # buckets of at most 16 rows a tick rung, in two waves of 8 ticks
        rungs = np.minimum(8, 2 ** np.ceil(np.log2(np.minimum(
            r["counts"], 8))).astype(int))
        wave2 = np.minimum(8, 2 ** np.ceil(np.log2(np.maximum(
            r["counts"][r["counts"] > 8] - 8, 1))).astype(int))
        for s in (card, cpu):
            s.ingest_many(r["sids"], r["counts"], r["ticks"],
                          auto_create=True)
        st.launches = st.stream_launches = 0
        card.flush()
        torch.cuda.synchronize()
        want = sum(-(-int((rungs == u).sum()) // 16) for u in set(rungs)) \
            + sum(-(-int((wave2 == u).sum()) // 16) for u in set(wave2))
        assert (st.launches, st.stream_launches) == (want, 0)
        cpu.flush()
    for lane in ("ring", "length", "end", "valid"):
        assert torch.equal(getattr(card.pool, lane).cpu(),
                           getattr(cpu.pool, lane))
    torch.testing.assert_close(card.pool.sig.cpu(), cpu.pool.sig, **TOL)
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp, async_save=False)
        card.checkpoint(ck, 1)
        back = SessionStore.restore(ck, device=cuda)
        for lane in ("sig", "ring", "length", "end", "valid"):
            assert torch.equal(getattr(back.pool, lane),
                               getattr(card.pool, lane))


@pytest.mark.cuda
def test_engines_on_the_card_launch_once_a_push(cuda):
    from repro_torch.serve import SigStreamEngine
    x = _incs(3, 4, 30, 2, cuda)
    eng = SigStreamEngine(d=2, depth=3, batch=4, window=12,
                          stream_stride=2)
    cpu = SigStreamEngine(d=2, depth=3, batch=4, window=12,
                          stream_stride=2, backend="torch", device="cpu")
    for k in range(5):
        st.launches = st.stream_launches = 0
        got = eng.push(x[:, 6 * k:6 * (k + 1)])
        torch.cuda.synchronize()
        assert (st.launches, st.stream_launches) == (0, 1)
        torch.testing.assert_close(got.cpu(), cpu.push(
            x[:, 6 * k:6 * (k + 1)].cpu()), **TOL)
    refs = torch.cumsum(_incs(4, 9, 20, 2, cuda), dim=1)
    score = SigScoreEngine(d=2, depth=3, batch=4, references=refs,
                           targets=torch.linspace(-1, 1, 9), window=12)
    for k in range(3):
        st.launches = sg.launches = 0
        score.push(x[:, 6 * k:6 * (k + 1)])
        score.predict()
        score.nearest()
        torch.cuda.synchronize()
        assert (st.launches, sg.launches) == (1, 1)


@pytest.mark.cuda
def test_batcher_prefetch_on_the_card_is_bitwise_serial(cuda):
    rng = np.random.default_rng(5)
    reqs = [np.cumsum(rng.normal(size=(L + 1, 3)) * 0.2, axis=0).astype(
        np.float32) for L in rng.integers(1, 200, size=60)]
    out = {}
    for flag in (True, False):
        db = DynamicBatcher.signature_service(3, 4, max_len=256,
                                              max_batch=8,
                                              async_dispatch=flag)
        tickets = [db.submit(p) for p in reqs]
        res = db.flush()
        out[flag] = torch.stack([res[t] for t in tickets])
        stats = db.stats()
        assert stats["in_flight_peak"] <= db.max_in_flight
        assert (stats["prefetched_rungs"] > 0) == flag
    assert torch.equal(out[True], out[False])


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    """A temporary autotune cache in load mode, on this card."""
    from repro_torch.kernels import autotune
    p = tmp_path / "tune.json"
    monkeypatch.setenv("PATHSIG_AUTOTUNE_CACHE", str(p))
    monkeypatch.setenv("PATHSIG_AUTOTUNE", "load")
    autotune.clear()
    yield autotune
    autotune.clear()


@pytest.mark.cuda
def test_tuned_sig_trunc_partitions_match_plain(cuda, tune_cache):
    """Every {split, examples} the tuner may record, taken from its cache
    by ops.signature, against the plain version."""
    x = _incs(40, 6, 21, 3, cuda)
    want = st.sig_trunc_plain(x.double(), 4)
    cell = dict(engine="cuda", d=3, depth=4, M=21, B=6, precision="fp32")
    key = tune_cache.cell_key("sig_trunc", **cell)
    for p in st.partition_variants(6, 3, 4):
        tune_cache.save_cache({key: {"split": p.split,
                                     "examples": p.examples}})
        st.launches = 0
        got = ops.signature(x, 4)
        assert st.launches == 1
        torch.testing.assert_close(got.double(), want, **TOL)


@pytest.mark.cuda
def test_tuned_gram_partitions_match_plain(cuda, tune_cache):
    g = torch.Generator().manual_seed(3)
    Sx = torch.randn((70, 1300), generator=g).to(cuda)
    Sy = torch.randn((130, 1300), generator=g).to(cuda)
    w = torch.rand(1300, generator=g).to(cuda)
    want = sg.sig_gram_plain(Sx.double(), Sy.double(), w.double())
    key = tune_cache.cell_key("gram", engine="cuda", D=1300, Bx=70, By=130,
                              precision="fp32")
    for rows in (64, 128):
        for words in (512, 1024, 1536):
            tune_cache.save_cache({key: {"rows": rows,
                                         "slice_words": words}})
            got = ops.gram(Sx, Sy, w)
            assert (got.double() - want).abs().max() <= \
                1e-5 * want.abs().max()


@pytest.mark.cuda
def test_hybrid_on_card_tensors_matches_the_word_kernel(cuda):
    """backend="hybrid" runs plain PyTorch on the card: values and
    gradients against the sig_words route and sig_sweep."""
    d, N = 4, 4
    words = tw.all_words(d, N - 1) + [w for w in tw.lyndon_words(d, N)
                                      if len(w) == N]
    x = _incs(41, 8, 30, d, cuda).requires_grad_()
    outs, grads = [], []
    for backend in ("hybrid", "cuda"):
        out = ops.projected(x, words, backend=backend)
        (g,) = torch.autograd.grad((out ** 2).sum(), x)
        outs.append(out.double())
        grads.append(g.double())
    assert outs[0].device.type == "cuda"
    torch.testing.assert_close(outs[0], outs[1], **TOL)
    scale = grads[1].abs().max()
    assert ((grads[0] - grads[1]).abs()
            <= 1e-3 * grads[1].abs() + 1e-4 * scale).all()
