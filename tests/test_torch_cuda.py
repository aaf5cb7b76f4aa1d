"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

The kernels have no CPU mode, so these skip without a card; elsewhere their
plain versions are tested on the CPU.  This file imports nothing of JAX, so
it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import words as tw
from repro_torch.core.logsignature import logsignature_projected
from repro_torch.kernels import ops
from repro_torch.kernels import sig_trunc as st
from repro_torch.kernels import sig_words as sw

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
    x = _incs(3, 2, 5, 2, cuda).requires_grad_()
    out = ops.signature(x, 3)
    with pytest.raises(NotImplementedError, match="inverse backward"):
        out.sum().backward()
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
    x = _incs(5, 2, 5, 4, cuda).requires_grad_()
    out = ops.projected(x, SPARSE)
    with pytest.raises(NotImplementedError, match="inverse backward"):
        out.sum().backward()
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
