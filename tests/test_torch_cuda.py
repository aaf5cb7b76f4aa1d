"""Card-only tests of the port's CUDA kernel (marker ``cuda``).

The kernel has no CPU mode, so these skip without a card; elsewhere its
plain version is tested on the CPU.  This file imports nothing of JAX, so
it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import sig_trunc as st

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
