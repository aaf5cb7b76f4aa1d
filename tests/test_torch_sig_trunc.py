"""The port's ``sig_trunc`` module against the reference cone kernel.

On the CPU the wrapper runs its plain version; it is held against the JAX
Pallas kernel in interpret mode (non-streamed, forced splits), the JAX
stream engine (the reference's streamed Pallas cell does not run on the
installed jax), and the naive oracles.  The cone index math that the CUDA
kernel's output goes through is tested here against the reference's
``_reassemble``.  Tolerances: rtol 2e-4, atol 2e-5 for fp32; n·2^-8 per
level for bf16_fp32.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.signature import signature_from_increments as j_sig_incs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import from_numpy
from repro_torch.core.words import sig_dim
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sig_trunc as st

# the module, not the function that repro.kernels re-exports under its name
jst = importlib.import_module("repro.kernels.sig_trunc")

TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _autotune_off(monkeypatch):
    monkeypatch.setenv("PATHSIG_AUTOTUNE", "off")


def _incs(seed, B, M, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, M, d)) * 0.3).astype(np.float32)


def _per_level_relerr(got, ref, d, depth):
    errs, off = [], 0
    for n in range(1, depth + 1):
        w = d**n
        g, r = got[..., off:off + w], ref[..., off:off + w]
        errs.append(float(np.linalg.norm(g - r) /
                          max(np.linalg.norm(r), 1e-30)))
        off += w
    return errs


@pytest.mark.parametrize("B,M,d,N,split", [
    (3, 9, 3, 4, 0), (3, 9, 3, 4, 2), (5, 6, 2, 5, 3), (2, 4, 6, 3, 1),
])
def test_plain_matches_pallas_interpret_and_oracles(B, M, d, N, split):
    x = _incs(B * M + split, B, M, d)
    want = np.asarray(jops.signature(jnp.asarray(x), N,
                                     backend="pallas_interpret",
                                     batch_tile=8, split=split))
    got = st.sig_trunc(from_numpy(x, device="cpu"), N, split=split)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        tref.sig_trunc_ref(from_numpy(x, device="cpu"), N).numpy(),
        np.asarray(jref.sig_trunc_ref(jnp.asarray(x), N)), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jref.sig_trunc_ref(jnp.asarray(x), N)), **TOL)


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_plain_stream_matches_jax_stream_engine(stride):
    x = _incs(stride, 3, 8, 3)
    want = np.asarray(j_sig_incs(jnp.asarray(x), 3, stream=True,
                                 stream_stride=stride, backend="jax"))
    got = st.sig_trunc(from_numpy(x, device="cpu"), 3, stream=True,
                       stream_stride=stride)
    assert got.shape == want.shape == (3, -(-8 // stride), sig_dim(3, 3))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bf16_within_per_level_bound_and_agrees_with_reference():
    x = _incs(7, 4, 20, 3)
    tx = from_numpy(x, device="cpu")
    ref = st.sig_trunc(tx.double(), 5).numpy()
    got = st.sig_trunc(tx, 5, precision="bf16_fp32").numpy()
    for n, err in enumerate(_per_level_relerr(got, ref, 3, 5), start=1):
        assert err <= n * 2.0**-8, (n, err)
    want = np.asarray(jops.signature(jnp.asarray(x), 5, backend="jax",
                                     precision="bf16_fp32"))
    np.testing.assert_allclose(got, want, atol=3e-6)
    stream = st.sig_trunc(tx, 5, stream=True, stream_stride=3,
                          precision="bf16_fp32")
    assert torch.equal(stream, stream.to(torch.bfloat16).float())


def test_float64_runs_in_fp32_and_casts_back():
    x = from_numpy(_incs(3, 2, 5, 2), device="cpu").double()
    out = st.sig_trunc(x, 3)
    assert out.dtype == torch.float64
    assert torch.equal(out, st.sig_trunc(x.float(), 3).double())


@pytest.mark.parametrize("stream", [False, True])
def test_zero_steps_give_zeros(stream):
    out = st.sig_trunc(torch.zeros(3, 0, 2), 3, stream=stream)
    assert out.shape == ((3, 0, 14) if stream else (3, 14))
    assert not out.any()


# ---------------------------------------------------------------------------
# the cone geometry and index math the CUDA kernel's output goes through
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,N", [(2, 3), (3, 4), (6, 5), (10, 3), (10, 5)])
def test_cone_geometry_matches_reference(d, N):
    for s in range(N):
        np.testing.assert_array_equal(st.cone_offsets(d, N, s),
                                      jst.cone_offsets(d, N, s))
        assert st.cone_rows(d, N, s) == jst.cone_rows(d, N, s)
        assert st.cone_base_level(s) == jst.cone_base_level(s)
        rows = max(0, s - 1) + st.cone_rows(d, N, s)
        assert st.state_footprint(d, N, s) == 4 * (rows + st.CHUNK * d)


def test_choose_split_fits_hopper_shared_memory():
    # bytes of fp32 state per example: 37,320 / 4,440 / 444,440 at s = 0
    assert [st.choose_split(d, N) for d, N in [(6, 5), (10, 3), (10, 5)]] \
        == [0, 0, 1]
    for d, N in [(2, 3), (6, 5), (10, 5), (40, 3)]:
        s = st.choose_split(d, N)
        assert st.state_footprint(d, N, s) <= st.SMEM_BUDGET
        assert s == 0 or st.state_footprint(d, N, s - 1) > st.SMEM_BUDGET
    assert st.choose_split(6, 5, smem_budget=10_000) == 1
    with pytest.raises(ValueError):
        st.choose_split(200, 2, smem_budget=100)
    with pytest.raises(ValueError):
        st.sig_trunc(torch.zeros(1, 2, 10), 5, split=0)  # 444 KB of state


@pytest.mark.parametrize("d,N", [(2, 3), (3, 3), (4, 2)])
def test_reassemble_matches_reference(d, N):
    rng = np.random.default_rng(d * N)
    for s in range(N):
        rows = max(0, s - 1) + st.cone_rows(d, N, s)
        blocks = rng.normal(size=(5, d**s, rows)).astype(np.float32)
        got = st._reassemble(torch.from_numpy(blocks), d, N, s)
        want = jst._reassemble(jnp.asarray(np.moveaxis(blocks, 0, -1)),
                               d, N, s, 5)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        sblocks = rng.normal(size=(2, 3, d**s, rows)).astype(np.float32)
        got = st._reassemble(torch.from_numpy(sblocks), d, N, s)
        want = jst._reassemble_stream(
            jnp.asarray(np.moveaxis(sblocks, 0, -1)), d, N, s, 2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d,N", [(2, 4), (3, 3), (6, 3)])
def test_scatter_then_reassemble_is_identity(d, N):
    """Scatter a flat signature into cone blocks the way the kernel lays
    them out (every cone carries its ancestor path), then reassemble."""
    D = sig_dim(d, N)
    flat = torch.arange(1, D + 1, dtype=torch.float32)[None]
    offs = np.concatenate([[0], np.cumsum([d**n for n in range(1, N + 1)])])
    for s in range(N):
        n_path, base = max(0, s - 1), st.cone_base_level(s)
        co = st.cone_offsets(d, N, s)
        blocks = torch.zeros(1, d**s, n_path + st.cone_rows(d, N, s))
        for c in range(d**s):
            for lev in range(1, s):  # ancestor u_{1:lev}
                blocks[0, c, lev - 1] = flat[0, offs[lev - 1]
                                             + c // d ** (s - lev)]
            for n in range(base, N + 1):
                w = d ** (n - s)
                lo = offs[n - 1] + c * w
                r0 = n_path + co[n - base]
                blocks[0, c, r0:r0 + w] = flat[0, lo:lo + w]
        assert torch.equal(st._reassemble(blocks, d, N, s), flat)
        assert sorted(st.cone_gather_index(d, N, s).tolist()) == sorted(
            set(st.cone_gather_index(d, N, s).tolist()))


# ---------------------------------------------------------------------------
# the CUDA cell: forward-only autograd node, kernel on the card
# ---------------------------------------------------------------------------

def test_cuda_cell_backward_raises(monkeypatch):
    """The launch is stubbed with the plain version so the autograd node
    runs on the CPU; its backward must raise, never drop gradients."""
    monkeypatch.setattr(st, "_launch",
                        lambda incs, depth, *a: st.sig_trunc_plain(
                            incs.detach(), depth))
    x = from_numpy(_incs(0, 2, 4, 2), device="cpu").requires_grad_()
    out = st.SigTruncFunction.apply(x, 3, None, False, 1, "fp32")
    assert out.grad_fn is not None
    with pytest.raises(NotImplementedError, match="inverse backward"):
        out.sum().backward()


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        st.sig_trunc(torch.zeros(1, 2, 2, device="meta"), 2)
