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
# the CUDA cell: autograd node with the sweep backward, kernel on the card
# ---------------------------------------------------------------------------

def test_cuda_cell_backward_raises(monkeypatch):
    """The launch is stubbed with the plain version so the autograd node
    runs on the CPU.  Its backward no longer raises: it is the §4.2 sweep
    over the truncation's word table from the saved terminal signature
    (the last emission when streamed), equal to the plain sweep and to
    autodiff through the plain scan."""
    monkeypatch.setattr(st, "_launch",
                        lambda incs, depth, split, stream, stride, *a:
                        st.sig_trunc_plain(incs.detach(), depth,
                                           stream=stream,
                                           stream_stride=stride))
    from repro_torch.core.signature import truncation_closure
    from repro_torch.kernels.sig_sweep import sig_sweep_plain
    xn = _incs(0, 2, 4, 2)
    for stream, stride in ((False, 1), (True, 1), (True, 3)):
        x = from_numpy(xn, device="cpu").requires_grad_()
        out = st.SigTruncFunction.apply(x, 3, None, stream, stride, "fp32")
        assert out.grad_fn is not None
        co = torch.from_numpy(np.random.default_rng(stride).normal(
            size=tuple(out.shape)).astype(np.float32))
        g, = torch.autograd.grad(out, x, co)
        terminal = out[:, -1] if stream else out
        want = sig_sweep_plain(x.detach(), truncation_closure(2, 3),
                               terminal.detach(), co, stream=stream,
                               stream_stride=stride)
        torch.testing.assert_close(g, want)
        x2 = x.detach().requires_grad_()
        ad, = torch.autograd.grad(st.sig_trunc_plain(
            x2, 3, stream=stream, stream_stride=stride), x2, co)
        torch.testing.assert_close(g, ad, rtol=1e-3, atol=1e-5)


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device of another type."""

    @property
    def device(self):
        return torch.device("xpu")


def test_wrapper_rejects_other_devices():
    """A device other than the CPU, CUDA and meta raises; a meta tensor
    runs the operator's Meta implementation: the kernel's output shape,
    nothing launched."""
    with pytest.raises(ValueError, match="cuda, meta or cpu"):
        st.sig_trunc(torch.zeros(1, 2, 2).as_subclass(_Elsewhere), 2)
    before = st.launches
    out = st.sig_trunc(torch.zeros(1, 2, 2, device="meta"), 2)
    assert out.is_meta and tuple(out.shape) == (1, 6)
    assert st.launches == before


# ---------------------------------------------------------------------------
# the kernel's launch planner and shared-memory accounting
# ---------------------------------------------------------------------------

SWEEP = [(2, 3), (3, 4), (6, 5), (10, 3), (10, 5)]   # chip_smoke.py's
TABLE1 = ([(32, 100, 6, n) for n in (2, 3, 4, 5)]
          + [(64, m, 4, 5) for m in (50, 100, 200, 500)]
          + [(b, 200, 10, 3) for b in (1, 16, 64, 128)])
PLAN_SHAPES = sorted(set(SWEEP + [(d, N) for _, _, d, N in TABLE1]
                         + [(1, 4), (2, 16), (40, 3)]))


def test_planner_fills_the_card_at_the_serving_micro_batch():
    plan = st.plan_launch(64, 6, 5)
    assert (plan.split, plan.threads, plan.top_slots, plan.examples) \
        == (1, 96, 16, 1)
    assert plan.grid == (64, 6) and 64 * 6 >= st.SMS
    assert plan.smem == st.kernel_smem(6, 5, 1, 16) == 6136
    assert st.plan_launch(2048, 6, 5).grid == (2048, 6)


def _check_plan(plan, B, d, N):
    t, k = plan.threads, plan.top_slots
    if k:
        assert t * k >= d ** (N - plan.split)      # every top word owned
    else:
        assert d ** (N - plan.split) > st.MAX_TOP  # only when too wide
    assert plan.block <= st.MAX_BLOCK[k]            # the register budget
    assert plan.smem == plan.examples * st.kernel_smem(d, N, plan.split, k)
    assert plan.smem <= st.SMEM_BUDGET
    assert plan.split >= st.choose_split(d, N)
    assert plan.grid == (-(-B // plan.examples), d**plan.split)
    assert plan.grid[1] <= st.MAX_CELLS


@pytest.mark.parametrize("B", [1, 5, 64, 2048])
def test_planner_fits_shared_memory_and_registers(B):
    for d, N in PLAN_SHAPES:
        plan = st.plan_launch(B, d, N)
        _check_plan(plan, B, d, N)
        top = d ** (N - plan.split)
        assert top <= st.PLAN_TOP
        # the smallest split that keeps the top narrow and fills the card
        narrow = [s for s in st.feasible_splits(d, N)
                  if d ** (N - s) <= st.PLAN_TOP]
        full = [s for s in narrow if B * d**s >= st.SMS]
        assert plan.split == (full[0] if full else narrow[-1])


@pytest.mark.parametrize("d,N", PLAN_SHAPES)
def test_planner_honours_every_split_the_wrapper_accepts(d, N):
    for s in range(N):
        try:
            st.check_split(d, N, s)
        except ValueError:
            with pytest.raises(ValueError):
                st.sig_trunc(torch.zeros(1, 2, d), N, split=s)
            assert s not in st.feasible_splits(d, N)
            continue
        assert s in st.feasible_splits(d, N)
        for B in (1, 5, 64, 2048):
            plan = st.plan_launch(B, d, N, split=s)
            assert plan.split == s
            _check_plan(plan, B, d, N)


def test_kernel_smem_counts_the_rows_below_the_top_and_the_buffers():
    for d, N in PLAN_SHAPES:
        for s in st.feasible_splits(d, N):
            low = st.level_rows(d, N, s)[N]
            assert low + d ** (N - s) == max(0, s - 1) + st.cone_rows(d, N, s)
            extra = st.chain_offsets(d, N, s)[-1] + st.CHUNK * N * d
            assert st.kernel_smem(d, N, s, 4) == 4 * (low + extra)
            assert st.kernel_smem(d, N, s, 0) == 4 * (low + d ** (N - s)
                                                      + extra)


def test_every_split_runs_at_d3_n4_and_a_wide_top_stays_in_shared_memory():
    assert st.feasible_splits(3, 4) == [0, 1, 2, 3]
    plan = st.plan_launch(5, 10, 5, split=1)    # 10^4 top-level words
    assert plan.top_slots == 0 and plan.threads == st.MAX_THREADS
    with pytest.raises(ValueError):
        st.plan_launch(5, 10, 5, split=0)       # 444 KB of cone state


def test_planner_shares_blocks_between_small_cones():
    plan = st.plan_launch(2048, 2, 3)   # 8 top-level words a cone
    assert plan.examples > 1 and plan.block <= st.MIN_BLOCK
    assert plan.grid[0] * plan.grid[1] >= st.SMS
    assert st.plan_launch(5, 2, 3).examples == 1   # too few to share
    forced = st.plan_launch(5, 2, 3, split=0, examples=4)
    assert forced.examples == 4 and forced.grid == (2, 1)
    with pytest.raises(ValueError):
        st.plan_launch(5, 6, 5, split=1, examples=64)  # 64 x 96 threads


@pytest.mark.parametrize("B,d,N", [(5, 2, 3), (3, 1, 4), (7, 6, 5),
                                   (3, 10, 3), (2, 2, 16), (5, 10, 5)])
def test_partition_variants_cover_every_split_and_sharing(B, d, N):
    plans = st.partition_variants(B, d, N)
    assert plans[0] == st.plan_launch(B, d, N)
    assert {p.split for p in plans} == set(st.feasible_splits(d, N))
    for p in plans:
        _check_plan(p, B, d, N)
    if d**N <= 64:  # small cones: some variant shares a block
        assert any(p.examples > 1 for p in plans)


# ---------------------------------------------------------------------------
# the kernel's step schedule, emulated in numpy float32
# ---------------------------------------------------------------------------

def _emulate_kernel(x, d, N, plan):
    """The CUDA kernel's schedule for every (example, cone) of ``plan``:
    thread n-1 walks target n's chain along the prefix u from the path's
    old values; then levels j = s+1..N, thread t taking entries w = t,
    t+T, ... with parent v and letter i stepped by divmod(T, d) as the
    kernel steps them.  Level j reads level j-1's chain buffer and leaves
    its own; each state entry is touched by one thread only.  With top
    slots the top level lives in per-thread slots k (word t + k·T) and
    only reads level N-1's buffer.  Returns the (B, d^s, rows) blocks."""
    B, M, _ = x.shape
    s, T, KT = plan.split, plan.threads, plan.top_slots
    cnt = st.level_counts(d, N, s)
    srow, boff = st.level_rows(d, N, s), st.chain_offsets(d, N, s)
    rows = max(0, s - 1) + st.cone_rows(d, N, s)
    qT, rT = divmod(T, d)
    scale = (1.0 / np.arange(1, N + 1)).astype(np.float32)
    out = np.zeros((B, d**s, rows), np.float32)
    jend = N if KT else N + 1
    for c in range(d**s):
        u = [0] + [(c // d ** (s - j)) % d for j in range(1, s + 1)]
        state = np.zeros((B, rows), np.float32)
        top = np.zeros((B, T, max(KT, 1)), np.float32)
        buf = np.zeros((B, boff[-1]), np.float32)
        buf[:, :N] = 1.0
        for m in range(M):
            dx = (scale[:, None] * x[:, m, None, :]).astype(np.float32)
            new = {}
            for n in range(1, N + 1) if s else ():  # thread (n-1) % T
                acc = dx[:, n - 1, u[1]]
                for j in range(2, min(s, n) + 1):  # old path values only
                    acc = (state[:, j - 2] + acc) * dx[:, n - j, u[j]]
                if n > s:
                    buf[:, boff[s] + n - s - 1] = state[:, s - 1] + acc
                else:
                    new[n] = state[:, n - 1] + acc
            for n, val in new.items():  # after every chain has read
                state[:, n - 1] = val
            for j in range(s + 1, jend):
                bp, bc, r = boff[j - 1], boff[j], srow[j]
                touched = np.zeros(cnt[j], np.int64)
                nbuf = buf.copy()  # the level's writes land after its reads
                for t in range(T):
                    v, i = t // d, t % d
                    for w in range(t, cnt[j], T):
                        assert (v, i) == divmod(w, d)
                        touched[w] += 1
                        old = state[:, r + w].copy()
                        state[:, r + w] = old + buf[:, bp + v] * dx[:, 0, i]
                        for n in range(j + 1, N + 1):
                            nbuf[:, bc + (n - j - 1) * cnt[j] + w] = (
                                old + buf[:, bp + (n - j) * cnt[j - 1] + v]
                                * dx[:, n - j, i])
                        v, i = v + qT, i + rT
                        if i >= d:
                            v, i = v + 1, i - d
                assert (touched == 1).all()
                buf = nbuf
            if KT:  # the top level, in the threads' register slots
                for t in range(T):
                    v, i = t // d, t % d
                    for k in range(KT):
                        if t + k * T < cnt[N]:
                            assert (v, i) == divmod(t + k * T, d)
                            top[:, t, k] += buf[:, boff[N - 1] + v] \
                                * dx[:, 0, i]
                        v, i = v + qT, i + rT
                        if i >= d:
                            v, i = v + 1, i - d
        if KT:
            w = np.arange(cnt[N])
            assert (w // T < KT).all()
            state[:, srow[N]:] = top[:, w % T, w // T]
        out[:, c] = state
    return out


@pytest.mark.parametrize("split", [0, 1, 2, 3])
def test_emulated_schedule_matches_reference_at_every_split(split):
    x = _incs(split, 3, 9, 3)
    want = np.asarray(jops.signature(jnp.asarray(x), 4,
                                     backend="pallas_interpret",
                                     batch_tile=8, split=split))
    for plan in {st.plan_launch(3, 3, 4, split=split),
                 st.plan_launch(3, 3, 4, split=split, examples=1)}:
        blocks = _emulate_kernel(x, 3, 4, plan)
        got = st._reassemble(torch.from_numpy(blocks), 3, 4, split).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, np.asarray(
            jref.sig_trunc_ref(jnp.asarray(x), 4)), **TOL)


@pytest.mark.parametrize("d,N,s,T,KT", [
    (2, 3, 0, 3, 4), (3, 3, 0, 32, 1), (3, 4, 1, 5, 8), (3, 4, 2, 4, 4),
    (2, 4, 3, 1, 2), (4, 3, 1, 6, 4), (1, 4, 0, 2, 1), (1, 3, 2, 1, 1),
    (2, 5, 2, 7, 2), (3, 3, 0, 5, 0), (2, 4, 1, 3, 0),
])
def test_emulated_schedule_at_odd_thread_counts(d, N, s, T, KT):
    """Threads that are no multiple of d, fewer threads than levels, and
    the top level in shared memory (KT = 0) or in registers."""
    plan = st.LaunchPlan(s, T, KT, 1, (2, d**s), 0)
    x = _incs(d * N + s + T, 2, 4, d)
    got = st._reassemble(torch.from_numpy(_emulate_kernel(x, d, N, plan)),
                         d, N, s).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jref.sig_trunc_ref(jnp.asarray(x), N)), **TOL)


def test_old_splits_run_unless_a_wide_top_and_its_buffers_overflow():
    """Every split the state-footprint rule accepts runs, unless its top
    level is too wide for the registers and, kept in shared memory with
    the chain buffers and staged increments, passes the budget."""
    refused = []
    for d in range(1, 80):
        for N in range(1, st.MAX_DEPTH + 1):
            for s in range(N):
                if (d ** (N - s) > 10**8 or d**s > st.MAX_CELLS
                        or st.state_footprint(d, N, s) > st.SMEM_BUDGET):
                    continue
                if s in st.feasible_splits(d, N):
                    continue
                assert d ** (N - s) > st.MAX_TOP
                assert st.kernel_smem(d, N, s, 0) > st.SMEM_BUDGET
                refused.append((d, N, s))
    assert (2, 14, 0) in refused and (6, 6, 0) in refused
