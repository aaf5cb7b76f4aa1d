"""The §4.2 reverse sweep (``repro_torch.kernels.sig_sweep``) against the
reference's four ``lax.scan`` sweeps, called directly on the same terminal
states and cotangents, and the kernel's host-side tables and index maps.

The kernel itself has no CPU mode: it is held against
:func:`sig_sweep_plain` on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).  Tolerance: the reference's gradient tolerance, rtol
1e-3, atol 1e-5.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import words as jw
from repro_torch.core import projection as tp
from repro_torch.core import signature as ts
from repro_torch.core import words as tw
from repro_torch.kernels import sig_sweep as ss

js = importlib.import_module("repro.core.signature")
jproj = importlib.import_module("repro.core.projection")

GTOL = dict(rtol=1e-3, atol=1e-5)
SWEEP = [(2, 3), (3, 4), (6, 5), (10, 3), (10, 5)]   # chip_smoke.py's
SETS = [(3, [(0,), (2, 1), (1, 1, 1), (2, 0, 2), (2, 2), (2, 1)]),
        (3, jw.anisotropic_words((1.0, 2.0, 1.5), 4.0)),
        (2, jw.all_words(2, 3) + [w for w in jw.lyndon_words(2, 4)
                                  if len(w) == 4])]


def _rng(seed):
    return np.random.default_rng(seed)


def _incs(seed, B, M, d):
    return (_rng(seed).normal(size=(B, M, d)) * 0.3).astype(np.float32)


def _closure_state(x, plan):
    """The terminal closure state (B, 1 + W) of the port's scan."""
    return tp._scan_closure(torch.from_numpy(x), plan, False)[1].numpy()


@pytest.mark.parametrize("stride", [None, 1, 3])
@pytest.mark.parametrize("k", range(len(SETS)))
@pytest.mark.parametrize("M", [1, 9])
def test_plain_sweep_matches_the_projected_bwd_scans(k, M, stride):
    d, words = SETS[k]
    x = _incs(k * 10 + M, 3, M, d)
    plan, jplan = tw.make_plan(words, d), jw.make_plan(words, d)
    S_T = _closure_state(x, plan)
    if stride is None:
        g = _rng(k).normal(size=(3, len(words))).astype(np.float32)
        want = jproj.projected_inverse_bwd_scan(
            jnp.asarray(x), jnp.asarray(S_T), jnp.asarray(g), jplan)
    else:
        g = _rng(k).normal(size=(3, -(-M // stride), len(words))).astype(
            np.float32)
        want = jproj.projected_stream_inverse_bwd_scan(
            jnp.asarray(x), jnp.asarray(S_T), jnp.asarray(g), jplan, stride)
    got = ss.sig_sweep_plain(torch.from_numpy(x), plan,
                             torch.from_numpy(S_T[:, 1:]),
                             torch.from_numpy(g), stream=stride is not None,
                             stream_stride=stride or 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GTOL)
    # the wrapper runs the plain version on a CPU tensor
    np.testing.assert_array_equal(ss.sig_sweep(
        torch.from_numpy(x), plan, torch.from_numpy(S_T[:, 1:]),
        torch.from_numpy(g), stream=stride is not None,
        stream_stride=stride or 1).numpy(), got.numpy())


@pytest.mark.parametrize("stride", [None, 1, 2])
@pytest.mark.parametrize("d,N,M", [(2, 4, 11), (3, 3, 6), (4, 2, 1)])
def test_plain_sweep_matches_the_truncated_bwd_scans(d, N, M, stride):
    x = _incs(d + N + M, 2, M, d)
    out = ts.signature_from_increments(torch.from_numpy(x), N,
                                       backend="torch", device="cpu")
    D = out.shape[-1]
    plan = ts.truncation_closure(d, N)
    if stride is None:
        g = _rng(N).normal(size=(2, D)).astype(np.float32)
        want = js.inverse_bwd_scan(jnp.asarray(x), jnp.asarray(out.numpy()),
                                   jnp.asarray(g), N)
    else:
        g = _rng(N).normal(size=(2, -(-M // stride), D)).astype(np.float32)
        want = js.stream_inverse_bwd_scan(
            jnp.asarray(x), jnp.asarray(out.numpy()), jnp.asarray(g), N,
            stride)
    got = ss.sig_sweep_plain(torch.from_numpy(x), plan, out,
                             torch.from_numpy(g), stream=stride is not None,
                             stream_stride=stride or 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GTOL)
    # the port's scan functions are the same sweep
    port = (ts.inverse_bwd_scan(torch.from_numpy(x), out,
                                torch.from_numpy(g), N) if stride is None
            else ts.stream_inverse_bwd_scan(torch.from_numpy(x), out,
                                            torch.from_numpy(g), N, stride))
    np.testing.assert_array_equal(port.numpy(), got.numpy())


@pytest.mark.parametrize("M", [1, 2, 3, 7, 9, 12, 37])
@pytest.mark.parametrize("stride", [1, 2, 3, 5, 10, 40])
def test_kernel_emission_map_is_the_streamed_emission(M, stride):
    """The slot table the kernel reads a step at a time."""
    slots = ss.emit_slot_table(M, stride)
    assert slots.dtype == np.int32 and slots.shape == (M,)
    steps = ts.stream_emit_steps(M, stride)
    assert np.array_equal(np.nonzero(slots >= 0)[0], steps)
    assert np.array_equal(slots[steps], np.arange(len(steps)))
    term = ss.emit_slot_table(M, 0)
    assert np.array_equal(np.nonzero(term >= 0)[0], [M - 1])
    assert term[M - 1] == 0


@pytest.mark.parametrize("d,N", SWEEP)
def test_truncation_closure_is_the_flat_order(d, N):
    plan = ts.truncation_closure(d, N)
    assert plan.closure == tuple(tw.all_words(d, N)) == plan.words
    assert np.array_equal(plan.out_rows, np.arange(1, plan.closure_size + 1))
    t = ss.sweep_tables(plan)
    assert np.array_equal(t.level_off, [0] + list(np.cumsum(
        [d**n for n in range(1, N + 1)])))
    threads, smem, in_smem = ss.sweep_geometry(plan.closure_size, d, N)
    assert in_smem == (4 * (2 * d + 3 * (plan.closure_size + 1))
                       <= ss.SMEM_BUDGET)
    assert threads == min(1024, -(-plan.closure_size // 32) * 32)
    if (d, N) == (10, 5):   # 111,110 rows: the device-memory scratch
        assert not in_smem and smem == 4 * 2 * d


def test_tables_scatter_repeated_words_onto_one_row():
    """A word requested twice gets one closure row; the sweep adds both
    cotangents onto it."""
    d, words = SETS[0]
    plan = tw.make_plan(words, d)
    t = ss.sweep_tables(plan)
    assert np.array_equal(t.out_rows, plan.out_rows)
    assert t.out_rows[1] == t.out_rows[5]
    assert np.array_equal(t.level_off, np.searchsorted(
        plan.lengths, np.arange(plan.depth + 1), side="right"))
    x = torch.from_numpy(_incs(4, 2, 6, d))
    S_T = torch.from_numpy(_closure_state(x.numpy(), plan)[:, 1:])
    g = torch.from_numpy(_rng(4).normal(size=(2, len(words))).astype(
        np.float32))
    split = g.clone()
    split[:, 1] = g[:, 1] + g[:, 5]
    split[:, 5] = 0.0
    torch.testing.assert_close(ss.sig_sweep_plain(x, plan, S_T, g),
                               ss.sig_sweep_plain(x, plan, S_T, split))


def test_the_sweep_of_the_sec8_step_fits_shared_memory():
    words = tw.generated_words([(5 + i,) for i in range(5)]
                               + [w for i in range(5)
                                  for w in ((i, 5 + i), (5 + i, i))], 3)
    plan = tw.make_plan(words, 10)
    assert (len(words), plan.closure_size) == (260, 285)
    assert ss.sweep_geometry(285, 10, 3) == (288, 4 * (20 + 3 * 286), True)


def test_shapes_are_checked_and_other_devices_raise():
    d, words = SETS[0]
    plan = tw.make_plan(words, d)
    x = torch.zeros(2, 4, d)
    S_T = torch.zeros(2, plan.closure_size)
    g = torch.zeros(2, len(words))
    with pytest.raises(ValueError, match="S_T"):
        ss.sig_sweep(x, plan, S_T[:, 1:], g)
    with pytest.raises(ValueError, match="cotangent"):
        ss.sig_sweep(x, plan, S_T, g, stream=True)
    with pytest.raises(ValueError, match="channels"):
        ss.sig_sweep(torch.zeros(2, 4, d + 1), plan, S_T, g)
    with pytest.raises(ValueError):
        ss.sig_sweep(x.to("meta"), plan, S_T.to("meta"), g.to("meta"))
    assert not ss.sig_sweep(torch.zeros(2, 0, d), plan, S_T, g).any()
