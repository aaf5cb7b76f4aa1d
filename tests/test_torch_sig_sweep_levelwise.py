"""The levelwise form of the §4.2 reverse sweep that the ``sig_sweep``
kernel runs, on its host tables (``repro_torch.kernels.sig_sweep``):
``level_tables`` and the planner ``plan_sweep_launch``, held on
truncation closures and ragged word sets; and a numpy walk of the kernel's
phases over those tables, held in float64 against ``sig_sweep_plain`` and
the reference's four ``*_bwd_scan``s (atol 1e-12 on sums of terms of
order 1: only the order of the sums differs).

The kernel itself runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it against the plain sweep).
"""
import dataclasses
import importlib

import jax
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

TOL64 = dict(rtol=0, atol=1e-12)
TRUNC = [(1, 4), (2, 3), (3, 4), (4, 2), (2, 1)]
# ragged sets: rows with no children below the top level, mixed depths and
# a repeated word (2, 1)
SETS = [(3, [(0,), (2, 1), (1, 1, 1), (2, 0, 2), (2, 2), (2, 1)]),
        (3, jw.anisotropic_words((1.0, 2.0, 1.5), 4.0)),
        (4, [(3,), (0, 1, 2, 3), (1,), (1, 0), (0, 1, 2, 3), (2, 2, 2)]),
        (2, jw.all_words(2, 3) + [w for w in jw.lyndon_words(2, 4)
                                  if len(w) == 4])]


def sec8_words():
    """The paper's §8 sparse set: 260 words, a 285-row closure."""
    return tw.generated_words([(5 + i,) for i in range(5)]
                              + [w for i in range(5)
                                 for w in ((i, 5 + i), (5 + i, i))], 3)


def _plans():
    out = [(f"trunc{d},{N}", ts.truncation_closure(d, N)) for d, N in TRUNC]
    out += [(f"set{k}", tw.make_plan(w, d)) for k, (d, w) in enumerate(SETS)]
    return out + [("sec8", tw.make_plan(sec8_words(), 10))]


PLANS = _plans()


def _rng(seed):
    return np.random.default_rng(seed)


def levelwise_sweep(x, lt, S_T, g, slots):
    """A numpy walk of the kernel's reverse sweep over ``lt``
    (:func:`ss.level_tables`), one example at a time, phase by phase:
    x (B, M, d), S_T (B, W), g (B, n_emit, n_out), slots (M,) from
    :func:`ss.emit_slot_table`.  Returns g_dx (B, M, d)."""
    B, M, d = x.shape
    N, lo, W = lt.depth, lt.lo, lt.W
    inv = np.array([0.0] + [1.0 / m for m in range(1, N + 1)])
    gx = np.zeros((B, M, d))

    def at(k, w, n):    # row w (level k)'s chain value for target n > k
        return lt.chain_off[k] + (n - k - 1) * lt.rows(k) + w - lo[k]

    for b in range(B):
        S = np.concatenate([[1.0], S_T[b, :lo[N] - 1]])  # below the top
        G = np.zeros(W + 1)
        gv = np.zeros(W)
        R = np.zeros(lt.chain_size)
        Q = np.zeros(lt.chain_size)
        C = np.zeros(lt.chain_size)
        for j in range(M - 1, -1, -1):
            dx = x[b, j]
            if slots[j] >= 0:      # the step's cotangent, by row
                for r in range(1, W + 1):
                    for m in range(lt.col_off[r], lt.col_off[r + 1]):
                        G[r] += g[b, slots[j], lt.cols[m]]
            # ascending: S_{j-1} in place, with R of the inverse step and
            # Q of the forward chain at (S_{j-1}, dx)
            for k in range(1, N):
                for w in range(lo[k], lo[k + 1]):
                    u, xi = lt.parent[w], dx[lt.letter[w]]

                    def rq(buf, n):
                        return 1.0 if k == 1 else buf[at(k - 1, u, n)]
                    s_old = S[w]
                    S[w] = s_old - rq(R, k) * xi
                    for n in range(k + 1, N + 1):
                        R[at(k, w, n)] = s_old - rq(R, n) * xi * inv[n - k + 1]
                        Q[at(k, w, n)] = S[w] + rq(Q, n) * xi * inv[n - k + 1]
            # descending: each parent pulls its children's cotangents
            for k in range(N - 1, 0, -1):
                for w in range(lo[k], lo[k + 1]):
                    acc = np.zeros(N - k)
                    qs = np.array([Q[at(k, w, n)] * inv[n - k]
                                   for n in range(k + 1, N + 1)])
                    for c in range(lt.child[w], lt.child[w + 1]):
                        xl = dx[lt.letter[c]]
                        t = np.array([G[c]] + [C[at(k + 1, c, n)]
                                               for n in range(k + 2, N + 1)])
                        G[c] += t[1:].sum()
                        gv[lt.gv_pos[c]] = t @ qs
                        acc += t * xl
                    acc *= inv[1:N - k + 1]
                    if k > 1:
                        for n in range(k + 1, N + 1):
                            C[at(k, w, n)] = acc[n - k - 1]
                    else:   # level 1: its parent is eps, Q = 1
                        gv[lt.gv_pos[w]] = G[w] + acc @ inv[2:N + 1]
                        G[w] += acc.sum()
            if N == 1:
                gv[lt.gv_pos[1:]] = G[1:]
            for i in range(d):
                gx[b, j, i] = gv[lt.letter_off[i]:lt.letter_off[i + 1]].sum()
    return gx


def _inputs(plan, seed, B, M, stride):
    d = plan.d
    x = _rng(seed).normal(size=(B, M, d)) * 0.3
    S_T = tp._scan_closure(torch.from_numpy(x), plan, False)[1][:, 1:]
    n_emit = -(-M // stride) if stride else 1
    g = _rng(seed + 1).normal(size=(B, n_emit, len(plan.words)))
    return x, S_T.numpy(), g


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,plan", PLANS, ids=[n for n, _ in PLANS])
def test_level_tables(name, plan):
    lt = ss.level_tables(plan)
    W, N, d = plan.closure_size, plan.depth, plan.d
    closure = [()] + list(plan.closure)
    row = {w: r for r, w in enumerate(closure)}
    assert lt.W == W and lt.depth == N and lt.lo[0] == 0 and lt.lo[1] == 1
    for k in range(1, N + 1):
        assert {len(closure[r]) for r in range(lt.lo[k], lt.lo[k + 1])} \
            == {k}
    for r in range(1, W + 1):
        assert lt.parent[r] == row[closure[r][:-1]]
        assert lt.letter[r] == closure[r][-1]
    for w in range(lt.lo[N]):   # children: one contiguous range each
        kids = [r for r in range(1, W + 1) if lt.parent[r] == w]
        assert list(range(lt.child[w], lt.child[w + 1])) == kids
    assert lt.child[lt.lo[N]] == W + 1
    # the chain buffers: rows_k·(depth - k) values at level k
    assert list(np.diff(lt.chain_off[1:])) == [
        lt.rows(k) * (N - k) for k in range(1, N)]
    # rows grouped by letter, each group ascending
    assert sorted(lt.gv_pos[1:]) == list(range(W))
    for i in range(d):
        slots = range(lt.letter_off[i], lt.letter_off[i + 1])
        rows = sorted((p, r) for r, p in enumerate(lt.gv_pos) if r and
                      p in slots)
        assert [r for _, r in rows] == [r for r in range(1, W + 1)
                                        if lt.letter[r] == i]
    assert lt.letter_off[d] == W
    # each row's cotangent columns, ascending
    for r in range(W + 1):
        cols = list(lt.cols[lt.col_off[r]:lt.col_off[r + 1]])
        assert cols == [c for c, o in enumerate(plan.out_rows) if o == r]
    # the kernel's 8-byte loads: the parent's index within its level, the
    # gv slot, each beside the letter
    up, down = ss.row_pairs(lt)
    assert up.shape == down.shape == (W + 1, 2)
    for r in range(1, W + 1):
        k = len(closure[r])
        assert up[r, 0] == lt.parent[r] - lt.lo[k - 1]
        assert 0 <= up[r, 0] < lt.rows(k - 1) if k > 1 else up[r, 0] == 0
        assert tuple(down[r]) == (lt.gv_pos[r], lt.letter[r])
        assert up[r, 1] == lt.letter[r]


def test_tables_of_rows_without_children_and_a_repeated_word():
    d, words = SETS[0]
    plan = tw.make_plan(words, d)
    lt = ss.level_tables(plan)
    rep = plan.out_rows[1]
    assert list(lt.cols[lt.col_off[rep]:lt.col_off[rep + 1]]) == [1, 5]
    # (0,) and (2, 2) sit below the top level and have no children
    for w in [(0,), (2, 2)]:
        r = plan.closure.index(w) + 1
        assert r < lt.lo[plan.depth] and lt.child[r] == lt.child[r + 1]


def test_sec8_closure_levels():
    plan = tw.make_plan(sec8_words(), 10)
    lt = ss.level_tables(plan)
    assert [lt.rows(k) for k in (1, 2, 3)] == [10, 55, 220]
    assert ss.most_children(lt) == [10, 10, 6]
    assert ss.pull_threads(lt) == 55 * 8
    assert ss.parent_lanes(lt, 448) == (16, 8)   # 10 and 55 parents
    assert ss.parent_lanes(lt, 64) == (4, 1)
    assert lt.chain_size == 10 * 2 + 55
    assert ss.widest_level(lt) == 55
    assert ss.example_floats(lt) == 66 + 286 + 285 + 3 * 75


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,plan", PLANS, ids=[n for n, _ in PLANS])
@pytest.mark.parametrize("threads", [None, 32, 96, 1024])
def test_planner_limits(name, plan, threads):
    """The planner's own partition (``threads`` None) and forced ones, and
    every variant it may choose."""
    lt = ss.level_tables(plan)
    own = ss.plan_sweep_launch(plan, threads=threads)
    variants = ss.partition_variants(plan)
    assert len(set(variants)) == len(variants)
    most = ss.most_children(lt)
    for p in [own] + variants:
        assert p.threads % 32 == 0 and p.threads <= ss.MAX_BLOCK[p.slots]
        assert p.slots == ss.depth_slots(plan.depth) >= plan.depth
        state = ss.example_floats(lt) if p.in_smem else 0
        assert p.smem == 4 * (2 * ss.CHUNK + state + 2 * ss.CHUNK * plan.d)
        assert p.smem == ss.block_smem(lt, p.in_smem)
        assert p.smem <= ss.SMEM_BUDGET
        # a parent's lanes: a power of two within a warp
        assert p.lanes == ss.parent_lanes(lt, p.threads)
        assert len(p.lanes) == plan.depth - 1
        for k, lanes in enumerate(p.lanes, start=1):
            assert lanes in (1, 2, 4, 8, 16, 32)
            assert lanes == 1 or lanes < 2 * max(most[k], 1)
            assert lanes * lt.rows(k) <= max(p.threads, lt.rows(k))
    assert own.in_smem
    if threads is None:
        assert variants[0] == own
        assert own.threads == min(ss.MAX_BLOCK[own.slots], max(
            -(-ss.widest_level(lt) // 32) * 32,
            -(-min(ss.pull_threads(lt), ss.PULL_THREADS) // 32) * 32,
            32 * min(plan.d, ss.REDUCE_WARPS)))
    else:
        assert own.threads == threads
    assert {p.in_smem for p in variants} == {True, False}
    assert 32 in {p.threads for p in variants}


@pytest.mark.parametrize("d,N", [(6, 5), (10, 5), (40, 3), (10, 3), (4, 5)])
def test_planner_at_the_sweep_shapes(d, N):
    """A closure wider than shared memory runs from the scratch; the
    planner never forces it into shared memory."""
    plan = ts.truncation_closure(d, N)
    p = ss.plan_sweep_launch(plan)
    fits = 4 * (ss.example_floats(ss.level_tables(plan)) + 2 * ss.CHUNK
                * (d + 1)) <= ss.SMEM_BUDGET
    assert p.in_smem == fits == ((d, N) not in [(10, 5), (40, 3)])
    if not fits:
        with pytest.raises(ValueError, match="state needs"):
            ss.plan_sweep_launch(plan, in_smem=True)
    with pytest.raises(ValueError, match="threads"):
        ss.plan_sweep_launch(plan, threads=48)
    with pytest.raises(ValueError, match="threads"):
        ss.plan_sweep_launch(plan, threads=2048)


@pytest.mark.parametrize("d,N,threads", [(10, 3, 384), (4, 5, 384),
                                         (6, 5, 1024), (2, 3, 64)])
def test_planner_threads_at_the_sweep_shapes(d, N, threads):
    """Lanes for the pull-back up to PULL_THREADS, but never fewer threads
    than the widest level's rows (1,296 at (6, 5))."""
    assert ss.plan_sweep_launch(ts.truncation_closure(d, N)).threads \
        == threads
    assert ss.plan_sweep_launch(tw.make_plan(sec8_words(), 10)) \
        .threads == 384


def test_parent_lanes_of_full_truncations():
    """A parent of W_{<=N} has d children: its lanes are the power of two
    at least d while the level's parents leave room, else fewer."""
    lt = ss.level_tables(ts.truncation_closure(4, 5))
    assert ss.most_children(lt) == [4] * 5
    assert ss.parent_lanes(lt, 1024) == (4, 4, 4, 4)
    assert ss.parent_lanes(lt, 256) == (4, 4, 4, 1)
    lt = ss.level_tables(ts.truncation_closure(40, 3))
    assert ss.parent_lanes(lt, 1024) == (16, 1)   # 40 children, 16 lanes


def test_planner_refuses_deeper_words_than_the_kernel_takes():
    with pytest.raises(ValueError, match="MAX_DEPTH"):
        ss.plan_sweep_launch(ts.truncation_closure(1, ss.MAX_DEPTH + 1))


@pytest.mark.parametrize("depth,slots", [(1, 4), (3, 4), (4, 4), (5, 5),
                                         (8, 8), (9, 16), (16, 16)])
def test_depth_slots_pick_the_kernel_instance(depth, slots):
    """Four instances, for words of up to 4, 5, 8 and 16 letters; 1,024
    threads a block up to 8, 512 past."""
    assert ss.depth_slots(depth) == slots
    assert ss.plan_sweep_launch(ts.truncation_closure(1, depth)).slots \
        == slots
    assert ss.MAX_BLOCK[slots] == (1024 if depth <= 8 else 512)


def test_step_phases_follow_the_kernel_layout():
    """The phases a step as the kernel is written, from depth 3 its
    2·depth - 3 barriers and the g_dx reduction (which runs into the next
    step's first phase with no barrier between)."""
    assert [ss.step_phases(n) for n in range(1, 7)] == [2, 3, 4, 6, 8, 10]


# ---------------------------------------------------------------------------
# the numpy walk against the plain sweep and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride", [0, 1, 3])
@pytest.mark.parametrize("name,plan", PLANS, ids=[n for n, _ in PLANS])
def test_levelwise_walk_matches_the_plain_sweep(name, plan, stride):
    M = 7
    x, S_T, g = _inputs(plan, len(name) + stride, 2, M, stride)
    got = levelwise_sweep(x, ss.level_tables(plan), S_T, g,
                          ss.emit_slot_table(M, stride))
    want = ss.sig_sweep_plain(torch.from_numpy(x), plan,
                              torch.from_numpy(S_T),
                              torch.from_numpy(g if stride else g[:, 0]),
                              stream=bool(stride),
                              stream_stride=stride or 1)
    np.testing.assert_allclose(got, want.numpy(), **TOL64)


@pytest.mark.parametrize("stride", [0, 1, 3])
@pytest.mark.parametrize("k", range(len(SETS)))
def test_levelwise_walk_matches_the_projected_bwd_scans(k, stride):
    d, words = SETS[k]
    plan, jplan = tw.make_plan(words, d), jw.make_plan(words, d)
    # the reference's divisors 1/(n - j) in float64, as the walk's
    n = jplan.lengths[:, None].astype(np.float64)
    j = np.arange(jplan.depth)[None, :]
    jplan = dataclasses.replace(
        jplan, inv=np.where(j < n, 1.0 / np.maximum(n - j, 1), 0.0),
        emit=jplan.emit.astype(np.float64))
    M = 6
    x, S_T, g = _inputs(plan, 40 + k, 2, M, stride)
    got = levelwise_sweep(x, ss.level_tables(plan), S_T, g,
                          ss.emit_slot_table(M, stride))
    with jax.enable_x64(True):
        S1 = jnp.asarray(np.concatenate([np.ones((2, 1)), S_T], 1))
        if stride:
            want = jproj.projected_stream_inverse_bwd_scan(
                jnp.asarray(x), S1, jnp.asarray(g), jplan, stride)
        else:
            want = jproj.projected_inverse_bwd_scan(
                jnp.asarray(x), S1, jnp.asarray(g[:, 0]), jplan)
        np.testing.assert_allclose(got, np.asarray(want), **TOL64)


@pytest.mark.parametrize("stride", [0, 1, 3])
@pytest.mark.parametrize("d,N", [(2, 3), (3, 2), (1, 4)])
def test_levelwise_walk_matches_the_truncated_bwd_scans(d, N, stride):
    plan = ts.truncation_closure(d, N)
    M = 7
    x, S_T, g = _inputs(plan, d * N + stride, 2, M, stride)
    got = levelwise_sweep(x, ss.level_tables(plan), S_T, g,
                          ss.emit_slot_table(M, stride))
    with jax.enable_x64(True):
        if stride:
            want = js.stream_inverse_bwd_scan(
                jnp.asarray(x), jnp.asarray(S_T), jnp.asarray(g), N, stride)
        else:
            want = js.inverse_bwd_scan(jnp.asarray(x), jnp.asarray(S_T),
                                       jnp.asarray(g[:, 0]), N)
        np.testing.assert_allclose(got, np.asarray(want), **TOL64)
