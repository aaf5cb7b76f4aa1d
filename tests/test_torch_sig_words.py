"""The port's ``sig_words`` module against the reference word kernel.

On the CPU the wrapper runs its plain version (the padded per-tile
word-table scan); it is held against the JAX Pallas kernel in interpret
mode (non-streamed), the JAX projected stream engine (the reference's
streamed Pallas cell does not run on the installed jax) and the oracles.
The tile tables and the gather index that the CUDA kernel's output goes
through are tested here against the reference's ``tile_idx``/``row_idx``.
Tolerances: rtol 2e-4, atol 2e-5 for fp32; n·2^-8 per full level for
bf16_fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import words as jw
from repro.core.projection import projected_signature_from_increments as jpsi
from repro.kernels import ref as jref
from repro.kernels.sig_words import sig_words as j_sig_words
from repro_torch.core import transforms as tt
from repro_torch.core import words as tw
from repro_torch.core.transforms import sparse_leadlag_generators
from repro_torch.kernels import cost
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sig_words as sw

TOL = dict(rtol=2e-4, atol=2e-5)
ANISO = jw.anisotropic_words((1.0, 2.0, 1.5), 4.0)
SPARSE = [(0,), (3, 2), (1, 1, 1, 1), (2, 0, 3), (3, 3), (3, 2)]


def _incs(seed, B, M, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, M, d)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("max_rows", [8, 32, 512])
def test_plain_matches_pallas_interpret(max_rows):
    x = _incs(max_rows, 3, 9, 3)
    want = np.asarray(j_sig_words(jnp.asarray(x),
                                  jw.make_tiled_plan(ANISO, 3, max_rows),
                                  batch_tile=8, interpret=True))
    got = sw.sig_words(torch.from_numpy(x),
                       tw.make_tiled_plan(ANISO, 3, max_rows))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("max_rows", [2, 8, 64])
def test_plain_matches_oracles_with_repeated_words(max_rows):
    x = _incs(3, 4, 11, 4)
    got = sw.sig_words(torch.from_numpy(x),
                       tw.make_tiled_plan(SPARSE, 4, max_rows))
    want = np.asarray(jref.sig_words_ref(jnp.asarray(x), SPARSE, 4))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        tref.sig_words_ref(torch.from_numpy(x), SPARSE, 4).numpy(), want,
        **TOL)
    np.testing.assert_array_equal(got[:, 1].numpy(), got[:, 5].numpy())


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("max_rows", [4, 256])
def test_plain_stream_matches_jax_stream_engine(stride, max_rows):
    x = _incs(stride, 3, 8, 3)
    want = np.asarray(jpsi(jnp.asarray(x), jw.make_plan(ANISO, 3),
                           stream=True, stream_stride=stride, backend="jax"))
    got = sw.sig_words(torch.from_numpy(x),
                       tw.make_tiled_plan(ANISO, 3, max_rows), stream=True,
                       stream_stride=stride)
    assert got.shape == want.shape == (3, -(-8 // stride), len(ANISO))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("max_rows", [8, 32, 512])
def test_gather_index_matches_reference(max_rows):
    """The flat index the kernel's (T, 1 + W_pad) output is read with is the
    reference's tile_idx/row_idx pair (sig_words.py:192-194)."""
    for d, words in [(3, ANISO), (4, SPARSE), (2, jw.all_words(2, 5))]:
        jt = jw.make_tiled_plan(words, d, max_rows)
        tt = tw.make_tiled_plan(words, d, max_rows)
        tab = sw.tile_tables(tt)
        tile_idx = np.asarray([t for t, _ in jt.gather])
        row_idx = np.asarray([jt.tiles[t].out_rows[k] for t, k in jt.gather])
        np.testing.assert_array_equal(
            tab.gather, tile_idx * (1 + tab.w_pad) + row_idx)
        # read the reference's own closure states back through the index
        blocks = np.random.default_rng(0).normal(
            size=(2, len(jt.tiles), 1 + tab.w_pad))
        np.testing.assert_array_equal(
            blocks.reshape(2, -1)[:, tab.gather],
            blocks[:, tile_idx, row_idx])


def test_tile_tables_pad_and_mask():
    tt = tw.make_tiled_plan(ANISO, 3, 8)
    tab = sw.tile_tables(tt)
    assert tab.n_tiles == len(tt.tiles)
    assert tab.w_pad == max(p.closure_size for p in tt.tiles)
    assert tab.depth == max(p.depth for p in tt.tiles)
    for t, p in enumerate(tt.tiles):
        W = p.closure_size
        np.testing.assert_array_equal(tab.lengths[t, :W], p.lengths)
        assert not tab.lengths[t, W:].any()
        np.testing.assert_array_equal(tab.prefix_idx[t, :p.depth, :W],
                                      p.prefix_idx.T)
        np.testing.assert_array_equal(tab.letters[t, :p.depth, :W],
                                      p.letters.T)
        np.testing.assert_array_equal(tab.inv[t, :p.depth, :W], p.inv.T)
        # steps past a word's length and padding rows never contribute
        j = np.arange(tab.depth)[:, None]
        assert not tab.inv[t][j >= tab.lengths[t][None, :]].any()
        assert (tab.prefix_idx[t] <= W).all()


def test_launch_geometry_limits():
    tab = sw.tile_tables(tw.make_tiled_plan(ANISO, 3, 256))
    threads, smem = sw.launch_geometry(tab, 3)
    assert threads == 32 and threads * sw.ROWS_PER_THREAD >= tab.w_pad
    assert smem == 4 * (1 + tab.w_pad + 3 * tab.depth * tab.w_pad
                        + tab.w_pad + sw.CHUNK * 3)
    deep = sw.tile_tables(tw.make_tiled_plan([(0,) * 17], 1))
    with pytest.raises(ValueError, match="MAX_DEPTH"):
        sw.launch_geometry(deep, 1)
    wide = sw.tile_tables(tw.make_tiled_plan(jw.all_words(4, 6), 4, 10**6))
    with pytest.raises(ValueError, match="max_rows"):
        sw.launch_geometry(wide, 4)
    with pytest.raises(ValueError, match="letters"):
        sw.sig_words(torch.zeros(1, 2, 2), tw.make_tiled_plan(ANISO, 3))


def test_bf16_within_per_level_bound_and_agrees_with_reference():
    d, N = 3, 4
    x = _incs(7, 4, 20, d)
    tx = torch.from_numpy(x)
    tp = tw.make_tiled_plan(jw.all_words(d, N), d, 16)
    ref = sw.sig_words(tx.double(), tp).numpy()
    got = sw.sig_words(tx, tp, precision="bf16_fp32").numpy()
    off = 0
    for n in range(1, N + 1):
        g, r = got[:, off:off + d**n], ref[:, off:off + d**n]
        assert np.linalg.norm(g - r) / np.linalg.norm(r) <= n * 2.0**-8
        off += d**n
    jx = jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    want = np.asarray(jref.sig_words_ref(jx, jw.all_words(d, N), d))
    np.testing.assert_allclose(got, want, **TOL)
    stream = sw.sig_words(tx, tp, stream=True, stream_stride=3,
                          precision="bf16_fp32")
    assert torch.equal(stream, stream.to(torch.bfloat16).float())


def test_float64_runs_in_fp32_and_zero_steps():
    tp = tw.make_tiled_plan(SPARSE, 4, 4)
    x = torch.from_numpy(_incs(3, 2, 5, 4)).double()
    out = sw.sig_words(x, tp)
    assert out.dtype == torch.float64
    assert torch.equal(out, sw.sig_words(x.float(), tp).double())
    assert sw.sig_words(torch.zeros(3, 0, 4), tp).shape == (3, len(SPARSE))
    assert not sw.sig_words(torch.zeros(3, 0, 4), tp).any()
    assert sw.sig_words(torch.zeros(3, 0, 4), tp,
                        stream=True).shape == (3, 0, len(SPARSE))


def test_cuda_cell_backward_raises(monkeypatch):
    """The launch is stubbed with the plain version so the autograd node
    runs on the CPU; its backward must raise, never drop gradients."""
    monkeypatch.setattr(sw, "_launch", lambda incs, tplan, *a:
                        sw.sig_words_plain(incs.detach(), tplan))
    tp = tw.make_tiled_plan(SPARSE, 4)
    x = torch.from_numpy(_incs(0, 2, 4, 4)).requires_grad_()
    out = sw.SigWordsFunction.apply(x, tp, False, 1, "fp32")
    assert out.grad_fn is not None
    with pytest.raises(NotImplementedError, match="inverse backward"):
        out.sum().backward()


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device of another type."""

    @property
    def device(self):
        return torch.device("xpu")


def test_wrapper_rejects_other_devices():
    """A device other than the CPU, CUDA and meta raises; a meta tensor
    runs the operator's Meta implementation: the kernel's output shape,
    nothing launched."""
    tplan = tw.make_tiled_plan(SPARSE, 4)
    with pytest.raises(ValueError, match="cuda, meta or cpu"):
        sw.sig_words(torch.zeros(1, 2, 4).as_subclass(_Elsewhere), tplan)
    before = sw.launches
    out = sw.sig_words(torch.zeros(1, 2, 4, device="meta"), tplan)
    assert out.is_meta and tuple(out.shape) == (1, len(tplan.words))
    assert sw.launches == before


# ---------------------------------------------------------------------------
# the kernel's launch planner: tiles packed into groups that fill the card
# ---------------------------------------------------------------------------

SEC8 = tw.generated_words(sparse_leadlag_generators(5), 4)   # 10 letters


def _table3_words(d, N):
    """W_{<=N-1} ∪ Lyndon_N: the word set of logsignature_projected."""
    return tw.all_words(d, N - 1) + [w for w in tw.lyndon_words(d, N)
                                     if len(w) == N]


def _phase6_sets():
    """chip_smoke.py's four fixed phase-6 word sets and six random ones."""
    rng = np.random.default_rng(6)
    sets = [(3, tw.all_words(3, 4)), (4, SPARSE), (3, ANISO),
            (2, tw.all_words(2, 4)
             + [w for w in tw.lyndon_words(2, 5) if len(w) == 5])]
    for _ in range(6):
        d = int(rng.integers(2, 5))
        n = int(rng.integers(1, 13))
        sets.append((d, [tuple(int(c) for c in rng.integers(
            0, d, rng.integers(1, 5))) for _ in range(n)]))
    return sets


def _planner_sets():
    """(d, TiledPlan) of the served word sets: §8 (the words and their
    closure), the phase-6 sets at max_rows 8, 32 and 256, all_words(6, 5),
    and the Table 3 log-signature sets as ops.projected tiles them."""
    out = [(10, tw.make_tiled_plan(SEC8, 10)),
           (10, tw.make_tiled_plan(tw.prefix_closure(SEC8), 10)),
           (6, tw.make_tiled_plan(tw.all_words(6, 5), 6))]
    for d, words in _phase6_sets():
        out += [(d, tw.make_tiled_plan(words, d, r)) for r in (8, 32, 256)]
    for d, N in [(6, 2), (6, 3), (6, 4), (4, 5), (10, 3)]:
        out.append((d, tw.make_tiled_plan(
            tw.make_plan(_table3_words(d, N), d).closure, d)))
    return out


def _check_words_plan(plan, tt, d, B):
    sizes = sw.tile_sizes(tt)
    assert sorted(t for g in plan.groups for t in g) == list(
        range(tt.n_tiles))                      # every tile exactly once
    loads = [sum(sizes[t] for t in g) for g in plan.groups]
    for g, load in zip(plan.groups, loads):
        assert load <= plan.rows or len(g) == 1  # only a lone wide tile
    assert plan.r_pad == max(loads)
    assert plan.threads % 32 == 0
    assert plan.threads * plan.rows_per_thread >= plan.r_pad
    assert plan.depth_slots == sw.depth_slots(tt.depth) >= tt.depth
    assert plan.block <= sw.max_block(plan.depth_slots,
                                      plan.rows_per_thread)
    assert 1 <= plan.chunk <= sw.CHUNK
    assert plan.chunk * d <= sw.PREFETCH * plan.threads
    assert plan.smem == plan.examples * sw.example_smem(
        plan.r_pad, plan.chunk, tt.depth, d) <= sw.SMEM_BUDGET
    nb, G = -(-B // plan.examples), len(plan.groups)
    assert plan.grid == (max(nb, G), min(nb, G))
    assert plan.grid[1] <= sw.MAX_TILES


@pytest.mark.parametrize("B", [1, 5, 128, 2048])
def test_words_planner_packs_every_tile_once_within_its_limits(B):
    for d, tp in _planner_sets():
        tt = sw.tile_tables(tp)
        plan = sw.plan_words_launch(B, tt, d)
        _check_words_plan(plan, tt, d, B)
        assert plan.rows == sw.GROUP_ROWS
        assert -(-plan.r_pad // plan.rows_per_thread) <= sw.EXAMPLE_THREADS
        # the fewest rows a thread that keep the launch within the warps
        # the card holds, else the most that keep an example in bounds
        fits = [r for r in sw.ROWS
                if -(-plan.r_pad // r) <= sw.EXAMPLE_THREADS] or [4]
        warps = {r: B * len(plan.groups) * -(-(-(-plan.r_pad // r)) // 32)
                 for r in fits}
        assert plan.rows_per_thread in fits
        assert all(warps[r] > sw.RESIDENT_WARPS for r in fits
                   if r < plan.rows_per_thread)
        assert (warps[plan.rows_per_thread] <= sw.RESIDENT_WARPS
                or plan.rows_per_thread == fits[-1])
        if plan.examples > 1:  # shared only while small, and the card full
            assert plan.block <= sw.MIN_BLOCK
            assert plan.grid[0] * plan.grid[1] >= sw.SMS


@pytest.mark.parametrize("rows,examples", [(1, 1), (8, 2), (64, None),
                                           (256, 2), (None, 1), (None, 2)])
def test_words_planner_honours_forced_rows_and_examples(rows, examples):
    for d, tp in _planner_sets()[::3]:
        tt = sw.tile_tables(tp)
        plan = sw.plan_words_launch(5, tt, d, rows=rows, examples=examples)
        assert plan.rows == (sw.GROUP_ROWS if rows is None else rows)
        if examples is not None:
            assert plan.examples == examples
        _check_words_plan(plan, tt, d, 5)
    with pytest.raises(ValueError, match="examples"):
        sw.plan_words_launch(5, tt, d, examples=10**4)
    with pytest.raises(ValueError, match="rows"):
        sw.plan_words_launch(5, tt, d, rows=0)


def test_words_planner_fills_the_card_at_section8():
    tt = sw.tile_tables(tw.make_tiled_plan(SEC8, 10))
    assert tt.n_tiles == 60 and sw.launch_geometry(tt, 10)[0] == 64
    plan = sw.plan_words_launch(128, tt, 10)
    assert len(plan.groups) <= tt.n_tiles // 3      # far fewer blocks
    assert (plan.rows_per_thread, plan.depth_slots, plan.threads,
            plan.examples) == (4, 4, 32, 4)    # a warp an example, 4 a block
    sizes = sw.tile_sizes(tt)
    idle = [plan.threads * plan.rows_per_thread - sum(sizes[t] for t in g)
            for g in plan.groups]
    assert max(idle) < 32                           # within one warp a group
    assert plan.grid[0] * plan.grid[1] >= sw.SMS


def test_pack_tiles_keeps_wide_tiles_alone_and_never_splits():
    sizes = (300, 51, 51, 47, 8, 8, 1, 130, 128)
    groups = sw.pack_tiles(sizes, 128)
    assert (0,) in groups and (7,) in groups
    assert sorted(t for g in groups for t in g) == list(range(len(sizes)))
    assert all(sum(sizes[t] for t in g) <= 128 for g in groups
               if g not in ((0,), (7,)))
    assert sw.pack_tiles((5, 5, 5), 1) == ((0,), (1,), (2,))
    assert sw.pack_tiles((1, 1, 1), 1) == ((0,), (1,), (2,))


@pytest.mark.parametrize("B,d", [(5, 3), (1, 10), (128, 10)])
def test_words_partition_variants_cover_one_tile_a_block_and_sharing(B, d):
    words = SEC8 if d == 10 else ANISO
    tt = sw.tile_tables(tw.make_tiled_plan(words, d, 8))
    plans = sw.partition_variants(B, tt, d)
    assert plans[0] == sw.plan_words_launch(B, tt, d)
    assert any(len(p.groups) == tt.n_tiles and p.examples == 1
               for p in plans)                   # one tile, one example
    assert any(p.examples == sw.example_cap(p) > 1 for p in plans)
    assert {p.rows_per_thread for p in plans} == set(sw.ROWS)
    for p in plans:
        _check_words_plan(p, tt, d, B)
    forced = sw.plan_words_launch(B, tt, d, rows_per_thread=2)
    assert forced.rows_per_thread == 2
    with pytest.raises(ValueError, match="rows_per_thread"):
        sw.plan_words_launch(B, tt, d, rows_per_thread=3)


def test_a_group_wider_than_the_registers_hold_raises_naming_max_rows():
    """The old kernel took a tile of up to 4,096 rows while its tables
    fitted shared memory; the links of a group now live in registers, so
    a group passes the instance's rows (2,048 at depth <= 8, 1,024 deeper)
    only with a ValueError that names max_rows."""
    wide = sw.tile_tables(tw.make_tiled_plan(tw.all_words(7, 4), 7, 4096))
    assert wide.w_pad == 2800 and sw.launch_geometry(wide, 7)
    with pytest.raises(ValueError, match="max_rows"):
        sw.plan_words_launch(1, wide, 7)
    for words, d, depth in [(tw.all_words(7, 4), 7, 4),
                            (tw.all_words(2, 10), 2, 10)]:
        cap = sw.max_block(sw.depth_slots(depth), 4) * 4
        tp = tw.make_tiled_plan(words, d, cap)
        tt = sw.tile_tables(tp)
        assert tt.w_pad <= cap and tt.depth == depth
        _check_words_plan(sw.plan_words_launch(3, tt, d), tt, d, 3)


# ---------------------------------------------------------------------------
# the kernel's step schedule, emulated in numpy float32
# ---------------------------------------------------------------------------

def _emulate_words_kernel(x, tplan, plan, stream=False, stride=1):
    """The CUDA kernel's schedule for every (example, group) of ``plan``:
    packed tables (tiles behind one shared eps row), each row's links
    unpacked from its 32-bit words as a thread holds them in registers
    (left-padded to the instance's slots with links to the zero row),
    a chunk staged as dx_i/k, two state buffers (step m reads buffer m % 2
    and writes the other, its own rows carried in registers), and the
    requested words written through the group's emission list."""
    B, M, d = x.shape
    tt = sw.tile_tables(tplan)
    pk = sw.packed_tables(tt, plan.groups, d)
    depth, R1, G = tt.depth, 1 + plan.r_pad, len(plan.groups)
    assert pk.links.shape == (G, plan.depth_slots, plan.r_pad)
    k = np.arange(1, depth + 1, dtype=np.float32)[None, :, None]
    steps = [(x[:, m, None, :] / k).astype(np.float32).reshape(B, -1)
             for m in range(M)]
    emit = set(range(stride - 1, M, stride)) | {M - 1} if stream else ()
    n = len(tplan.words)
    out = np.full((B, len(emit), n) if stream else (B, n), np.nan,
                  np.float32)
    for g in range(G):
        links = pk.links[g].astype(np.int64)
        pref, off = links >> 16, links & 0xFFFF
        assert set(pref[0]) <= {0, 1}               # slot 0: a flag
        for s in range(1, plan.depth_slots):        # k = slots - s
            k = np.minimum(plan.depth_slots - s, depth)
            assert ((off[s] // d) == k - 1).all()
        # the first link that is not padding reads eps
        later = pref[1:] != R1
        first = 1 + np.argmax(later, axis=0)
        inner = later.any(0) & (pref[0] == 0)
        assert (pref[first, np.arange(plan.r_pad)][inner] == 0).all()
        buf = np.zeros((2, B, R1 + 1), np.float32)   # row R1 stays 0
        buf[:, :, 0] = 1.0
        own = np.zeros((B, R1 - 1), np.float32)
        e = slice(pk.emit_off[g], pk.emit_off[g + 1])
        rows, cols = pk.emit_rows[e], pk.emit_cols[e]
        q = 0
        for m in range(M):
            cur, nxt = buf[m % 2], buf[1 - m % 2]
            dx = steps[m]
            acc = np.where(pref[0] == 1, dx[:, off[0]], 0).astype(
                np.float32)
            for j in range(1, plan.depth_slots):
                acc = ((cur[:, pref[j]] + acc) * dx[:, off[j]]).astype(
                    np.float32)
            own = own + acc
            nxt[:, 1:R1] = own
            if m in emit:
                out[:, q, cols] = nxt[:, rows]
                q += 1
        assert not buf[:, :, R1].any()
        if not stream:
            out[:, cols] = buf[M % 2][:, rows]
    assert not np.isnan(out).any()               # every column written
    return out


@pytest.mark.parametrize("max_rows", [2, 8, 64])
def test_emulated_words_schedule_matches_pallas_interpret(max_rows):
    x = _incs(max_rows + 1, 3, 9, 3)
    want = np.asarray(j_sig_words(jnp.asarray(x),
                                  jw.make_tiled_plan(ANISO, 3, max_rows),
                                  batch_tile=8, interpret=True))
    tp = tw.make_tiled_plan(ANISO, 3, max_rows)
    for plan in sw.partition_variants(3, sw.tile_tables(tp), 3):
        got = _emulate_words_kernel(x, tp, plan)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(
            got, sw.sig_words_plain(torch.from_numpy(x), tp).numpy(), **TOL)


@pytest.mark.parametrize("stride", [1, 3, 8])
def test_emulated_words_stream_matches_jax_stream_engine(stride):
    x = _incs(stride + 20, 2, 8, 4)
    want = np.asarray(jpsi(jnp.asarray(x), jw.make_plan(SPARSE, 4),
                           stream=True, stream_stride=stride, backend="jax"))
    tp = tw.make_tiled_plan(SPARSE, 4, 4)
    for plan in sw.partition_variants(2, sw.tile_tables(tp), 4):
        got = _emulate_words_kernel(x, tp, plan, stream=True, stride=stride)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("d,words,max_rows", [
    (2, tw.all_words(2, 5), 8), (4, SPARSE, 2), (2, [(0,) * 9, (1,)], 4),
    (3, ANISO, 256)])
def test_emulated_words_schedule_matches_plain_at_odd_packings(d, words,
                                                               max_rows):
    """Forced caps that pack several tiles a group, or one tile a group,
    and the planner's own, at a depth of 9 (16 link slots)."""
    x = _incs(d + max_rows, 2, 6, d)
    tp = tw.make_tiled_plan(words, d, max_rows)
    tt = sw.tile_tables(tp)
    want = sw.sig_words_plain(torch.from_numpy(x), tp).numpy()
    for rows in (1, 3, 16, None):
        plan = sw.plan_words_launch(2, tt, d, rows=rows)
        np.testing.assert_allclose(_emulate_words_kernel(x, tp, plan), want,
                                   **TOL)


def test_emission_list_writes_every_column_once_repeats_included():
    tp = tw.make_tiled_plan(SPARSE, 4, 2)        # (3, 2) is asked twice
    tt = sw.tile_tables(tp)
    for plan in sw.partition_variants(4, tt, 4):
        pk = sw.packed_tables(tt, plan.groups, 4)
        assert sorted(pk.emit_cols) == list(range(len(SPARSE)))
        assert pk.emit_off[0] == 0 and pk.emit_off[-1] == len(SPARSE)
        for g in range(len(plan.groups)):
            cols = pk.emit_cols[pk.emit_off[g]:pk.emit_off[g + 1]]
            assert (np.diff(cols) > 0).all()     # column order
        rows = dict(zip(pk.emit_cols, pk.emit_rows))
        assert rows[1] == rows[5]                 # one source row
        assert (pk.emit_rows >= 1).all()         # never the eps row


# ---------------------------------------------------------------------------
# the bounds' prefix-shared operation count (kernels/cost.py, which
# chip_smoke.py imports)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,N", [(1, 4), (2, 3), (3, 4), (6, 5), (10, 3),
                                 (2, 8)])
def test_words_flops_is_the_horner_count_on_the_full_truncation(d, N):
    assert cost.words_flops(tw.make_plan(tw.all_words(d, N), d)) \
        == cost.horner_flops(d, N)


def _brute_force_flops(closure, moving=None):
    """Each chain value computed once: acc_1 = dx/n per (first letter,
    target n), then per link an add per (prefix, n) and a product per
    (longer prefix, n), then an add into each state row.  With ``moving``
    only the values whose prefix ends in a moving letter change."""
    seen, ops = set(), 0
    for w in closure:
        n = len(w)
        for key in [("first", w[:1], n)] + [
                op for j in range(2, n + 1)
                for op in (("add", w[:j - 1], n), ("mul", w[:j], n))]:
            if key not in seen and (moving is None or key[1][-1] in moving):
                seen.add(key)
                ops += 1
        ops += moving is None or w[-1] in moving
    return ops


def test_words_flops_matches_a_brute_force_count():
    rng = np.random.default_rng(11)
    sets = [SEC8, ANISO, SPARSE] + [
        [tuple(int(c) for c in rng.integers(0, 4, rng.integers(1, 7)))
         for _ in range(int(rng.integers(1, 40)))] for _ in range(12)]
    for words in sets:
        d = 10 if words is SEC8 else 4
        plan = tw.make_plan(words, d)
        assert cost.words_flops(plan) == _brute_force_flops(plan.closure)
    assert cost.words_flops(tw.make_plan(SEC8, 10)) == 4740


@pytest.mark.parametrize("d,N", [(2, 3), (3, 4), (7, 3), (13, 2)])
def test_horner_flops_count_only_the_moving_letters(d, N):
    """A step whose dx is zero outside ``moving`` letters changes only the
    words ending in one: the full truncation's count, restricted."""
    plan = tw.make_plan(tw.all_words(d, N), d)
    assert cost.horner_flops(d, N, d) == cost.horner_flops(d, N)
    for m in range(1, d + 1):
        moving = set(range(d - m, d))
        assert cost.words_flops(plan, moving) == cost.horner_flops(d, N, m)
        assert cost.words_flops(plan, moving) == _brute_force_flops(
            plan.closure, moving)


def test_words_flops_of_moving_letters_match_a_brute_force_count():
    rng = np.random.default_rng(12)
    for words in [SEC8, ANISO, SPARSE]:
        d = 10 if words is SEC8 else 4
        plan = tw.make_plan(words, d)
        for _ in range(4):
            moving = {int(c) for c in rng.choice(d, rng.integers(1, d + 1),
                                                 replace=False)}
            assert cost.words_flops(plan, moving) == _brute_force_flops(
                plan.closure, moving)
    # §8's lead-lag word set: the lead and lag halves move in turn
    ll = cost.moving_letters(tt.as_transform("lead_lag"), 5)
    assert cost.fused_step_flops(
        tt.as_transform("lead_lag"), 5,
        lambda m: cost.words_flops(tw.make_plan(SEC8, 10), m)) == 2370
    assert ll == [set(range(5, 10)), set(range(5))]


@pytest.mark.parametrize("tname", ["lead_lag", "time_augment",
                                   "time_augment+lead_lag"])
@pytest.mark.parametrize("d_raw", [1, 3])
def test_moving_letters_are_the_channels_fused_augment_moves(tname, d_raw):
    """The bounds count, in each sub-step, the augmented channels that
    fused_augment can make nonzero, and no others."""
    spec = tt.as_transform(tname)
    B, M = 3, 6
    x = torch.tensor(np.random.default_rng(13).normal(size=(B, M, d_raw)))
    taux = tt.transform_time_aux(spec, B, M, dtype=torch.float64)
    e = tt.fused_augment(x, taux, spec)
    moving = cost.moving_letters(spec, d_raw)
    assert len(moving) == spec.sub_steps
    for p, m in enumerate(moving):
        nonzero = (e[:, p::spec.sub_steps] != 0).any(dim=(0, 1))
        assert set(torch.nonzero(nonzero).flatten().tolist()) == m
