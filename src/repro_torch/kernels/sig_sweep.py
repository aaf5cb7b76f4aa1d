"""The §4.2 reverse sweep over a prefix-closed word table: the backward of
both signature kernels.

The reference's backwards are ``lax.scan`` loops, not Pallas kernels:
``repro.core.signature.inverse_bwd_scan`` / ``stream_inverse_bwd_scan``
and ``repro.core.projection.projected_inverse_bwd_scan`` /
``projected_stream_inverse_bwd_scan``.  All four are one sweep over the
prefix closure of a word set (for the truncated signature, the closure
of W_{<=N}, whose level-major order is the flat signature order): from
the terminal closure state S_T and the cotangents, step j = M..1
reconstructs S_{j-1} = S_j ⊗ exp(-ΔX_j) (paper Prop. 4.6) and pulls the
cotangent back through the Horner step at (S_{j-1}, ΔX_j), keeping only
O(B·W) live state.  Streamed cotangents enter at their emitted steps
(:func:`repro_torch.core.signature.stream_emit_steps`), added onto their
rows just before that step's pull-back; the terminal cell is the stream
with only the last step emitted.

:func:`sig_sweep_plain` is the sweep as a Python loop in PyTorch, with
the Horner step's VJP written out per closure row; the ``torch`` engine's
inverse backwards call it.  :func:`sig_sweep` is the wrapper of the
hand-written CUDA kernel (``csrc/sig_sweep.cu``), one launch a backward
call, which ``SigTruncFunction`` and ``SigWordsFunction`` call: on a CPU
tensor it runs the plain version, on a CUDA tensor it launches the kernel,
the registered operator ``pathsig::sig_sweep``
(:mod:`repro_torch.kernels.library`), or raises, and on a meta tensor the
operator's Meta implementation runs.  The kernel runs the sweep levelwise
over the tables of :func:`level_tables` (each row's parent, last letter
and children, its chain values by target length, rows grouped by letter,
each row's cotangent columns), partitioned by :func:`plan_sweep_launch`.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..core.signature import stream_emit_steps
from ..core.words import WordPlan
from ..obs.compile import count_new_shape
from . import _build
from .cache import plan_cache
from .library import plan_key

# per-block dynamic shared memory the kernel may take on an H100 (the
# opt-in maximum, 232,448 bytes, less a margin)
SMEM_BUDGET = 232_448 - 1024
MAX_DEPTH = 16        # SS_MAX_DEPTH
# deepest word of each kernel instance: a depth runs in the smallest that
# holds it, since a larger one issues its unused chain slots (5-23% slower
# at depths 3 and 5 on an H100)
DEPTH_SLOTS = (4, 5, 8, 16)
MAX_BLOCK = {4: 1024, 5: 1024, 8: 1024, 16: 512}   # most threads a block
REDUCE_WARPS = 8      # the planner's warps for the g_dx reduction
PULL_THREADS = 384    # the planner's most threads for the pull-back's lanes
CHUNK = 32            # SS_CHUNK: steps of increments staged at once

# launch counter, bumped where the kernel is launched
launches = 0
# every launch shape met so far (the wrapper's counterpart of a jit cache)
launch_shapes: set = set()


@dataclasses.dataclass(frozen=True, eq=False)
class SweepTables:
    """Per-row link tables of a prefix-closed plan, rows level-major (the
    plain step's layout: each row's whole chain of prefixes)."""
    prefix: np.ndarray     # (W, depth) int32 state rows of the links, 0 = eps
    letters: np.ndarray    # (W, depth) int32
    inv: np.ndarray        # (W, depth) float32, 1/(len - k); 0 past len
    lengths: np.ndarray    # (W,) int32
    level_off: np.ndarray  # (depth + 1,) int32: first row of each length
    out_rows: np.ndarray   # (n_out,) int32 state rows of the plan's words


@plan_cache
def sweep_tables(plan: WordPlan) -> SweepTables:
    """The tables of ``plan``'s closure; raises unless its rows are
    level-major (as :func:`repro_torch.core.words.make_plan` lays them)."""
    lengths = np.asarray(plan.lengths, np.int32)
    if np.any(np.diff(lengths) < 0):
        raise ValueError("the sweep needs a level-major closure")
    level_off = np.searchsorted(lengths, np.arange(plan.depth + 1),
                                side="right").astype(np.int32)
    return SweepTables(
        prefix=np.ascontiguousarray(plan.prefix_idx, np.int32),
        letters=np.ascontiguousarray(plan.letters, np.int32),
        inv=np.ascontiguousarray(plan.inv, np.float32), lengths=lengths,
        level_off=level_off,
        out_rows=np.ascontiguousarray(plan.out_rows, np.int32))


def sweep_geometry(W: int, d: int, depth: int) -> tuple[int, int, bool]:
    """(threads, shared-memory bytes, state in shared memory) of the
    one-thread-a-row form of the sweep over a closure of W rows, which the
    kernel no longer runs (:func:`plan_sweep_launch` plans its launch): a
    thread a row up to 1,024 threads to depth 8, 512 deeper, and the state
    and two cotangent buffers, 3 (W + 1) floats, in shared memory while
    they fit ``SMEM_BUDGET``, else in device memory.  Nothing in the
    port calls it; its tests hold its contract."""
    if depth > MAX_DEPTH:
        raise ValueError(f"words of length {depth} exceed the kernel's "
                         f"MAX_DEPTH {MAX_DEPTH}")
    cap = 1024 if depth <= 8 else 512
    threads = min(cap, max(32, -(-W // 32) * 32))
    smem = 4 * (2 * d + 3 * (W + 1))
    if smem <= SMEM_BUDGET:
        return threads, smem, True
    return threads, 4 * 2 * d, False


@dataclasses.dataclass(frozen=True, eq=False)
class LevelTables:
    """The levelwise tables of a prefix-closed plan over its state rows
    0..W (row 0 = eps), level-major as the closure is.  Level k holds rows
    lo[k]..lo[k+1]-1.  A row w below the top level has the children
    child[w]..child[w+1]-1, one contiguous range of the next level (the
    closure sorts each level by word).  Level k < depth keeps chain values
    (R, Q and the cotangent) for each target n = k+1..depth, target-major:
    row w's value for n sits at chain_off[k] + (n-k-1)·rows_k + w - lo[k].
    """
    d: int
    depth: int
    lo: np.ndarray          # (depth + 2,) int32, lo[depth + 1] = W + 1
    parent: np.ndarray      # (W + 1,) int32 state row of the parent, 0 = eps
    letter: np.ndarray      # (W + 1,) int32 last letter (0 at eps)
    child: np.ndarray       # (lo[depth] + 1,) int32 first child of each row
    chain_off: np.ndarray   # (depth + 1,) int32, chain_off[depth] = size
    # rows grouped by last letter: the g_dx reduction reads slots
    # letter_off[i]..letter_off[i+1]-1 of the letter-major gv buffer, where
    # row r writes slot gv_pos[r]
    gv_pos: np.ndarray      # (W + 1,) int32 (0 at eps)
    letter_off: np.ndarray  # (d + 1,) int32
    # cotangent columns of each row, ascending (a repeated word sums in
    # column order): row r adds columns cols[col_off[r]:col_off[r+1]]
    col_off: np.ndarray     # (W + 2,) int32
    cols: np.ndarray        # (n_out,) int32

    @property
    def W(self) -> int:
        return int(self.lo[-1]) - 1

    @property
    def chain_size(self) -> int:
        return int(self.chain_off[-1])

    def rows(self, k: int) -> int:
        return int(self.lo[k + 1] - self.lo[k])


@plan_cache
def level_tables(plan: WordPlan) -> LevelTables:
    """The levelwise tables of ``plan``'s closure (raises as
    :func:`sweep_tables`)."""
    t = sweep_tables(plan)
    N, W, d = plan.depth, plan.closure_size, plan.d
    lo = np.concatenate([[0], 1 + t.level_off, [W + 1]]).astype(np.int32)
    parent = np.zeros(W + 1, np.int32)
    letter = np.zeros(W + 1, np.int32)
    rows = np.arange(W)
    last = t.lengths - 1
    parent[1:] = np.where(last > 0, t.prefix[rows, last], 0)
    letter[1:] = t.letters[rows, last]
    # each row's first child: parents are ascending along the rows
    child = np.searchsorted(parent[lo[1]:], np.arange(lo[N] + 1),
                            side="left").astype(np.int32) + lo[1]
    child[0] = lo[1]
    sizes = [(lo[k + 1] - lo[k]) * (N - k) for k in range(1, N)]
    chain_off = np.concatenate([[0, 0], np.cumsum(sizes)]).astype(np.int32)
    order = np.argsort(letter[1:], kind="stable") + 1
    gv_pos = np.zeros(W + 1, np.int32)
    gv_pos[order] = np.arange(W, dtype=np.int32)
    letter_off = np.searchsorted(letter[order], np.arange(d + 1),
                                 side="left").astype(np.int32)
    cols = np.argsort(t.out_rows, kind="stable").astype(np.int32)
    col_off = np.searchsorted(t.out_rows[cols], np.arange(W + 2),
                              side="left").astype(np.int32)
    return LevelTables(d=d, depth=N, lo=lo, parent=parent, letter=letter,
                       child=child, chain_off=chain_off, gv_pos=gv_pos,
                       letter_off=letter_off, col_off=col_off, cols=cols)


def row_pairs(lt: LevelTables) -> tuple[np.ndarray, np.ndarray]:
    """What the kernel loads for a row, 8 bytes at once: ``up`` (W + 1, 2),
    its parent's index within the parent's level and its letter, and
    ``down`` (W + 1, 2), its gv slot and its letter."""
    level = np.searchsorted(lt.lo, np.arange(lt.W + 1), side="right") - 1
    first = lt.lo[np.maximum(level - 1, 0)]
    up = np.stack([lt.parent - first, lt.letter], 1).astype(np.int32)
    down = np.stack([lt.gv_pos, lt.letter], 1).astype(np.int32)
    return up, down


@plan_cache
def emit_slot_table(M: int, stride: int) -> np.ndarray:
    """(M,) int32 the cotangent slot the kernel adds at each step, -1 where
    none: :func:`stream_emit_steps` (``stride`` 0 is the terminal cell,
    only step M - 1 emitted)."""
    steps = stream_emit_steps(M, stride) if stride else np.arange(M)[-1:]
    slots = np.full(M, -1, np.int32)
    slots[steps] = np.arange(len(steps), dtype=np.int32)
    return slots


@plan_cache
def _slots_on(M: int, stride: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(emit_slot_table(M, stride), device=device)


def _check(increments, plan, S_T, g, stream, stream_stride):
    if increments.ndim != 3:
        raise ValueError(f"expected (B, M, d), got {tuple(increments.shape)}")
    B, M, d = increments.shape
    if d != plan.d:
        raise ValueError(f"increments have d={d} channels, the plan is over "
                         f"{plan.d} letters")
    if tuple(S_T.shape) != (B, plan.closure_size):
        raise ValueError(f"S_T must be (B, W) = {(B, plan.closure_size)}, "
                         f"got {tuple(S_T.shape)}")
    if stream_stride < 1:
        raise ValueError(f"stream_stride must be >= 1, got {stream_stride}")
    n_out = len(plan.words)
    want = (B, -(-M // stream_stride), n_out) if stream else (B, n_out)
    if tuple(g.shape) != want:
        raise ValueError(f"the cotangent must be {want}, got "
                         f"{tuple(g.shape)}")


def sig_sweep_plain(increments: torch.Tensor, plan: WordPlan,
                    S_T: torch.Tensor, g: torch.Tensor, *,
                    stream: bool = False,
                    stream_stride: int = 1) -> torch.Tensor:
    """The sweep as a Python loop over time in PyTorch, in the increments'
    dtype.  ``plan`` is prefix-closed or not: the state is its closure;
    ``S_T`` (B, W) the terminal closure coefficients (the eps row is
    implicit); ``g`` the cotangent of ``plan.words``, (B, |I|), or
    (B, M_out, |I|) when streamed.  Returns the increments' gradient
    (B, M, d)."""
    _check(increments, plan, S_T, g, stream, stream_stride)
    from ..core.projection import plan_tables, projected_step
    B, M, d = increments.shape
    dt, dev = increments.dtype, increments.device
    pidx, letters, inv, emit, out_rows = plan_tables(plan, dev, dt)
    lengths = torch.as_tensor(plan.lengths, device=dev)
    S = torch.cat([torch.ones((B, 1), dtype=dt, device=dev), S_T.to(dt)], 1)
    G = torch.zeros_like(S)
    g = g.to(dt)
    slots = emit_slot_table(M, stream_stride if stream else 0)
    gdx = increments.new_zeros((B, M, d))
    for j in range(M - 1, -1, -1):
        if slots[j] >= 0:
            G = G.index_add(1, out_rows, g[:, slots[j]] if stream else g)
        dx = increments[:, j]
        S = projected_step(S, -dx, pidx, letters, inv, emit)   # S_{j-1}
        ps, cs, acc = [], [], None
        for k in range(pidx.shape[1]):   # the Horner chain at (S_{j-1}, dx)
            p = S[:, pidx[:, k]] + (0.0 if acc is None else acc)
            c = dx[:, letters[:, k]] * inv[:, k]
            acc = p * c
            ps.append(p)
            cs.append(c)
        G_new = G.clone()                # the identity term
        b = G[:, 1:]
        for k in range(pidx.shape[1] - 1, -1, -1):
            live = k < lengths           # rows whose chain has link k
            bk = torch.where(live, b, 0.0)
            gdx[:, j].index_add_(1, letters[:, k], bk * ps[k] * inv[:, k])
            pre = bk * cs[k]
            if k > 0:
                G_new.index_add_(1, pidx[:, k], pre)
            b = torch.where(live, pre, b)
        G = G_new
    return gdx


def depth_slots(depth: int) -> int:
    """The kernel instance for ``depth``: its deepest word (a thread holds
    one less chain value of a parent for each target above it)."""
    if depth > MAX_DEPTH:
        raise ValueError(f"words of length {depth} exceed the kernel's "
                         f"MAX_DEPTH {MAX_DEPTH}")
    return next(s for s in DEPTH_SLOTS if depth <= s)


def example_floats(lt: LevelTables) -> int:
    """Floats of one example's sweep state: S below the top level (the top
    level's S is never read), G for every state row, the letter-major gv,
    and the R, Q and cotangent chain values."""
    return int(lt.lo[lt.depth]) + (lt.W + 1) + lt.W + 3 * lt.chain_size


def stage_floats(lt: LevelTables) -> int:
    """Floats of one example's staged increments: two chunks of
    ``CHUNK`` steps."""
    return 2 * CHUNK * lt.d


def block_smem(lt: LevelTables, in_smem: bool) -> int:
    """Dynamic shared-memory bytes of a block, which holds one example: the
    slot table's two chunks, the staged increments and, in shared memory,
    the state."""
    ex = stage_floats(lt) + (example_floats(lt) if in_smem else 0)
    return 4 * (2 * CHUNK + ex)


def step_phases(depth: int) -> int:
    """Dependent phases of one reverse step as the kernel is written (a
    count of its layout, not a measurement): the inverse step with both
    chains, levelwise up to the level below the top, which is one phase
    with its own pull-back, then the pull-back of the levels below it (a
    barrier after each), then the g_dx reduction, which runs into the next
    step's first phase with no barrier between.  So from depth 3 a step
    has 2·depth - 3 barriers and 2·depth - 2 phases.  At depth 2 a barrier
    comes first (the fused level reads every row's cotangent); at depth 1
    the cotangent is copied into gv between two barriers."""
    return 2 * depth - 2 if depth > 2 else depth + 1


@dataclasses.dataclass(frozen=True)
class SweepLaunch:
    """A partition of the levelwise sweep: a block of ``threads`` an
    example."""
    threads: int     # an example's threads, a multiple of 32
    in_smem: bool    # the state in shared memory, else a device scratch
    slots: int       # the instance's chain slots (DEPTH_SLOTS)
    smem: int        # dynamic shared-memory bytes a block
    lanes: tuple[int, ...]   # lanes a parent at levels 1..depth-1


def _warps(n: int) -> int:
    return -(-n // 32) * 32


def widest_level(lt: LevelTables) -> int:
    """The most rows a phase walks: the widest level below the top (the
    inverse step, the chains and the pull-back's parents), or the top
    level when it is the only one."""
    N = lt.depth
    return max(lt.rows(k) for k in range(1, max(N, 2)))


def most_children(lt: LevelTables) -> list[int]:
    """The most children of one row at each level 0..depth-1."""
    counts = np.diff(lt.child)
    return [int(counts[lt.lo[k]:lt.lo[k + 1]].max(initial=0))
            for k in range(lt.depth)]


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def parent_lanes(lt: LevelTables, threads: int) -> tuple[int, ...]:
    """Lanes of one warp that pull a parent's children at each level
    1..depth-1: the fewest powers of two that give each child its own lane,
    at most 32, and no more than the example's threads spread over the
    level's parents (one lane a parent once the parents fill them).  The
    lanes of a parent sum their partial cotangents with shuffles."""
    most = most_children(lt)
    out = []
    for k in range(1, lt.depth):
        fill = max(1, threads // lt.rows(k))
        out.append(min(32, _pow2_at_least(max(most[k], 1)),
                       1 << (fill.bit_length() - 1)))
    return tuple(out)


def pull_threads(lt: LevelTables) -> int:
    """Threads that give every child of the widest pull-back level its own
    lane (:func:`parent_lanes` with no cap)."""
    most = most_children(lt)
    return max([lt.rows(k) * min(32, _pow2_at_least(max(most[k], 1)))
                for k in range(1, lt.depth)], default=0)


@plan_cache
def plan_sweep_launch(plan: WordPlan, *, threads: int | None = None,
                      in_smem: bool | None = None) -> SweepLaunch:
    """The kernel's partition over ``plan``'s closure, a block an example.

    An example gets a thread for each row of its widest level
    (:func:`widest_level`), a lane for each child the pull-back pulls at
    any level (:func:`pull_threads`) up to ``PULL_THREADS`` (more warps
    cost more than the lanes save: 320–384 threads were the fastest at
    each of the training paths' three sweep shapes on an H100), and a warp
    for each letter of the g_dx reduction up to ``REDUCE_WARPS``, rounded
    to warps, within the instance's most threads; the lanes a parent then
    takes at each level are :func:`parent_lanes`.  Its state sits in
    shared memory while it fits ``SMEM_BUDGET``, else in a device-memory
    scratch.  ``threads`` and ``in_smem`` force the partition
    (``in_smem=True`` raises where the state does not fit)."""
    lt = level_tables(plan)
    slots = depth_slots(plan.depth)
    cap = MAX_BLOCK[slots]
    if threads is None:
        T = min(cap, max(_warps(widest_level(lt)),
                         _warps(min(pull_threads(lt), PULL_THREADS)),
                         32 * min(lt.d, REDUCE_WARPS)))
    elif threads % 32 or not 32 <= threads <= cap:
        raise ValueError(f"threads must be a multiple of 32 in [32, {cap}],"
                         f" got {threads}")
    else:
        T = threads
    fits = block_smem(lt, True) <= SMEM_BUDGET
    if in_smem is None:
        in_smem = fits
    elif in_smem and not fits:
        raise ValueError(f"an example's state needs {block_smem(lt, True)}"
                         f" bytes, above the {SMEM_BUDGET} a block may take")
    return SweepLaunch(threads=T, in_smem=in_smem, slots=slots,
                       smem=block_smem(lt, in_smem),
                       lanes=parent_lanes(lt, T))


def partition_variants(plan: WordPlan) -> list[SweepLaunch]:
    """Every partition the planner can choose: its own; one warp an
    example, a thread a row of the widest level (one lane a parent where
    the parents fill them) and the instance's most threads; and its own
    threads with the state in a device-memory scratch.  For tests and
    chip_smoke.py."""
    own = plan_sweep_launch(plan)
    cap = MAX_BLOCK[own.slots]
    rows = min(cap, _warps(widest_level(level_tables(plan))))
    plans = [own, plan_sweep_launch(plan, threads=32),
             plan_sweep_launch(plan, threads=rows),
             plan_sweep_launch(plan, threads=cap),
             plan_sweep_launch(plan, in_smem=False)]
    return list(dict.fromkeys(plans))


@plan_cache
def _level_tables_on(plan: WordPlan,
                     device: torch.device) -> list[torch.Tensor]:
    lt = level_tables(plan)
    return [torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in (*row_pairs(lt), lt.child, lt.letter_off, lt.col_off,
                      lt.cols)]


def _lib() -> ctypes.CDLL:
    lib = _build.library("sig_sweep")
    fn = lib.sig_sweep_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 12 + [i] * 8 + [p] * 3 + [i] + [p]
        fn.restype = ctypes.c_int
    return lib


def _launch(increments: torch.Tensor, plan: WordPlan, S_T: torch.Tensor,
            g: torch.Tensor, stride: int,
            launch: SweepLaunch | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA (or meta) tensors, B, M >= 1, through
    ``pathsig::sig_sweep``; ``stride`` 0 is the terminal cell; ``launch``
    forces a partition (default the planner's).  Returns the fp32 (B, M,
    d) gradient."""
    M = increments.shape[1]
    p = launch or plan_sweep_launch(plan)
    lt = level_tables(plan)
    dev = increments.device
    return torch.ops.pathsig.sig_sweep(
        increments.detach().float().contiguous(),
        S_T.detach().float().contiguous(), g.detach().float().contiguous(),
        *_level_tables_on(plan, dev), _slots_on(M, stride, dev),
        plan_key(plan), plan.depth, p.threads, int(p.in_smem),
        [int(v) for v in lt.lo], [int(v) for v in lt.chain_off],
        [1, *p.lanes], example_floats(lt))


def _output(x: torch.Tensor, *args) -> torch.Tensor:
    """The fp32 (B, M, d) gradient ``pathsig::sig_sweep`` writes, on
    ``x``'s device (its Meta implementation)."""
    return torch.empty(x.shape, dtype=torch.float32, device=x.device)


def _kernel(x: torch.Tensor, s_t: torch.Tensor, g: torch.Tensor,
            up: torch.Tensor, down: torch.Tensor, child: torch.Tensor,
            letter_off: torch.Tensor, col_off: torch.Tensor,
            cols: torch.Tensor, slots: torch.Tensor, plan: int, depth: int,
            threads: int, in_smem: int, lo: list[int], chain_off: list[int],
            lanes: list[int], example_floats: int) -> torch.Tensor:
    """``pathsig::sig_sweep`` on the card: the kernel over contiguous fp32
    increments (B, M, d), terminal closure state (B, W) and cotangents
    (B, |I|) or (B, M_out, |I|), the level tables of
    :func:`_level_tables_on` and the emission slots of
    :func:`emit_slot_table`; ``lo``, ``chain_off`` and ``lanes`` are read
    by the host entry point."""
    global launches
    B, M, d = x.shape
    dev = x.device
    n_emit = g.shape[1] if g.ndim == 3 else 1
    scratch = None if in_smem else torch.empty(
        (B, example_floats), dtype=torch.float32, device=dev)
    gx = _output(x)
    host = [np.ascontiguousarray(v, np.int32) for v in (lo, chain_off, lanes)]
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.sig_sweep_launch(
            x.data_ptr(), s_t.data_ptr(), g.data_ptr(),
            *(t.data_ptr() for t in (up, down, child, letter_off, col_off,
                                     cols)), slots.data_ptr(),
            None if scratch is None else scratch.data_ptr(), gx.data_ptr(),
            B, M, d, s_t.shape[1], depth, g.shape[-1], n_emit, threads,
            *(h.ctypes.data for h in host), example_floats,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"sig_sweep kernel launch failed with cudaError "
                           f"{err} (B={B}, M={M}, d={d}, W={s_t.shape[1]}, "
                           f"depth={depth}, n_emit={n_emit}, threads="
                           f"{threads}, in_smem={bool(in_smem)})")
    launches += 1
    return gx


def sig_sweep(increments: torch.Tensor, plan: WordPlan, S_T: torch.Tensor,
              g: torch.Tensor, *, stream: bool = False,
              stream_stride: int = 1) -> torch.Tensor:
    """The increments' gradient (B, M, d), in their dtype, by the reverse
    sweep (arguments as for :func:`sig_sweep_plain`).  A CPU tensor runs
    :func:`sig_sweep_plain`; a CUDA tensor launches the kernel, which sums
    in fp32; a meta tensor runs the operator's Meta implementation."""
    _check(increments, plan, S_T, g, stream, stream_stride)
    count_new_shape("sig_sweep", launch_shapes,
                    (tuple(increments.shape), increments.dtype,
                     len(plan.words), plan.depth, stream, stream_stride,
                     increments.is_meta),
                    increments, words=len(plan.words), stream=stream,
                    stride=stream_stride)
    if increments.device.type == "cpu":
        return sig_sweep_plain(increments, plan, S_T, g, stream=stream,
                               stream_stride=stream_stride)
    if increments.device.type not in ("cuda", "meta"):
        raise ValueError(f"sig_sweep runs on cuda, meta or cpu tensors, not "
                         f"{increments.device}")
    B, M, _ = increments.shape
    if B == 0 or M == 0:  # no steps: no gradient to sweep, no launch
        return torch.zeros_like(increments)
    gx = _launch(increments, plan, S_T, g, stream_stride if stream else 0)
    return gx.to(increments.dtype)
