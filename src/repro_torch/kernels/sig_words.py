"""Projected signatures over word-set tiles: the Hopper kernel's host side.

Port of ``repro.kernels.sig_words``.  A word set I is cut host-side into
prefix-closed tiles (:func:`repro_torch.core.words.make_tiled_plan`); each
tile is updated independently, the tile-level form of the paper's
thread-per-word CUDA assignment with its redundant shared-ancestor rows.
Per tile the state is (1 + W_pad) rows: row 0 is S[eps] = 1, rows 1..W the
tile's closure words, the rest padding that stays 0.  Per time step, every
row r of length n runs the Horner chain

    acc = 0;  acc = (S_old[prefix_j(r)] + acc) · dx[letter_j(r)] / (n - j),
    j = 0..n-1  (prefix_0 = eps);   S[r] += acc

gathering its prefix row and letter directly by ``prefix_idx``/``letters``
(the TPU kernel's one-hot ``P_j @ S`` products were a workaround for
sublane gathers and are not carried over).

:func:`tile_tables` lays the tiles out padded, (T, depth, W_pad), as the
reference does, and :func:`gather_index` reads the requested words from
the padded (T, 1 + W_pad) states.  The CUDA kernel (``csrc/sig_words.cu``)
runs a partition chosen by :func:`plan_words_launch`: tiles packed into
groups behind one shared eps row (:func:`pack_tiles`), each row's links
packed into registers (:func:`packed_tables`), several examples of one
group a block; it writes (B, |I|) fp32 words, or (B, M_out, |I|) in the
storage dtype, through each group's emission list.  On a CPU tensor
:func:`sig_words` runs :func:`sig_words_plain`, the padded tiles as a
word-table scan in PyTorch; on a CUDA tensor it launches the kernel or
raises.  :class:`SigWordsFunction` given the untiled plan of a word set
that is its own prefix closure in level-major order (the closure tiles of
``ops.projected``) saves the increments and the terminal closure state,
and its backward is the §4.2 sweep kernel over that plan
(:func:`repro_torch.kernels.sig_sweep.sig_sweep`), one launch a call;
without one (``ops.projected_forward_only``) it keeps no closure state
and its backward raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import heapq
from typing import NamedTuple

import numpy as np
import torch

from ..core.signature import stream_emit_steps
from ..core.words import TiledPlan, WordPlan
from . import _build
from .cache import plan_cache
from .sig_sweep import sig_sweep
from .sig_trunc import _storage_dtype

# per-block dynamic shared memory the kernel may take on an H100 (the
# opt-in maximum, 232,448 bytes, less a margin)
SMEM_BUDGET = 232_448 - 1024
CHUNK = 32            # increments staged per shared-memory load (SW_CHUNK)
MAX_DEPTH = 16        # SW_MAX_DEPTH: longest word the kernel takes
ROWS_PER_THREAD = 4   # SW_ROWS_PER_THREAD: chain values a thread holds
MAX_THREADS = 1024
MAX_TILES = 65_535    # the grid's y extent
SMS = 132             # streaming multiprocessors of an H100 SXM
DEPTH_SLOTS = (4, 8, 16)   # link slots a row: the kernel's instances
ROWS = (1, 2, 4)           # rows a thread: the kernel's instances
STAGE_FLOATS = 2048   # scaled increments a chunk may stage
PREFETCH = 4          # SW_PREFETCH: raw increments a thread fetches ahead
GROUP_ROWS = 128      # the planner's cap on a group's closure rows
EXAMPLE_THREADS = 256  # more rows a thread above this many an example
# warps the card holds at once at 64 registers a thread (32 an SM): past
# this, the planner gives each thread more rows (independent chains)
RESIDENT_WARPS = 32 * SMS
MIN_BLOCK = 128       # below this, examples of one group share a block

# launch counters: one per kernel cell, bumped where the kernel is launched
launches = 0
stream_launches = 0


@dataclasses.dataclass(frozen=True, eq=False)
class TileTables:
    """The padded per-tile tables of a :class:`TiledPlan`, laid out
    (T, depth, W_pad) so that neighbouring rows are neighbouring words.
    Rows past a tile's closure and steps j >= len(r) hold 0."""
    w_pad: int                # rows of the largest tile's closure
    depth: int                # longest word of any tile
    prefix_idx: np.ndarray    # (T, depth, W_pad) int32 state rows, 0 = eps
    letters: np.ndarray       # (T, depth, W_pad) int32
    inv: np.ndarray           # (T, depth, W_pad) float32, 1/(len - j)
    lengths: np.ndarray       # (T, W_pad) int32, 0 on padding rows
    gather: np.ndarray        # (|I|,) int64 into the flat (T, 1 + W_pad)

    @property
    def n_tiles(self) -> int:
        return self.lengths.shape[0]


def gather_index(tplan: TiledPlan, w_pad: int) -> np.ndarray:
    """Flat position in (T, 1 + W_pad) of each requested word: the
    reference's ``tile_idx · (1 + W_pad) + row_idx``."""
    tiles = tplan.tiles
    return np.asarray([t * (1 + w_pad) + int(tiles[t].out_rows[k])
                       for t, k in tplan.gather], dtype=np.int64)


@plan_cache
def tile_tables(tplan: TiledPlan) -> TileTables:
    tiles = tplan.tiles
    T = len(tiles)
    w_pad = max(p.closure_size for p in tiles)
    depth = max(p.depth for p in tiles)
    pidx = np.zeros((T, depth, w_pad), np.int32)
    letters = np.zeros((T, depth, w_pad), np.int32)
    inv = np.zeros((T, depth, w_pad), np.float32)
    lengths = np.zeros((T, w_pad), np.int32)
    for t, p in enumerate(tiles):
        W = p.closure_size
        pidx[t, :p.depth, :W] = p.prefix_idx.T
        letters[t, :p.depth, :W] = p.letters.T
        inv[t, :p.depth, :W] = p.inv.T
        lengths[t, :W] = p.lengths
    return TileTables(w_pad=w_pad, depth=depth, prefix_idx=pidx,
                      letters=letters, inv=inv, lengths=lengths,
                      gather=gather_index(tplan, w_pad))


@plan_cache
def _tables_on(tplan: TiledPlan, device: torch.device) -> dict:
    tt = tile_tables(tplan)
    return {k: torch.as_tensor(getattr(tt, k), device=device)
            for k in ("prefix_idx", "letters", "inv", "lengths", "gather")}


def launch_geometry(tt: TileTables, d: int) -> tuple[int, int]:
    """(threads, shared-memory bytes) of one launch; raises on a plan the
    kernel does not take."""
    if tt.depth > MAX_DEPTH:
        raise ValueError(f"words of length {tt.depth} exceed the kernel's "
                         f"MAX_DEPTH {MAX_DEPTH}")
    if tt.n_tiles > MAX_TILES:
        raise ValueError(f"{tt.n_tiles} tiles exceed the grid's {MAX_TILES};"
                         " tile with a larger max_rows")
    threads = min(MAX_THREADS, max(32, -(-tt.w_pad // 32) * 32))
    if tt.w_pad > threads * ROWS_PER_THREAD:
        raise ValueError(f"a tile of {tt.w_pad} rows exceeds the kernel's "
                         f"{threads * ROWS_PER_THREAD}; tile with a smaller "
                         "max_rows")
    # state, then inv, staged increments, prefix_idx, letters, lengths
    smem = 4 * ((1 + tt.w_pad) + 3 * tt.depth * tt.w_pad + tt.w_pad
                + CHUNK * d)
    if smem > SMEM_BUDGET:
        raise ValueError(f"a tile needs {smem} bytes of shared memory, above "
                         f"the {SMEM_BUDGET} a block may take; tile with a "
                         "smaller max_rows")
    return threads, smem


def _lib() -> ctypes.CDLL:
    lib = _build.library("sig_words")
    fn = lib.sig_words_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i] * 15 + [p]
        fn.restype = ctypes.c_int
    return lib


def depth_slots(depth: int) -> int:
    """The kernel instance's link slots a row: the least of 4, 8, 16 that
    holds ``depth``."""
    return next(s for s in DEPTH_SLOTS if s >= depth)


def max_block(slots: int, rows_per_thread: int) -> int:
    """Threads a block of the (slots, rows a thread) instance may have:
    the kernel's launch bounds (``Bounds``), set so that its links stay in
    registers."""
    return 512 if slots * rows_per_thread <= 32 else 256


def tile_sizes(tt: TileTables) -> tuple[int, ...]:
    """Closure rows of each tile (its rows of nonzero length)."""
    return tuple(int(n) for n in (tt.lengths > 0).sum(1))


def _lpt(sizes: tuple[int, ...], tiles: list[int], n: int,
         rows: int) -> list[list[int]] | None:
    """``tiles`` (largest first) over ``n`` groups, each to the least
    loaded; None if a group would pass ``rows``."""
    heap = [(0, g) for g in range(n)]
    groups: list[list[int]] = [[] for _ in range(n)]
    for t in tiles:
        load, g = heapq.heappop(heap)
        if load + sizes[t] > rows:
            return None
        groups[g].append(t)
        heapq.heappush(heap, (load + sizes[t], g))
    return groups


@plan_cache
def pack_tiles(sizes: tuple[int, ...], rows: int) -> tuple[tuple[int, ...],
                                                            ...]:
    """Tiles packed into groups of at most ``rows`` closure rows: a tile
    wider than ``rows`` is a group of its own; the others go largest
    first, each to the least loaded of the fewest groups that keep every
    load within ``rows``.  Tiles are never split."""
    wide = [(t,) for t, n in enumerate(sizes) if n > rows]
    rest = sorted((t for t, n in enumerate(sizes) if n <= rows),
                  key=lambda t: (-sizes[t], t))
    if not rest:
        return tuple(wide)
    lo, hi = -(-sum(sizes[t] for t in rest) // rows), len(rest)
    while lo < hi:  # the fewest groups (one a tile always fits)
        mid = (lo + hi) // 2
        if _lpt(sizes, rest, mid, rows) is None:
            lo = mid + 1
        else:
            hi = mid
    return tuple(wide) + tuple(tuple(g) for g in _lpt(sizes, rest, lo, rows))


class WordsLaunch(NamedTuple):
    """One launch: the tiles of each group; the packing cap ``rows`` and
    the rows of the widest group; the instance (rows a thread, link
    slots); ``threads`` an example and ``examples`` of one group a block;
    the increments staged a chunk; the grid (the larger count on x) and a
    block's dynamic shared memory."""
    groups: tuple[tuple[int, ...], ...]
    rows: int
    r_pad: int
    rows_per_thread: int
    depth_slots: int
    threads: int
    examples: int
    chunk: int
    grid: tuple[int, int]
    smem: int

    @property
    def block(self) -> int:
        return self.threads * self.examples


def _warps(n: int) -> int:
    return -(-n // 32) * 32


def example_smem(r_pad: int, chunk: int, depth: int, d: int) -> int:
    """Dynamic shared-memory bytes of one example: two state buffers of
    1 + r_pad rows and a zero row, and two chunks of scaled increments."""
    return 4 * (2 * (2 + r_pad) + 2 * chunk * depth * d)


def example_cap(plan: WordsLaunch) -> int:
    """The most examples a block of ``plan``'s instance may hold."""
    return min(max_block(plan.depth_slots, plan.rows_per_thread)
               // plan.threads, SMEM_BUDGET // (plan.smem // plan.examples))


@plan_cache
def plan_words_launch(B: int, tt: TileTables, d: int, *,
                      rows: int | None = None,
                      examples: int | None = None,
                      rows_per_thread: int | None = None) -> WordsLaunch:
    """The kernel's partition for (B, ·, d) increments over ``tt``'s tiles.

    Starts from :func:`launch_geometry` (its errors: ``MAX_DEPTH``, the
    tile count, ``max_rows``).  Tiles pack into groups of ``rows``
    (default ``GROUP_ROWS``) closure rows (:func:`pack_tiles`); a thread
    takes the fewest rows (1, 2 or 4) that keep an example within
    ``EXAMPLE_THREADS`` threads and the launch within ``RESIDENT_WARPS``
    warps, else the most (more independent chains a thread once the card
    is full); examples of one group share a block while it stays within
    ``MIN_BLOCK`` threads and the blocks cover every SM.
    ``rows``, ``examples`` and ``rows_per_thread`` force the cap, the
    examples a block and the rows a thread."""
    launch_geometry(tt, d)
    R = GROUP_ROWS if rows is None else rows
    if R < 1:
        raise ValueError(f"rows must be >= 1, got {R}")
    sizes = tile_sizes(tt)
    groups = pack_tiles(sizes, R)
    r_pad = max(sum(sizes[t] for t in g) for g in groups)
    ds = depth_slots(tt.depth)
    G = len(groups)
    if rows_per_thread is None:
        fits = [r for r in ROWS if -(-r_pad // r) <= EXAMPLE_THREADS] or [4]
        rpt = next((r for r in fits if B * G * _warps(-(-r_pad // r)) // 32
                    <= RESIDENT_WARPS), fits[-1])
    elif rows_per_thread in ROWS:
        rpt = rows_per_thread
    else:
        raise ValueError(f"rows_per_thread must be one of {ROWS}")
    threads = max(_warps(-(-r_pad // rpt)), _warps(-(-d // PREFETCH)))
    if threads > max_block(ds, rpt):
        raise ValueError(f"a group of {r_pad} rows at depth {tt.depth} "
                         f"needs {threads} threads, above the kernel's "
                         f"{max_block(ds, rpt)}; tile with a smaller "
                         "max_rows")
    chunk = max(1, min(CHUNK, PREFETCH * threads // d,
                       STAGE_FLOATS // (tt.depth * d)))
    ex_smem = example_smem(r_pad, chunk, tt.depth, d)
    if ex_smem > SMEM_BUDGET:
        raise ValueError(f"an example needs {ex_smem} bytes of shared memory"
                         f", above the {SMEM_BUDGET} a block may take")
    cap = min(max_block(ds, rpt) // threads, SMEM_BUDGET // ex_smem)
    if examples is None:
        e = 1
        while (2 * e * threads <= MIN_BLOCK and 2 * e <= min(cap, B)
               and -(-B // (2 * e)) * G >= SMS):
            e *= 2
    else:
        e = examples
        if not 1 <= e <= cap:
            raise ValueError(f"{e} examples a block do not fit ({threads} "
                             f"threads and {ex_smem} bytes each; at most "
                             f"{cap})")
    nb = -(-B // e)
    if min(nb, G) > MAX_TILES:
        raise ValueError(f"{nb} example blocks and {G} groups exceed the "
                         "grid")
    return WordsLaunch(groups, R, r_pad, rpt, ds, threads, e, chunk,
                       (max(nb, G), min(nb, G)), e * ex_smem)


def partition_variants(B: int, tt: TileTables, d: int) -> list[WordsLaunch]:
    """Every partition the planner can choose for a (B, ·, d) batch: its
    own; one tile and one example a block; each rows a thread that fits
    its packing; and for both packings the most examples a block may
    hold.  For tests and chip_smoke.py."""
    own = plan_words_launch(B, tt, d)
    plans = [own]
    for rows in (1, own.rows):
        one = plan_words_launch(B, tt, d, rows=rows, examples=1)
        plans += [one, plan_words_launch(B, tt, d, rows=rows,
                                         examples=example_cap(one))]
    for rpt in ROWS:
        try:
            plans.append(plan_words_launch(B, tt, d, examples=1,
                                           rows_per_thread=rpt))
        except ValueError:  # the group is too wide for this instance
            continue
    return list(dict.fromkeys(plans))


@dataclasses.dataclass(frozen=True, eq=False)
class PackedTables:
    """A packing's tables, laid out (G, ·, r_pad): each tile's rows follow
    the tiles before it in its group, behind one shared eps row."""
    r_pad: int
    links: np.ndarray     # (G, slots, r_pad) uint32, see link_words
    # the emission list: group g emits entries emit_off[g]:emit_off[g+1],
    # state row emit_rows[i] into output column emit_cols[i]
    emit_off: np.ndarray   # (G + 1,) int32
    emit_rows: np.ndarray  # (|I|,) int32
    emit_cols: np.ndarray  # (|I|,) int32, ascending within a group


@plan_cache
def packed_tables(tt: TileTables, groups: tuple[tuple[int, ...], ...],
                  d: int) -> PackedTables:
    """The kernel's tables for ``groups`` of ``tt``'s tiles over d
    letters, built once a packing and cached."""
    sizes = tile_sizes(tt)
    G, depth = len(groups), tt.depth
    r_pad = max(sum(sizes[t] for t in g) for g in groups)
    pidx = np.zeros((G, depth, r_pad), np.int32)
    letters = np.zeros((G, depth, r_pad), np.int32)
    lengths = np.zeros((G, r_pad), np.int32)
    group = np.zeros(tt.n_tiles, np.int64)
    offset = np.zeros(tt.n_tiles, np.int64)
    for g, tiles in enumerate(groups):
        o = 0
        for t in tiles:
            W = sizes[t]
            p = tt.prefix_idx[t, :, :W]
            pidx[g, :, o:o + W] = np.where(p > 0, p + o, 0)
            letters[g, :, o:o + W] = tt.letters[t, :, :W]
            lengths[g, o:o + W] = tt.lengths[t, :W]
            group[t], offset[t] = g, o
            o += W
    # each requested word: (tile, row) of the padded tiles, then its group
    t, r = np.divmod(tt.gather, 1 + tt.w_pad)
    rows = offset[t] + r
    cols = np.argsort(group[t], kind="stable")
    off = np.searchsorted(group[t][cols], np.arange(G + 1))
    return PackedTables(r_pad=r_pad,
                        links=link_words(pidx, letters, lengths, d,
                                         depth_slots(depth), r_pad + 1),
                        emit_off=off.astype(np.int32),
                        emit_rows=rows[cols].astype(np.int32),
                        emit_cols=cols.astype(np.int32))


@plan_cache
def _packed_on(tt: TileTables, groups: tuple[tuple[int, ...], ...], d: int,
               device: torch.device) -> list[torch.Tensor]:
    pk = packed_tables(tt, groups, d)
    return [torch.as_tensor(a, device=device) for a in (
        pk.links.view(np.int32), pk.emit_off, pk.emit_rows, pk.emit_cols)]


def link_words(prefix: np.ndarray, letters: np.ndarray, lengths: np.ndarray,
               d: int, slots: int, zero: int) -> np.ndarray:
    """Links packed as the kernel reads them, (..., slots, W) uint32 from
    (..., depth, W) prefix rows and letters and (..., W) lengths: link j of
    a row of length n is (prefix row << 16) | the offset (k-1)·d + letter
    of the staged dx_letter/k, k = n - j, in slot s = slots - n + j, so
    k = slots - s in every row.  The slots before link to the state row
    ``zero`` that stays 0, at a staged value of the same k (or of the
    deepest, past the depth).  Slot 0 reads eps or the zero row, so it
    holds 1 or 0 in place of the prefix row."""
    depth, W = prefix.shape[-2:]
    if zero >= 1 << 16 or depth * d > 1 << 16:
        raise ValueError("a group's rows or depth·d exceed the kernel's "
                         "16-bit link fields")
    s = np.arange(slots)[:, None]
    pad = (np.minimum(slots - s, depth) - 1) * d          # (slots, 1)
    out = np.broadcast_to((np.uint32(zero) << 16) | pad.astype(np.uint32),
                          prefix.shape[:-2] + (slots, W)).copy()
    j = np.arange(depth)[:, None]
    k = lengths[..., None, :] - j
    real = (prefix.astype(np.uint32) << 16) | np.where(
        k >= 1, (k - 1) * d + letters, 0).astype(np.uint32)
    idx = np.nonzero(k >= 1)
    slot = (slots - lengths[..., None, :] + j)[idx]
    out[idx[:-2] + (slot, idx[-1])] = real[idx]
    first = out[..., 0, :]
    out[..., 0, :] = np.where(first >> 16 == zero, 0, (1 << 16)
                              | (first & 0xFFFF)).astype(np.uint32)
    return out


def _launch(incs: torch.Tensor, tplan: TiledPlan, stream: bool, stride: int,
            precision: str, plan: WordsLaunch | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA increments (B, M, d), B, M >= 1.  Returns
    fp32 (B, |I|), or (B, M_out, |I|) in the storage dtype.  ``plan``
    (from :func:`plan_words_launch`) replaces the planner's, for tests and
    measurements."""
    global launches, stream_launches
    B, M, d = incs.shape
    tt = tile_tables(tplan)
    if plan is None:
        plan = plan_words_launch(B, tt, d)
    tabs = _packed_on(tt, plan.groups, d, incs.device)
    storage = _storage_dtype(precision)
    x = incs.detach().to(storage).contiguous()
    n = len(tplan.words)
    if stream:
        out = torch.empty((B, -(-M // stride), n), dtype=storage,
                          device=x.device)
    else:
        out = torch.empty((B, n), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.sig_words_launch(
            x.data_ptr(), *(a.data_ptr() for a in tabs), out.data_ptr(), B,
            M, d, len(plan.groups), plan.r_pad, n, tt.depth,
            stride if stream else 0,
            int(storage == torch.bfloat16),
            int(stream and storage == torch.bfloat16), plan.depth_slots,
            plan.rows_per_thread, plan.threads, plan.examples, plan.chunk,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"sig_words kernel launch failed with cudaError "
                           f"{err} (B={B}, M={M}, d={d}, depth={tt.depth}, "
                           f"{plan._replace(groups=len(plan.groups))})")
    if stream:
        stream_launches += 1
    else:
        launches += 1
    return out


class SigWordsFunction(torch.autograd.Function):
    """The CUDA cell as an autograd node.  Given ``closure``, the untiled
    plan of ``tplan``'s words when they are their own prefix closure in
    level-major order (the tiles of ``ops.projected``, as the reference's
    ``_pallas_proj_inverse`` runs the kernel), it saves the increments and
    the terminal closure coefficients (a copy of the streamed cell's last
    emission) and its backward is the §4.2 reverse sweep kernel over
    ``closure``; without it the forward keeps no closure state, and the
    backward raises rather than letting gradients vanish."""

    @staticmethod
    def forward(ctx, increments, tplan, stream, stride, precision,
                closure=None):
        out = _launch(increments, tplan, stream, stride, precision)
        ctx.plan = closure
        if closure is not None:
            ctx.save_for_backward(increments,
                                  out[:, -1].clone() if stream else out)
        ctx.stream, ctx.stride = stream, stride
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.plan is None:
            raise NotImplementedError(
                "sig_words ran over tiles of words that are not their own "
                "prefix closure (ops.projected_forward_only, inference-only "
                "as in the reference): it keeps no closure state for the "
                "§4.2 inverse backward to sweep back from; use ops.projected "
                "to differentiate")
        increments, S_T = ctx.saved_tensors
        gx = sig_sweep(increments, ctx.plan, S_T, g, stream=ctx.stream,
                       stream_stride=ctx.stride)
        return gx, None, None, None, None, None


def sig_words_plain(increments: torch.Tensor, tplan: TiledPlan, *,
                    stream: bool = False,
                    stream_stride: int = 1) -> torch.Tensor:
    """The kernel's plain PyTorch version on the same padded tiles: the
    per-tile word-table scan, a Python loop over time, in the increments'
    dtype, then the same gather.  (B, M, d) -> (B, |I|), or
    (B, M_out, |I|) when streamed."""
    B, M, _ = increments.shape
    tt = tile_tables(tplan)
    tabs = _tables_on(tplan, increments.device)
    dtype = increments.dtype
    T, W, depth = tt.n_tiles, tt.w_pad, tt.depth
    pidx = tabs["prefix_idx"].long()
    letters = tabs["letters"].long()
    n = tabs["lengths"].to(dtype)[:, None, :]                 # (T, 1, W)
    j = torch.arange(depth, dtype=dtype, device=increments.device)
    j = j[None, :, None]
    inv = torch.where(j < n, 1.0 / (n - j).clamp_min(1.0), 0.0)
    emit = (j == n - 1).to(dtype)
    gather = tabs["gather"]
    S = torch.zeros((B, T, 1 + W), dtype=dtype, device=increments.device)
    S[..., 0] = 1.0
    emitted = set(stream_emit_steps(M, stream_stride).tolist()) if stream \
        else ()
    ys = []
    for step in range(M):
        dx = increments[:, step]
        acc = S.new_zeros((B, T, W))
        h = acc
        for jj in range(depth):
            pfx = torch.gather(S, 2, pidx[:, jj][None].expand(B, T, W))
            acc = (pfx + acc) * dx[:, letters[:, jj]] * inv[:, jj]
            h = h + acc * emit[:, jj]
        S = torch.cat([S[..., :1], S[..., 1:] + h], dim=-1)
        if step in emitted:
            ys.append(S.flatten(-2)[:, gather])
    if not stream:
        return S.flatten(-2)[:, gather]
    if not ys:
        return increments.new_zeros((B, 0, len(gather)))
    return torch.stack(ys, 1)


def sig_words(increments: torch.Tensor, tplan: TiledPlan, *,
              stream: bool = False, stream_stride: int = 1,
              precision: str = "fp32",
              closure: WordPlan | None = None) -> torch.Tensor:
    """Projected signature through the tile kernel.  (B, M, d) -> (B, |I|)
    in ``tplan.words`` order, or with ``stream=True`` (B, M_out, |I|),
    M_out = ceil(M / stream_stride), in the input dtype.

    Increments are stored in the precision's dtype (bf16 under
    ``"bf16_fp32"``) and accumulated in fp32; float64 inputs run in fp32
    and are cast back.  A CPU tensor runs :func:`sig_words_plain` on the
    same rounded values; a CUDA tensor launches the kernel.  ``closure``,
    the untiled plan of ``tplan.words`` when they are their own prefix
    closure, makes the launch differentiable (:class:`SigWordsFunction`).
    """
    if increments.ndim != 3:
        raise ValueError(f"expected (B, M, d), got {tuple(increments.shape)}")
    B, M, d = increments.shape
    if d != tplan.d:
        raise ValueError(f"increments have d={d} channels, the plan is over "
                         f"{tplan.d} letters")
    if stream_stride < 1:
        raise ValueError(f"stream_stride must be >= 1, got {stream_stride}")
    storage = _storage_dtype(precision)
    if increments.device.type == "cpu":
        x = increments.to(storage).to(torch.float32)
        out = sig_words_plain(x, tplan, stream=stream,
                              stream_stride=stream_stride)
        return out.to(storage if stream else torch.float32).to(
            increments.dtype)
    if increments.device.type != "cuda":
        raise ValueError(f"sig_words runs on cuda or cpu tensors, not "
                         f"{increments.device}")
    if B == 0 or M == 0:  # no steps: zeros, no launch
        n = len(tplan.words)
        shape = (B, -(-M // stream_stride), n) if stream else (B, n)
        return increments.new_zeros(shape)
    out = SigWordsFunction.apply(increments, tplan, stream, stream_stride,
                                 precision, closure)
    return out.to(increments.dtype)
