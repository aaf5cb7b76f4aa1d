"""Pooled multi-tenant session layer: many live signature streams in ONE
struct-of-arrays device pool.

Port of ``repro.serve.sessions``.  ``SessionStore`` keeps every tenant's
window signature as a row of one :class:`repro_torch.core.stream.StreamCarry`
on the device (batch-sharded across the ranks of a mesh, below):

- **Pool** — (N, D_sig) signatures, (N, R, d) rings and per-row
  ``length`` / ``end`` / ``valid`` lanes.  Slots are recycled through a
  free list; *generation counters* make stale handles detectable instead
  of silently reading another tenant's lane.  The pool grows by doubling,
  so only log₂ many pool sizes ever exist.  The store owns its pool and
  writes updated rows back in place (``index_copy_``), so a flush never
  copies the pool.

- **Continuous-batching ingest** — :meth:`ingest` / :meth:`ingest_many`
  queue ticks per session on the host; :meth:`flush` buckets the sessions
  with new ticks by tick-count rung (powers of two, zero-padded: a zero
  increment is the identity Chen update, so padding is exact), pads the
  row count up a power-of-two rung, and runs one gather → extend →
  scatter per bucket: on a CUDA device one ``sig_trunc`` launch a bucket.
  Launch shapes are bounded by (tick rungs × row rungs × pool sizes)
  whatever the traffic does; ``stats()["compiled_shapes"]`` counts them.

- **Eviction** — explicit (:meth:`evict`), TTL (sessions idle longer than
  ``ttl`` logical-clock units are swept at flush) and LRU (a full pool at
  ``max_sessions`` evicts the least-recently-seen session to admit a new
  one), all accounted in :meth:`stats` next to occupancy, flush shapes
  and p99 ingest staleness.

- **Checkpoint/restore** — :meth:`checkpoint` writes the pool and its
  host metadata through :class:`repro_torch.checkpoint.Checkpointer` in
  the reference's format; :meth:`restore` brings every session back
  bit-identically, from a checkpoint of either package.

- **Mesh** — with ``mesh=`` (or an installed ``sharding_ctx`` at
  construction) the pool is split over the mesh's batch shards: rank r
  holds rows [r·N/P, (r+1)·N/P) (pool sizes are rounded to a multiple of
  P), every rank runs the same calls (SPMD) with the same host mirrors,
  and each update runs on the rank that owns the row, with no
  communication.  Reads of rows (:meth:`features`, :meth:`block_view`,
  the streamed features of :meth:`extend_block`) add the owners' rows
  over the ranks; growing the pool and :meth:`checkpoint` gather it;
  :meth:`restore` lays a checkpoint out on a mesh of any size.

The host mirrors (``length``, ``end``, ``valid``, generations) are the
truth the scheduler reads: the flush path never reads a device tensor
back.  Time is a *logical clock*: every flush advances ``now`` by 1.0, and
every public mutator takes ``now=`` to override.  The wall clock is used
only for the staleness numbers of :meth:`stats`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Iterable, Optional, Union

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..convert import backend_from_reference, dtype_from_reference
from ..core.stream import (SignatureStream, StreamCarry, stream_extend,
                           stream_init, stream_rolling_drop, stream_take)
from ..core.words import sig_dim
from ..device import resolve_device
from ..distributed import batch as DB
from ..distributed import collectives as C
from ..distributed.ctx import (current_mesh, logical_axis_size,
                               named_sharding, no_mesh, sharding_ctx)
from .. import obs
from ..kernels.cache import plan_cache_info
from ..obs import slo as slo_mod
from ..ragged import batch_rung

Sid = Union[str, int]

_LANES = ("sig", "ring", "length", "end", "valid")


@dataclasses.dataclass(frozen=True)
class SessionHandle:
    """Ticket for one live session: (sid, slot, generation).

    The generation is the slot's reuse counter: a handle outlives its
    session only as a detectably stale ticket (store methods raise on it),
    never as a silent read of whichever tenant holds the slot now.
    """
    sid: Sid
    slot: int
    generation: int


def _pctl(sample, q: float) -> float:
    """Percentile of a host-side sample that is 0.0, never NaN, when the
    sample is empty."""
    a = np.asarray(sample, np.float64)
    if a.size == 0:
        return 0.0
    return float(np.percentile(a, q))


def _take_rows(sub: StreamCarry, pos: np.ndarray) -> StreamCarry:
    """The rows ``pos`` of a sub-carry."""
    idx = torch.from_numpy(np.asarray(pos, np.int64)).to(sub.sig.device)
    return dataclasses.replace(sub, **{k: getattr(sub, k).index_select(0, idx)
                                       for k in _LANES})


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@dataclasses.dataclass
class _Pending:
    """Host-side per-session ingest buffer."""
    chunks: list            # list of (m_i, d) np arrays, arrival order
    ticks: int              # total queued increments
    t_enqueue: float        # wall time of the oldest undelivered tick


class SessionStore:
    """Pooled multi-tenant signature sessions (see module docstring).

    Parameters
    ----------
    d, depth        signature configuration of every session in the pool.
    ring_capacity   per-session increment ring R (0 = expanding windows
                    only; rolling drops need R > 0).
    initial_sessions  starting pool size (rounded up to a power of two);
                    the pool doubles as sessions exceed it.
    max_sessions    hard pool bound; a full pool LRU-evicts (when
                    ``lru_evict``) or refuses creates.
    ttl             idle time (logical-clock units) after which a session
                    is evicted at flush; None disables.
    max_ticks       top tick-count rung per session per flush wave; a
                    session with more queued ticks drains over several
                    waves in arrival order.
    max_rows        top row rung per flush bucket.
    backend / dtype engine dispatch of the pool updates (``"auto"``: the
                    CUDA kernels on a CUDA device, the torch engine on the
                    CPU) and the pool's float dtype.
    device          where the pool lives (default CUDA).
    mesh            place the pool batch-sharded across this mesh's ranks
                    (or the ambient ``sharding_ctx`` at construction);
                    ``mesh_rules`` overrides its logical-axis rules.
    """

    def __init__(self, d: int, depth: int, *, ring_capacity: int = 0,
                 initial_sessions: int = 64,
                 max_sessions: Optional[int] = None,
                 ttl: Optional[float] = None, max_ticks: int = 64,
                 max_rows: int = 4096, backend: str = "auto",
                 lru_evict: bool = True, dtype=torch.float32,
                 staleness_window: int = 100_000,
                 slos: Optional[tuple] = None, device=None, mesh=None,
                 mesh_rules: Optional[dict] = None):
        if d < 1 or depth < 1:
            raise ValueError(f"need d >= 1 and depth >= 1, got {d}, {depth}")
        if ring_capacity < 0:
            raise ValueError("ring_capacity must be >= 0")
        if max_ticks < 1 or max_rows < 1:
            raise ValueError("max_ticks and max_rows must be >= 1")
        self.d, self.depth = d, depth
        self.ring_capacity = ring_capacity
        self.max_sessions = max_sessions
        self.ttl = ttl
        self.max_ticks = _pow2(max_ticks)
        self.max_rows = _pow2(max_rows)
        self.backend = backend
        self.lru_evict = lru_evict
        self.dtype = dtype
        self.device = resolve_device(device)
        self.slos = slo_mod.session_slos() if slos is None else tuple(slos)
        self.mesh = mesh if mesh is not None else current_mesh()
        self.mesh_rules = mesh_rules
        mb = self._batch_mesh()
        self._bm = None if mb is None else mb[0]

        n0 = _pow2(initial_sessions)
        if max_sessions is not None and n0 > _pow2(max_sessions):
            n0 = _pow2(max_sessions)
        n0 = self._round(n0)
        self._n = n0                        # pool rows over every rank
        # this rank's block of the pool (all of it off-mesh)
        self._carry: StreamCarry = stream_init(
            n0 // self._batch_shards(), d, depth, capacity=ring_capacity,
            dtype=dtype, device=self.device)

        # host mirrors: the schedulable truth (the device lanes are read
        # only by the pool updates themselves)
        self._ids: dict[Sid, int] = {}
        self._valid = np.zeros(n0, bool)
        self._length = np.zeros(n0, np.int64)
        self._end = np.zeros(n0, np.int64)
        self._generation = np.zeros(n0, np.int64)
        self._last_seen = np.zeros(n0, np.float64)
        self._free: list[int] = self._free_order(0, n0)
        self._pending: dict[int, _Pending] = {}
        self._auto_sid = 0

        self.now = 0.0                      # logical clock
        self._shape_keys: set[tuple] = set()    # distinct launch shapes
        self._flush_shapes: set[tuple[int, int]] = set()
        self._pool_sizes: list[int] = [n0]
        self._staleness = deque(maxlen=staleness_window)
        self.created = 0
        self.updates = 0                    # ticks applied to the pool
        self.flushes = 0
        self.evictions = {"explicit": 0, "ttl": 0, "lru": 0}
        self.dropped_ticks = 0              # queued ticks lost to eviction

    # -- mesh placement ----------------------------------------------------

    def _mesh_scope(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        return sharding_ctx(self.mesh, self.mesh_rules)

    def _batch_shards(self) -> int:
        if self.mesh is None:
            return 1
        with self._mesh_scope():
            return logical_axis_size("batch")

    def _batch_mesh(self):
        if self.mesh is None:
            return None
        from ..kernels.ops import _mesh_batch
        with self._mesh_scope():
            return _mesh_batch()

    def _round(self, n: int) -> int:
        """A pool size rounded up to a multiple of the batch shards."""
        P = self._batch_shards()
        return -(-n // P) * P

    def _pool_shardings(self) -> Optional[StreamCarry]:
        """Batch-sharded placement of every pool lane (None off-mesh)."""
        if self.mesh is None:
            return None
        with self._mesh_scope():
            return StreamCarry(
                sig=named_sharding("batch", None),
                ring=named_sharding("batch", None, None),
                length=named_sharding("batch"), end=named_sharding("batch"),
                valid=named_sharding("batch"), d=self.d, depth=self.depth)

    def _free_order(self, lo: int, hi: int) -> list[int]:
        """Free slots [lo, hi) as a stack (popped from the end): lowest
        first off-mesh; under a mesh the pops take each rank's block in
        turn, so new sessions spread over the ranks that update them."""
        per = self._n // self._batch_shards()
        return sorted(range(lo, hi), key=lambda s: (s % per, s // per),
                      reverse=True)

    def _owned(self, slots: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """-> (positions in ``slots`` of the rows this rank holds, their
        rows in its block); every position off-mesh."""
        slots = np.asarray(slots, np.int64)
        if self._bm is None:
            return np.arange(len(slots)), slots
        per = self._n // self._bm.size()
        pos = np.nonzero(slots // per == self._bm.get_local_rank())[0]
        return pos, slots[pos] % per

    def _add_over_ranks(self, t: torch.Tensor) -> torch.Tensor:
        """Rows that their owners filled (zeros elsewhere) made whole on
        every rank (identity off-mesh)."""
        if self._bm is None:
            return t
        return C.all_reduce_(t, self._bm.get_group(), tag="sessions")

    def _gathered(self) -> StreamCarry:
        """The whole pool on every rank (this rank's block off-mesh)."""
        if self._bm is None:
            return self._carry
        group = self._bm.get_group()

        def whole(a: torch.Tensor) -> torch.Tensor:
            # gloo has no bool collectives: valid travels as uint8
            b = a.to(torch.uint8) if a.dtype == torch.bool else a
            out = C.all_gather(b, group, tag="sessions")
            return out.to(a.dtype)

        return dataclasses.replace(
            self._carry, **{k: whole(getattr(self._carry, k))
                            for k in _LANES})

    # -- pool views --------------------------------------------------------

    @property
    def pool(self) -> StreamCarry:
        """The live struct-of-arrays carry.  Read-only by convention: its
        lanes are updated in place, so clone what must not change.  Under
        a mesh the lanes are DTensors placed ``Shard(0)`` (each rank's
        block)."""
        if self._bm is None:
            return self._carry
        return dataclasses.replace(
            self._carry, **{k: DB.from_rows(getattr(self._carry, k),
                                            self._bm, self._n)
                            for k in _LANES})

    @property
    def pool_size(self) -> int:
        return self._n

    def __len__(self) -> int:
        return len(self._ids)

    def __contains__(self, sid: Sid) -> bool:
        return sid in self._ids

    # -- id / handle resolution --------------------------------------------

    def lookup(self, session: Union[Sid, SessionHandle]) -> SessionHandle:
        """sid or handle -> fresh valid handle.  Raises ``KeyError`` on an
        unknown sid and ``ValueError`` on a stale-generation handle."""
        if isinstance(session, SessionHandle):
            slot = self._ids.get(session.sid)
            if slot is None or slot != session.slot or \
                    self._generation[slot] != session.generation:
                raise ValueError(
                    f"stale session handle {session}: the session was "
                    f"evicted (or its slot was reassigned); look the sid up "
                    f"again or create a new session")
            return session
        slot = self._ids.get(session)
        if slot is None:
            raise KeyError(f"unknown session id {session!r}")
        return SessionHandle(session, slot, int(self._generation[slot]))

    def _slots_of(self, sessions) -> np.ndarray:
        return np.asarray([self.lookup(s).slot for s in sessions], np.int64)

    def _index(self, slots: np.ndarray) -> torch.Tensor:
        """Host slot numbers -> one host→device copy of an int64 index."""
        return torch.from_numpy(np.ascontiguousarray(slots, np.int64)).to(
            self.device)

    def _write_rows(self, idx: torch.Tensor, sub: StreamCarry,
                    n: int) -> None:
        """Write a sub-carry's first ``n`` rows into the pool in place at
        ``idx`` (its padding rows, past ``n``, are dropped)."""
        with torch.no_grad():
            for lane in _LANES:
                getattr(self._carry, lane).index_copy_(
                    0, idx[:n], getattr(sub, lane)[:n])

    def _reset_rows(self, idx: torch.Tensor) -> None:
        """Identity signature, empty ring, length and end 0, valid."""
        with torch.no_grad():
            for lane in ("sig", "ring", "length", "end"):
                getattr(self._carry, lane).index_fill_(0, idx, 0)
            self._carry.valid.index_fill_(0, idx, True)

    # -- create / evict ----------------------------------------------------

    def create(self, sid: Optional[Sid] = None, *,
               now: Optional[float] = None) -> SessionHandle:
        """Admit one session (auto-generated sid when None).  Double-create
        raises; a full pool grows (doubling) up to ``max_sessions``, then
        LRU-evicts or refuses."""
        return self.create_many([sid], now=now)[0]

    def create_many(self, sids: Iterable[Optional[Sid]], *,
                    now: Optional[float] = None) -> list[SessionHandle]:
        """Bulk admission: one in-place reset for the whole batch of
        slots."""
        now = self.now if now is None else float(now)
        sids = list(sids)
        out_sids: list[Sid] = []
        for sid in sids:
            if sid is None:
                while f"s{self._auto_sid}" in self._ids:
                    self._auto_sid += 1
                sid = f"s{self._auto_sid}"
                self._auto_sid += 1
            if sid in self._ids:
                raise ValueError(f"session {sid!r} already exists "
                                 f"(double-create); evict it first or use "
                                 f"a fresh id")
            if sid in out_sids:
                raise ValueError(f"duplicate sid {sid!r} in create_many")
            out_sids.append(sid)
        if self.max_sessions is not None and not self.lru_evict and \
                len(self._ids) + len(out_sids) > self.max_sessions:
            raise RuntimeError(
                f"session pool full: admitting {len(out_sids)} sessions "
                f"would hold {len(self._ids) + len(out_sids)} > "
                f"max_sessions={self.max_sessions} and lru_evict is off")
        # admission is interleaved: each sid registers as its slot is taken,
        # so _take_slot's max_sessions check sees the in-flight creations
        slots = []
        handles = []
        for sid in out_sids:
            slot = self._take_slot(now)
            self._ids[sid] = slot
            self._valid[slot] = True
            self._length[slot] = 0
            self._end[slot] = 0
            self._last_seen[slot] = now
            slots.append(slot)
            handles.append(SessionHandle(sid, slot,
                                         int(self._generation[slot])))
        self.created += len(handles)
        local = self._owned(np.asarray(slots, np.int64))[1]
        if len(local):
            self._reset_rows(self._index(local))
        return handles

    def _take_slot(self, now: float) -> int:
        if self.max_sessions is not None and \
                len(self._ids) >= self.max_sessions:
            if self.lru_evict and self._ids:
                # prefer victims without queued ticks: ingest() already
                # acknowledged that data, so drop it only when every live
                # session is pending (the drop is counted in stats)
                idle = [s for s in self._ids
                        if self._ids[s] not in self._pending]
                victim = min(idle or self._ids,
                             key=lambda s: self._last_seen[self._ids[s]])
                self._evict_sids([victim], reason="lru")
            else:
                raise RuntimeError(
                    f"session pool full ({len(self._ids)} sessions, "
                    f"max_sessions={self.max_sessions}) and lru_evict is off")
        if not self._free:
            self._grow(2 * self._n)
        return self._free.pop()

    def _grow(self, new_n: int) -> None:
        """Double the pool: copy rows into a fresh (new_n, ...) carry.
        Under a mesh the blocks change owners: the pool is gathered and
        each rank keeps its new block."""
        old_n = self._n
        new_n = self._round(max(_pow2(new_n), old_n * 2))
        P = self._batch_shards()
        start = 0 if self._bm is None else \
            self._bm.get_local_rank() * (new_n // P)
        per = new_n // P
        full = self._gathered()

        def grown(a: torch.Tensor) -> torch.Tensor:
            out = a.new_zeros((per, *a.shape[1:]))
            keep = max(0, min(per, old_n - start))
            out[:keep] = a[start:start + keep]
            return out

        with torch.no_grad():
            self._carry = dataclasses.replace(
                self._carry, **{k: grown(getattr(full, k)) for k in _LANES})
        self._n = new_n
        for arr in ("_valid", "_length", "_end", "_generation", "_last_seen"):
            old = getattr(self, arr)
            new = np.zeros(new_n, old.dtype)
            new[:old_n] = old
            setattr(self, arr, new)
        self._free = self._free_order(old_n, new_n) + self._free
        self._pool_sizes.append(new_n)

    def evict(self, session: Union[Sid, SessionHandle], *,
              reason: str = "explicit") -> None:
        """Release a session's slot (pending ticks are dropped).  The slot's
        generation bumps, so outstanding handles go stale."""
        h = self.lookup(session)
        self._evict_sids([h.sid], reason=reason)

    def _evict_sids(self, sids: list[Sid], *, reason: str) -> None:
        slots = []
        dropped_ticks = 0
        for sid in sids:
            slot = self._ids.pop(sid)
            self._valid[slot] = False
            self._generation[slot] += 1
            dropped = self._pending.pop(slot, None)
            if dropped is not None:
                self.dropped_ticks += dropped.ticks
                dropped_ticks += dropped.ticks
            self._free.append(slot)
            slots.append(slot)
        self.evictions[reason] = self.evictions.get(reason, 0) + len(sids)
        if obs.enabled():
            obs.counter("pathsig_sessions_evictions_total",
                        "SessionStore slot evictions by reason",
                        ("reason",)).inc(len(sids), reason=reason)
            if dropped_ticks:
                obs.counter("pathsig_sessions_dropped_ticks_total",
                            "queued ticks lost to eviction"
                            ).inc(dropped_ticks)
        local = self._owned(np.asarray(slots, np.int64))[1]
        with torch.no_grad():
            self._carry.valid.index_fill_(0, self._index(local), False)

    def sweep(self, *, now: Optional[float] = None) -> int:
        """Evict sessions idle for more than ``ttl`` (no-op without one).
        Runs automatically at every flush; returns the eviction count."""
        if self.ttl is None:
            return 0
        now = self.now if now is None else float(now)
        stale = [sid for sid, slot in self._ids.items()
                 if now - self._last_seen[slot] > self.ttl
                 and slot not in self._pending]
        if stale:
            self._evict_sids(stale, reason="ttl")
        return len(stale)

    # -- ingest ------------------------------------------------------------

    @obs.dump_on_error("sessions.ingest")
    def ingest(self, session: Union[Sid, SessionHandle], increments, *,
               now: Optional[float] = None) -> None:
        """Queue (m, d) new increments for one session (delivered at the
        next :meth:`flush`)."""
        h = self.lookup(session)
        inc = np.asarray(increments, np.float32)
        if inc.ndim != 2 or inc.shape[-1] != self.d:
            raise ValueError(f"increments must be (m, {self.d}), got "
                             f"{inc.shape}")
        self._queue(h.slot, inc, now)

    @obs.dump_on_error("sessions.ingest_many")
    def ingest_many(self, sids, counts, ticks, *,
                    now: Optional[float] = None,
                    auto_create: bool = False) -> None:
        """Bulk ingest: ``ticks`` is the (Σ counts, d) concatenation of each
        session's new increments, in ``sids`` order.  With ``auto_create``
        unknown sids are admitted first (the serving arrival path)."""
        sids = list(sids)
        counts = np.asarray(counts, np.int64)
        ticks = np.asarray(ticks, np.float32)
        if len(sids) != len(counts):
            raise ValueError(f"{len(sids)} sids vs {len(counts)} counts")
        if ticks.ndim != 2 or ticks.shape[-1] != self.d:
            raise ValueError(f"ticks must be (sum(counts), {self.d}), got "
                             f"{ticks.shape}")
        if counts.sum() != ticks.shape[0]:
            raise ValueError(f"counts sum to {counts.sum()} but ticks has "
                             f"{ticks.shape[0]} rows")
        if auto_create:
            fresh = [s for s in sids if s not in self._ids]
            if fresh:
                self.create_many(dict.fromkeys(fresh), now=now)
        bounds = np.cumsum(counts)[:-1]
        for sid, chunk in zip(sids, np.split(ticks, bounds)):
            h = self.lookup(sid)
            if len(chunk):
                self._queue(h.slot, chunk, now)

    def _queue(self, slot: int, inc: np.ndarray, now: Optional[float]) -> None:
        t = time.perf_counter()
        p = self._pending.get(slot)
        if p is None:
            self._pending[slot] = _Pending([inc], inc.shape[0], t)
        else:
            p.chunks.append(inc)
            p.ticks += inc.shape[0]
        self._last_seen[slot] = self.now if now is None else float(now)

    @property
    def pending_sessions(self) -> int:
        return len(self._pending)

    @property
    def pending_ticks(self) -> int:
        return sum(p.ticks for p in self._pending.values())

    # -- flush: continuous-batching delivery -------------------------------

    @obs.dump_on_error("sessions.flush")
    def flush(self, *, now: Optional[float] = None) -> int:
        """Deliver every queued tick through bucketed pool updates; advance
        the logical clock; TTL-sweep.  Returns the number of ticks applied.

        Occupancy is validated up front on the host mirrors, so a ring
        overflow raises before any device work and leaves the pool intact.
        """
        R = self.ring_capacity
        if R:
            for slot, p in self._pending.items():
                if self._length[slot] + p.ticks > R:
                    sid = next(s for s, sl in self._ids.items() if sl == slot)
                    raise ValueError(
                        f"flushing {p.ticks} queued increments for session "
                        f"{sid!r} would hold {self._length[slot] + p.ticks} "
                        f"in a ring of capacity {R}; rolling_drop at least "
                        f"{self._length[slot] + p.ticks - R} first")
        pending, self._pending = self._pending, {}
        applied = 0
        t0 = time.perf_counter()
        metrics_on = obs.enabled()
        stale_h = obs.histogram(
            "pathsig_sessions_staleness_seconds",
            "queue residency (enqueue -> flush) per pending session"
        ) if metrics_on else None
        for p in pending.values():
            self._staleness.append(t0 - p.t_enqueue)
            if stale_h is not None:
                stale_h.observe(t0 - p.t_enqueue)
        with obs.span("serve.sessions.flush", sessions=len(pending)):
            # waves: each wave takes at most max_ticks per session, arrival
            # order
            work = {s: np.concatenate(p.chunks) if len(p.chunks) > 1
                    else p.chunks[0] for s, p in pending.items()}
            while work:
                wave = {s: a[:self.max_ticks] for s, a in work.items()}
                work = {s: a[self.max_ticks:] for s, a in work.items()
                        if a.shape[0] > self.max_ticks}
                applied += self._apply_wave(wave)
        self.flushes += 1
        self.now = (self.now + 1.0) if now is None else float(now)
        self.sweep()
        if metrics_on:
            obs.histogram(
                "pathsig_sessions_flush_seconds",
                "host wall-clock of one SessionStore.flush (launch side)"
            ).observe(time.perf_counter() - t0)
            obs.counter("pathsig_sessions_ticks_applied_total",
                        "increments delivered to the pool by flushes"
                        ).inc(applied)
            obs.gauge("pathsig_sessions_pool_occupancy",
                      "live sessions / pool slots").set(
                len(self._ids) / self._n)
            obs.gauge("pathsig_sessions_rung_shapes",
                      "distinct (tick rung, row rung) flush shapes so far"
                      ).set(len(self._flush_shapes))
        return applied

    def _new_shape(self, site: str, key: tuple) -> None:
        """Record a launch shape; a new one ticks ``site``'s retrace
        counter (the reference's jit site of that compute)."""
        if key not in self._shape_keys:
            self._shape_keys.add(key)
            obs.count_trace(site, *key[1:])

    def _rungs(self, ms: np.ndarray) -> np.ndarray:
        return np.minimum(self.max_ticks, 2 ** np.ceil(np.log2(
            np.maximum(ms, 1))).astype(np.int64))

    def _apply_wave(self, wave: dict[int, np.ndarray]) -> int:
        """Bucket one wave's (slot -> (m_i, d)) chunks by tick rung and run
        the gather → extend → scatter per bucket."""
        slots = np.fromiter(wave.keys(), np.int64, len(wave))
        ms = np.asarray([wave[s].shape[0] for s in slots], np.int64)
        rungs = self._rungs(ms)
        applied = 0
        for rung in np.unique(rungs):
            sel = slots[rungs == rung]
            for off in range(0, len(sel), self.max_rows):
                part = sel[off:off + self.max_rows]
                B = batch_rung(len(part), self.max_rows)
                # round the rung up to a multiple of the batch shards
                B = self._round(B)
                incs = np.zeros((B, int(rung), self.d), np.float32)
                counts = np.zeros(B, np.int32)
                for i, slot in enumerate(part):
                    m = wave[slot].shape[0]
                    incs[i, :m] = wave[slot]
                    counts[i] = m
                self._run_flush_step(part, incs, counts)
                self._length[part] += counts[:len(part)]
                if self.ring_capacity:
                    self._end[part] = (self._end[part] + counts[:len(part)]) \
                        % self.ring_capacity
                applied += int(counts.sum())
                self._flush_shapes.add((int(rung), B))
                self._new_shape("session_flush", ("flush", int(rung), B,
                                                  self._n))
        self.updates += applied
        return applied

    def _run_flush_step(self, part: np.ndarray, incs: np.ndarray,
                        counts: np.ndarray) -> None:
        """One bucket of the rows ``part`` (``incs`` / ``counts`` padded to
        the rung): one host→device copy each of the index, increments and
        counts; gather, one extend, write the real rows back.  Under a mesh
        each rank runs the rows it holds, padded up the row ladder."""
        pos, local = self._owned(part)
        n = len(pos)
        if self._bm is not None:
            if not n:
                return
            B = batch_rung(n, self.max_rows)
            incs = np.concatenate([incs[pos], np.zeros(
                (B - n,) + incs.shape[1:], np.float32)])
            counts = np.concatenate([counts[pos],
                                     np.zeros(B - n, counts.dtype)])
        # padding rows point one past the block: the gather clamps them
        # with count 0 (pass-through), the write-back drops them
        idx = np.full(incs.shape[0], self._carry.size, np.int64)
        idx[:n] = local
        idx_t = self._index(idx)
        sub = stream_take(self._carry, idx_t)
        with no_mesh():     # this rank's block: the single-device cell
            sub = stream_extend(
                sub, torch.from_numpy(incs).to(self.device),
                counts=torch.from_numpy(counts).to(self.device),
                backend=self.backend)
        self._write_rows(idx_t, sub, n)

    # -- reads -------------------------------------------------------------

    def _rows(self, lane: str, slots: np.ndarray) -> torch.Tensor:
        """(len(slots), ...) rows of one lane: gathered from the block, or
        under a mesh filled by their owners and added over the ranks."""
        a = getattr(self._carry, lane)
        pos, local = self._owned(slots)
        if self._bm is None:
            return a.index_select(0, self._index(local))
        out = a.new_zeros((len(slots),) + tuple(a.shape[1:]))
        out[self._index(pos)] = a.index_select(0, self._index(local))
        return self._add_over_ranks(out)

    def features(self, session: Union[Sid, SessionHandle]) -> torch.Tensor:
        """(D_sig,) current window signature of one session (a copy)."""
        return self._rows("sig", np.asarray([self.lookup(session).slot]))[0]

    def block_features(self, sessions) -> torch.Tensor:
        """(B, D_sig) gathered signatures for a block of sessions."""
        return self._rows("sig", self._slots_of(sessions))

    def length(self, session: Union[Sid, SessionHandle]) -> int:
        return int(self._length[self.lookup(session).slot])

    def block_view(self, sessions) -> SignatureStream:
        """A :class:`SignatureStream` view of a uniform-occupancy block:
        the per-row spelling the engines expose as ``.state``."""
        slots = self._slots_of(sessions)
        lens, ends = self._length[slots], self._end[slots]
        if len(slots) and (np.any(lens != lens[0]) or np.any(ends != ends[0])):
            raise ValueError("block_view needs uniform occupancy across the "
                             "block (use features()/length() per session)")
        return SignatureStream(
            sig=self._rows("sig", slots), ring=self._rows("ring", slots),
            length=int(lens[0]) if len(slots) else 0,
            end=int(ends[0]) if len(slots) else 0,
            d=self.d, depth=self.depth)

    def set_block(self, sessions, state: SignatureStream) -> None:
        """Write a (B,)-batched :class:`SignatureStream` back into a block's
        slots: the inverse of :meth:`block_view`."""
        slots = self._slots_of(sessions)
        if state.batch != len(slots):
            raise ValueError(f"carry batch {state.batch} != block size "
                             f"{len(slots)}")
        if (state.d, state.depth) != (self.d, self.depth):
            raise ValueError(f"carry is (d={state.d}, depth={state.depth}) "
                             f"but the pool holds (d={self.d}, "
                             f"depth={self.depth})")
        if state.capacity != self.ring_capacity:
            raise ValueError(f"carry ring capacity {state.capacity} != pool "
                             f"ring capacity {self.ring_capacity}")
        B, dev = len(slots), self.device
        sub = StreamCarry(
            sig=torch.as_tensor(state.sig).to(dev, self.dtype),
            ring=torch.as_tensor(state.ring).to(dev, self.dtype),
            length=torch.full((B,), int(state.length), dtype=torch.int32,
                              device=dev),
            end=torch.full((B,), int(state.end), dtype=torch.int32,
                           device=dev),
            valid=torch.ones((B,), dtype=torch.bool, device=dev),
            d=self.d, depth=self.depth)
        pos, local = self._owned(slots)
        self._write_rows(self._index(local), _take_rows(sub, pos), len(pos))
        self._length[slots] = int(state.length)
        self._end[slots] = int(state.end)

    # -- synchronous block updates (the engines' fixed-slot path) ----------

    def create_block(self, n: int, *,
                     prefix: str = "slot") -> list[SessionHandle]:
        """n fresh sessions with generated ids ``{prefix}0..`` (skipping
        taken ids): the fixed batch slots a serving engine owns."""
        sids: list[str] = []
        k = 0
        while len(sids) < n:
            sid = f"{prefix}{k}"
            k += 1
            if sid not in self._ids:
                sids.append(sid)
        return self.create_many(sids)

    def extend_block(self, sessions, increments, *,
                     return_stream: bool = False, stream_stride: int = 1,
                     backward: str = "inverse",
                     now: Optional[float] = None):
        """Synchronously append one uniform (B, m, d) chunk to a block of
        sessions (bypassing the ingest queue): one ``sig_trunc`` launch on
        a CUDA device, streamed with ``return_stream``.  Returns the (B,
        m_out, D_sig) per-step features when ``return_stream``.  Raises on
        ring overflow exactly like ``SignatureStream.extend``."""
        slots = self._slots_of(sessions)
        increments = torch.as_tensor(increments, device=self.device)
        if increments.ndim != 3 or increments.shape[-1] != self.d:
            raise ValueError(f"increments must be (B, m, {self.d}), got "
                             f"{tuple(increments.shape)}")
        if increments.shape[0] != len(slots):
            raise ValueError(f"batch {increments.shape[0]} != block size "
                             f"{len(slots)}")
        m = increments.shape[1]
        R = self.ring_capacity
        if R:
            worst = int(self._length[slots].max(initial=0))
            if worst + m > R:
                raise ValueError(
                    f"extending by {m} would hold {worst + m} increments in "
                    f"a ring of capacity {R}; rolling_drop at least "
                    f"{worst + m - R} first")
        pos, local = self._owned(slots)
        feats = None
        if len(pos):   # under a mesh: the rows this rank holds
            idx = self._index(local)
            # uniform chunks: the streamed cell takes no per-row counts
            with no_mesh():
                out = stream_extend(stream_take(self._carry, idx),
                                    increments[self._index(pos)]
                                    if self._bm is not None else increments,
                                    backend=self.backend, backward=backward,
                                    return_stream=return_stream,
                                    stream_stride=stream_stride)
            sub, feats = out if return_stream else (out, None)
            self._write_rows(idx, sub, len(pos))
        if return_stream and self._bm is not None:
            whole = increments.new_zeros(
                (len(slots), -(-m // stream_stride),
                 sig_dim(self.d, self.depth)))
            if feats is not None:
                whole[self._index(pos)] = feats.to(whole.dtype)
            feats = self._add_over_ranks(whole)
        self._new_shape("session_extend",
                        ("extend", len(slots), m, self._n,
                         return_stream, stream_stride, backward,
                         self.backend))
        self._length[slots] += m
        if R:
            self._end[slots] = (self._end[slots] + m) % R
        self._last_seen[slots] = self.now if now is None else float(now)
        self.updates += int(m * len(slots))
        return feats

    def drop_block(self, sessions, n: int) -> None:
        """Synchronously drop each block session's ``n`` oldest increments
        (the exact left-inverse update, plain tensor algebra)."""
        slots = self._slots_of(sessions)
        if self.ring_capacity == 0:
            raise ValueError("rolling_drop needs ring buffers: build the "
                             "store with ring_capacity > 0")
        shortest = int(self._length[slots].min()) if len(slots) else 0
        if not 0 <= n <= shortest:
            raise ValueError(f"cannot drop {n} increments from a window of "
                             f"length {shortest}")
        if n == 0:
            return
        local = self._owned(slots)[1]
        if len(local):
            idx = self._index(local)
            sub = stream_rolling_drop(stream_take(self._carry, idx), int(n))
            self._write_rows(idx, sub, len(local))
        self._new_shape("session_drop",
                        ("drop", len(slots), int(n), self._n))
        self._length[slots] -= n

    def reset_block(self, sessions) -> None:
        """Zero a block's windows in place (lengths back to 0, handles stay
        valid)."""
        slots = self._slots_of(sessions)
        local = self._owned(slots)[1]
        if len(local):
            self._reset_rows(self._index(local))
        self._length[slots] = 0
        self._end[slots] = 0

    # -- accounting --------------------------------------------------------

    def stats(self) -> dict:
        """Occupancy / eviction / flush-shape / staleness accounting, with
        the reference's keys.  ``compiled_shapes`` counts distinct launch
        shapes; ``compute_cache`` is the kernels' plan-cache info."""
        stale = self._staleness
        return {
            "sessions": len(self._ids),
            "pool_size": self._n,
            "occupancy": len(self._ids) / self._n,
            "pool_sizes": list(self._pool_sizes),
            "created": self.created,
            "evictions": dict(self.evictions),
            "dropped_ticks": self.dropped_ticks,
            "updates": self.updates,
            "flushes": self.flushes,
            "pending_sessions": self.pending_sessions,
            "pending_ticks": self.pending_ticks,
            "flush_shapes": sorted(self._flush_shapes),
            "compiled_shapes": len(self._shape_keys),
            "compute_cache": plan_cache_info(),
            "devices": self._batch_shards(),
            "p50_staleness_s": _pctl(stale, 50),
            "p99_staleness_s": _pctl(stale, 99),
            "now": self.now,
        }

    def health(self, slos: Optional[tuple] = None) -> dict:
        """Machine-readable SLO health evaluated over :meth:`stats`:
        ``{"status": "ok"|"breach", "breaches": [...], "results": [...]}``;
        pass :class:`repro_torch.obs.Slo` specs (or the store's ``slos=``)
        to change objectives."""
        use = self.slos if slos is None else tuple(slos)
        return slo_mod.report(slo_mod.evaluate_values(use, self.stats()))

    # -- checkpoint / restore ----------------------------------------------

    def _host_state(self) -> dict:
        return {
            "kind": "session_store",
            "d": self.d, "depth": self.depth,
            "ring_capacity": self.ring_capacity,
            "pool_size": self._n,
            "max_sessions": self.max_sessions, "ttl": self.ttl,
            "max_ticks": self.max_ticks, "max_rows": self.max_rows,
            "backend": self.backend, "lru_evict": self.lru_evict,
            "dtype": str(self.dtype).removeprefix("torch."),
            "ids": [[sid, int(slot)] for sid, slot in self._ids.items()],
            "generation": self._generation.tolist(),
            "valid": self._valid.astype(int).tolist(),
            "length": self._length.tolist(),
            "end": self._end.tolist(),
            "last_seen": self._last_seen.tolist(),
            "free": list(self._free),
            "auto_sid": self._auto_sid,
            "now": self.now,
            "created": self.created, "updates": self.updates,
            "flushes": self.flushes,
            "evictions": dict(self.evictions),
            "dropped_ticks": self.dropped_ticks,
            "pool_sizes": list(self._pool_sizes),
            "flush_shapes": sorted(self._flush_shapes),
        }

    def checkpoint(self, ckptr: Checkpointer, step: int) -> None:
        """Write the whole pool (device carry + host metadata).  Pending
        ticks are flushed first, so a restore resumes every session from
        exactly this state."""
        if self._pending:
            self.flush()
        carry = self._gathered()
        if self._bm is None:
            ckptr.save(carry, {}, step, extra=self._host_state())
            return
        # every rank holds the whole pool now; the first one writes it
        if self._bm.get_local_rank() == 0:
            ckptr.save(carry, {}, step, extra=self._host_state())
            ckptr.wait()
        torch.distributed.barrier(group=self._bm.get_group())

    @classmethod
    def restore(cls, ckptr: Checkpointer, *, step: Optional[int] = None,
                backend: Optional[str] = None, device=None, mesh=None,
                mesh_rules: Optional[dict] = None) -> "SessionStore":
        """Rebuild a store from a checkpoint of either package,
        bit-identically: every session's signature, ring, occupancy, id,
        generation and the logical clock come back exactly.  A reference
        checkpoint's backend maps through
        :func:`repro_torch.convert.backend_from_reference`.  ``mesh`` (or
        the ambient context) lays the pool out over its ranks, whatever
        the shard count it was written at."""
        extra = ckptr.peek_extra(step)
        if extra.get("kind") != "session_store":
            raise ValueError(f"checkpoint is not a session pool: {extra!r}")
        store = cls(
            extra["d"], extra["depth"],
            ring_capacity=extra["ring_capacity"],
            initial_sessions=extra["pool_size"],
            max_sessions=extra["max_sessions"], ttl=extra["ttl"],
            max_ticks=extra["max_ticks"], max_rows=extra["max_rows"],
            backend=backend or backend_from_reference(extra["backend"]),
            lru_evict=extra["lru_evict"],
            dtype=dtype_from_reference(extra["dtype"]), device=device,
            mesh=mesh, mesh_rules=mesh_rules)
        if store.pool_size != extra["pool_size"]:
            raise ValueError(f"pool size {extra['pool_size']} does not "
                             f"round-trip (got {store.pool_size})")
        sh = store._pool_shardings() if store._bm is not None else None
        carry, _, _ = ckptr.restore(
            store.pool, {}, step,
            shardings=None if sh is None else {"params": sh,
                                               "opt_state": {}})
        store._carry = dataclasses.replace(
            carry, **{k: DB.to_local(getattr(carry, k)) for k in _LANES})
        store._ids = {sid: int(slot) for sid, slot in extra["ids"]}
        store._generation = np.asarray(extra["generation"], np.int64)
        store._valid = np.asarray(extra["valid"], bool)
        store._length = np.asarray(extra["length"], np.int64)
        store._end = np.asarray(extra["end"], np.int64)
        store._last_seen = np.asarray(extra["last_seen"], np.float64)
        store._free = list(extra["free"])
        store._auto_sid = int(extra["auto_sid"])
        store.now = float(extra["now"])
        store.created = int(extra["created"])
        store.updates = int(extra["updates"])
        store.flushes = int(extra["flushes"])
        store.evictions = dict(extra["evictions"])
        store.dropped_ticks = int(extra.get("dropped_ticks", 0))
        store._pool_sizes = list(extra["pool_sizes"])
        store._flush_shapes = {tuple(s) for s in extra["flush_shapes"]}
        return store
