"""Dynamic batching for ragged signature serving.

Port of ``repro.serve.batcher``.  ``DynamicBatcher`` turns per-request
traffic into micro-batches drawn from a bounded set of shapes:

1. requests are queued (:meth:`submit`) as (M_i+1, d) paths;
2. :meth:`flush` packs them into length buckets on the
   :func:`repro_torch.ragged.bucket_ladder` and pads each micro-batch's row
   count up a power-of-two ladder, on the host;
3. each micro-batch runs ONE engine call over its padded
   :class:`repro_torch.ragged.RaggedPaths` — exact per-request answers,
   because zero-masked padding is the identity;
4. results are scattered back to the submitting tickets.

With ``async_dispatch`` (the default) the next micro-batches are staged
while the current one computes: on a CUDA device each is pinned in host
memory and copied on a side stream, and the compute stream waits on that
copy's event; at most ``max_in_flight`` computes are outstanding, the
oldest retired by its event before the next launch.
``async_dispatch=False`` runs each micro-batch strictly in turn (copy,
compute, next).

With a ``mesh`` (or an installed ``sharding_ctx`` at construction) the
batcher places its rungs across the mesh's ranks: every rank submits and
flushes the same requests, each rung's row count is rounded up to a
multiple of the batch-shard count, each rank copies and computes only its
own rows (a batch DTensor placed ``Shard(0)``, so the engine's dispatch
takes its mesh path), and the answers are gathered back so that every
rank resolves every ticket.

``shapes_seen`` is the set of (padded_len, padded_batch) pairs fed to the
engine; :meth:`stats` reports padding waste next to it, the flush-latency
window, and the prefetch counts, and :meth:`health` evaluates SLOs over
them.

The two factories bind the batcher to the serving engines:
:meth:`signature_service` computes each request's terminal signature, and
:meth:`scoring_service` scores requests against a
:class:`repro_torch.serve.engine.SigScoreEngine`'s cached references (one
``sig_trunc`` and one ``sig_gram`` launch per micro-batch on a CUDA
device).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

import contextlib

from ..core import tensor_ops as tops
from ..device import resolve_device
from ..distributed import batch as DB
from ..distributed.ctx import current_mesh, logical_axis_size, sharding_ctx
from .. import obs
from ..kernels.cache import plan_cache_info
from ..obs import slo as slo_mod
from ..ragged import (RaggedPaths, assign_buckets, batch_rung, bucket_ladder,
                      pad_batch)


@dataclasses.dataclass
class _Request:
    ticket: int
    path: np.ndarray      # (M_i+1, d)
    length: int           # increments


@dataclasses.dataclass
class DynamicBatcher:
    """Queue → length-bucket → micro-batch executor (see module docstring).

    ``compute(batch: RaggedPaths) -> (B, ...) tensor`` is the per-bucket
    engine call; row b of its output is the answer for example b.  Build one
    with :meth:`signature_service` / :meth:`scoring_service`, or pass any
    callable.  Micro-batches run on ``device`` (default CUDA).
    """
    compute: Callable[[RaggedPaths], torch.Tensor]
    d: int
    max_len: int                      # longest accepted request (increments)
    min_bucket: int = 16              # bottom rung of the length ladder
    growth: float = 2.0               # ladder growth factor
    max_batch: int = 64               # top rung of the batch ladder
    ladder: Optional[np.ndarray] = None   # explicit rungs override
    mesh: Optional[object] = None     # DeviceMesh: place rungs across ranks
    mesh_rules: Optional[dict] = None     # logical-axis rule overrides
    slos: Optional[tuple] = None      # health() objectives (None -> defaults)
    latency_window: int = 1024        # recent flush latencies kept for health
    async_dispatch: bool = True       # stage the next rungs while one runs
    max_in_flight: int = 2            # bound on dispatched-not-retired rungs
    device: Optional[object] = None

    def __post_init__(self):
        if self.ladder is None:
            self.ladder = bucket_ladder(self.max_len,
                                        min_len=self.min_bucket,
                                        growth=self.growth)
        self.ladder = np.asarray(self.ladder, np.int64)
        self.max_len = int(self.ladder[-1])
        self.device = resolve_device(self.device)
        if self.mesh is None:  # adopt an installed context at build time
            self.mesh = current_mesh()
        if self.slos is None:
            self.slos = slo_mod.batcher_slos()
        # host-side latency record, so health() needs no metrics registry
        self._flush_latencies = collections.deque(
            maxlen=max(1, self.latency_window))
        if self.max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1, got "
                             f"{self.max_in_flight}")
        self._queue: list[_Request] = []
        self._next_ticket = 0
        self._in_flight_peak = 0      # most dispatched-not-retired rungs seen
        self._prefetched_rungs = 0    # Σ rungs staged ahead of their compute
        self.shapes_seen: set[tuple[int, int]] = set()
        self.batches = 0              # micro-batches fed to the engine
        self.padded_steps = 0         # Σ padded increments fed to the engine
        self.true_steps = 0           # Σ true increments served
        self.padded_rows = 0          # Σ batch rows fed to the engine
        self.true_rows = 0            # Σ real requests served

    # -- mesh placement ----------------------------------------------------

    def _mesh_scope(self):
        """Context manager installing this batcher's mesh (a no-op when the
        batcher is single-device)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return sharding_ctx(self.mesh, self.mesh_rules)

    def _batch_shards(self) -> int:
        """Shards of the "batch" logical axis under this batcher's own mesh
        (fixed at construction, never the ambient context, so the rung
        rounding and ``stats()`` cannot drift with the call site)."""
        if self.mesh is None:
            return 1
        with self._mesh_scope():
            return logical_axis_size("batch")

    def _batch_mesh(self):
        """(1-D batch mesh, shard count), or None off-mesh or with one
        shard."""
        if self.mesh is None:
            return None
        from ..kernels.ops import _mesh_batch
        with self._mesh_scope():
            return _mesh_batch()

    def submit(self, path) -> int:
        """Queue one (M_i+1, d) path; returns the ticket :meth:`flush`
        resolves."""
        path = np.asarray(path, np.float32)
        if path.ndim != 2 or path.shape[-1] != self.d:
            raise ValueError(f"request must be (M+1, {self.d}), got "
                             f"{path.shape}")
        length = path.shape[0] - 1
        if not 0 <= length <= self.max_len:
            raise ValueError(f"request length {length} outside [0, "
                             f"{self.max_len}] (the ladder's top rung)")
        t = self._next_ticket
        self._next_ticket += 1
        self._queue.append(_Request(t, path, length))
        if obs.enabled():
            obs.gauge("pathsig_batcher_queue_depth",
                      "requests waiting in the DynamicBatcher queue",
                      ).set(len(self._queue))
        return t

    @property
    def pending(self) -> int:
        return len(self._queue)

    def _pack_groups(self, queue) -> list:
        """Bucket + split the queue into host-side micro-batches
        [(rung, B_pad, part, RaggedPaths on the CPU)], with shape/padding
        accounting applied."""
        shards = self._batch_shards()
        lengths = np.asarray([r.length for r in queue], np.int64)
        which = assign_buckets(lengths, self.ladder)
        groups = []
        for k in np.unique(which):
            rung = int(self.ladder[k])
            group = [queue[i] for i in np.nonzero(which == k)[0]]
            # split oversized groups so the batch rung never exceeds
            # max_batch
            for off in range(0, len(group), self.max_batch):
                part = group[off:off + self.max_batch]
                rp = RaggedPaths.from_list([r.path for r in part],
                                           pad_to=rung, device="cpu")
                B_pad = batch_rung(len(part), self.max_batch)
                # round the rung up to a multiple of the mesh's batch
                # shards so every rank owns the same number of rows
                B_pad = -(-B_pad // shards) * shards
                self.shapes_seen.add((rung, B_pad))
                self.padded_steps += rung * B_pad
                self.true_steps += int(sum(r.length for r in part))
                self.padded_rows += B_pad
                self.true_rows += len(part)
                groups.append((rung, B_pad, part, pad_batch(rp, B_pad)))
        return groups

    def _place(self, rp: RaggedPaths, side) -> tuple:
        """Stage one host micro-batch on the device: (RaggedPaths, event).
        Under a mesh only this rank's rows are staged.  On CUDA with a side
        stream the batch is pinned and copied there, and the event marks
        the copy's end; otherwise the copy is in order and the event is
        None."""
        mb = self._batch_mesh()
        if mb is not None:
            rp = RaggedPaths(DB.local_rows(rp.values, mb[0]),
                             DB.local_rows(rp.lengths, mb[0]))
        if side is None:
            return RaggedPaths(rp.values.to(self.device),
                               rp.lengths.to(self.device)), None
        with torch.cuda.stream(side):
            out = RaggedPaths(
                rp.values.pin_memory().to(self.device, non_blocking=True),
                rp.lengths.pin_memory().to(self.device, non_blocking=True))
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def _run_groups(self, groups) -> list:
        """Async-dispatch executor: stage the next rungs' micro-batches up
        to ``max_in_flight`` groups ahead while the current one computes,
        launch every compute without waiting for its result, and retire the
        oldest outstanding rung by its event before a launch would put
        more than ``max_in_flight`` in flight (the reference retires just
        after such a launch, so its ``in_flight_peak`` is one higher).
        Returns [(part, result)]; with ``async_dispatch=False`` this is
        strict copy → compute → next order."""
        window = self.max_in_flight if self.async_dispatch else 0
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda and window else None
        placed = collections.deque()
        next_put = 0

        def top_up(limit):
            nonlocal next_put
            while next_put < len(groups) and next_put < limit:
                rung, B_pad, part, rp = groups[next_put]
                placed.append((part, *self._place(rp, side)))
                next_put += 1

        results: list = []
        in_flight: collections.deque = collections.deque()
        for i in range(len(groups)):
            top_up(i + 1 + window)
            self._prefetched_rungs += len(placed) - 1
            part, rp, copied = placed.popleft()
            while len(in_flight) >= max(1, window):
                done = in_flight.popleft()
                if done is not None:
                    done.synchronize()
            if copied is not None:
                main = torch.cuda.current_stream(self.device)
                main.wait_event(copied)
                # the copy was allocated on the side stream: keep its memory
                # until the compute stream is done with it
                rp.values.record_stream(main)
                rp.lengths.record_stream(main)
            rung, B_pad = groups[i][0], groups[i][1]
            mb = self._batch_mesh()
            if mb is not None:   # this rank's rows of the rung
                rp = RaggedPaths(DB.from_rows(rp.values, mb[0], B_pad),
                                 DB.from_rows(rp.lengths, mb[0], B_pad))
            with self._mesh_scope(), \
                    obs.span("serve.batcher.rung", rung=rung, B_pad=B_pad,
                             rows=len(part), prefetched=len(placed),
                             clock="host: the launches, not the device "
                                   "work"):
                res = self.compute(rp)
            self.batches += 1
            results.append((part, res))
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record()
            in_flight.append(done)
            self._in_flight_peak = max(self._in_flight_peak, len(in_flight))
        return results

    @obs.dump_on_error("batcher.flush")
    def flush(self) -> dict[int, torch.Tensor]:
        """Run every queued request through bucketed micro-batches; returns
        {ticket: result_row}."""
        queue, self._queue = self._queue, []
        out: dict[int, torch.Tensor] = {}
        if not queue:
            return out
        t_flush = time.perf_counter()
        with obs.span("serve.batcher.flush", requests=len(queue)):
            for part, res in self._run_groups(self._pack_groups(queue)):
                res = DB.gather_rows(res, tag="batcher")  # every ticket
                for row, req in enumerate(part):
                    out[req.ticket] = res[row]
        self._flush_latencies.append(time.perf_counter() - t_flush)
        if obs.enabled():
            obs.histogram(
                "pathsig_batcher_flush_seconds",
                "host wall-clock of one DynamicBatcher.flush (launch side)",
            ).observe(time.perf_counter() - t_flush)
            obs.counter("pathsig_batcher_requests_total",
                        "requests served through DynamicBatcher.flush",
                        ).inc(len(queue))
            obs.gauge("pathsig_batcher_padding_overhead",
                      "cumulative padded/true step ratio fed to the engine",
                      ).set(self.padded_steps / self.true_steps
                            if self.true_steps else 0.0)
            obs.gauge("pathsig_batcher_occupancy",
                      "cumulative true/padded batch-row occupancy",
                      ).set(self.true_rows / self.padded_rows
                            if self.padded_rows else 0.0)
            obs.gauge("pathsig_batcher_compiled_shapes",
                      "distinct (rung, B_pad) shapes fed to the engine",
                      ).set(len(self.shapes_seen))
            obs.gauge("pathsig_batcher_queue_depth",
                      "requests waiting in the DynamicBatcher queue",
                      ).set(len(self._queue))
        return out

    def _flush_pctl(self, q: float) -> float:
        lat = sorted(self._flush_latencies)
        if not lat:
            return 0.0
        i = max(0, min(len(lat) - 1,
                       int(np.ceil(q / 100.0 * len(lat))) - 1))
        return lat[i]

    def stats(self) -> dict:
        """Shape-count + padding-waste accounting for the traffic so far,
        the recent flush latencies and the prefetch counts, with the
        reference's keys (and ``batches``); ``devices`` is the mesh's
        batch-shard count and ``rows_per_device`` each rank's rows."""
        shards = self._batch_shards()
        return {
            "flush_p50_s": self._flush_pctl(50),
            "flush_p99_s": self._flush_pctl(99),
            "flushes_recorded": len(self._flush_latencies),
            "compiled_shapes": len(self.shapes_seen),
            "shapes": sorted(self.shapes_seen),
            "ladder": self.ladder.tolist(),
            "batches": self.batches,
            "padded_steps": self.padded_steps,
            "true_steps": self.true_steps,
            "padding_overhead": (self.padded_steps / self.true_steps
                                 if self.true_steps else 0.0),
            "devices": shards,
            "rows_per_device": self.padded_rows // shards,
            "occupancy": (self.true_rows / self.padded_rows
                          if self.padded_rows else 0.0),
            "async_dispatch": self.async_dispatch,
            "max_in_flight": self.max_in_flight,
            "in_flight_peak": self._in_flight_peak,
            "prefetched_rungs": self._prefetched_rungs,
            "compute_cache": plan_cache_info(),
        }

    def health(self, slos: Optional[tuple] = None) -> dict:
        """Machine-readable SLO health evaluated over :meth:`stats`:
        ``{"status": "ok"|"breach", "breaches": [...], "results": [...]}``
        (host-side; the recent-flush latency window feeds the p99)."""
        use = self.slos if slos is None else tuple(slos)
        return slo_mod.report(slo_mod.evaluate_values(use, self.stats()))

    @classmethod
    def signature_service(cls, d: int, depth: int, *, max_len: int,
                          backend: str = "auto", transform=None,
                          precision: str = "fp32", device=None,
                          **kw) -> "DynamicBatcher":
        """Batcher computing each request's terminal signature (D_sig,)
        through :func:`repro_torch.kernels.ops.signature`: on a CUDA device
        the ``sig_trunc`` kernel serves every micro-batch in one launch.
        ``transform`` fuses path transforms into that launch (no augmented
        intermediate per batch; the basepoint start is each request's first
        point)."""
        from ..core.transforms import as_transform
        from ..kernels import ops
        spec = as_transform(transform)

        def compute(rp: RaggedPaths) -> torch.Tensor:
            # under a mesh rp holds batch DTensors: each rank differences
            # its own rows
            vals = DB.to_local(rp.values)
            incs = DB.rows_like(tops.path_increments(vals), rp.values)
            x0 = DB.rows_like(vals[:, 0], rp.values) \
                if spec is not None and spec.basepoint else None
            return ops.signature(incs, depth, backend=backend,
                                 lengths=rp.lengths, transform=spec, x0=x0,
                                 precision=precision, device=vals.device)

        return cls(compute, d, max_len, device=device, **kw)

    @classmethod
    def scoring_service(cls, engine, *, max_len: int, mode: str = "scores",
                        **kw) -> "DynamicBatcher":
        """Batcher scoring requests against a
        :class:`repro_torch.serve.engine.SigScoreEngine`'s cached reference
        signatures, on the engine's device: ``mode="scores"`` returns (R,)
        kernel scores per request (the RKHS cosine if the engine
        normalises), ``"nearest"`` the argmax reference index,
        ``"predict"`` the KRR prediction from the engine's cached duals.
        Each micro-batch runs one ``ops.signature`` and one ``ops.gram``."""
        if mode not in ("scores", "nearest", "predict"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "predict" and engine.alpha is None:
            raise ValueError("scoring_service(mode='predict') needs a "
                             "SigScoreEngine constructed with targets=")
        from ..kernels import ops
        from ..sigkernel import gram_diag, krr_predict

        def compute(rp: RaggedPaths) -> torch.Tensor:
            incs = DB.rows_like(
                tops.path_increments(DB.to_local(rp.values)), rp.values)
            S = ops.signature(incs, engine.depth, backend=engine.backend,
                              lengths=rp.lengths, precision=engine.precision,
                              device=engine.device)
            K = ops.gram(S, engine.ref_sigs, engine.weights,
                         backend=engine.backend,
                         block_words=engine.block_words,
                         precision=engine.precision, device=engine.device)
            # under a mesh S and K are this rank's rows (as DTensors)
            return DB.rows_like(finish(DB.to_local(S), DB.to_local(K)), K)

        def finish(S: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
            if mode == "predict":
                return krr_predict(K, engine.alpha)
            if engine.normalize:
                qn = torch.sqrt(torch.clamp_min(gram_diag(S, engine.weights),
                                                1e-12))
                rn = torch.sqrt(torch.clamp_min(torch.diag(engine.ref_gram),
                                                1e-12))
                K = K / (qn[:, None] * rn[None, :])
            if mode == "nearest":
                return torch.argmax(K, dim=-1)
            return K

        kw.setdefault("device", engine.device)
        return cls(compute, engine.d, max_len, **kw)
