"""Dynamic batching for ragged signature serving.

Port of ``repro.serve.batcher`` (single device, synchronous).
``DynamicBatcher`` turns per-request traffic into micro-batches drawn from a
bounded set of shapes:

1. requests are queued (:meth:`submit`) as (M_i+1, d) paths;
2. :meth:`flush` packs them into length buckets on the
   :func:`repro_torch.ragged.bucket_ladder` and pads each micro-batch's row
   count up a power-of-two ladder;
3. each micro-batch runs ONE engine call over its padded
   :class:`repro_torch.ragged.RaggedPaths` — exact per-request answers,
   because zero-masked padding is the identity;
4. results are scattered back to the submitting tickets.

``shapes_seen`` is the set of (padded_len, padded_batch) pairs fed to the
engine, and :meth:`stats` reports padding waste next to it.

The two factories bind the batcher to the serving engines:
:meth:`signature_service` computes each request's terminal signature, and
:meth:`scoring_service` scores requests against a
:class:`repro_torch.serve.engine.SigScoreEngine`'s cached references (one
``sig_trunc`` and one ``sig_gram`` launch per micro-batch on a CUDA
device).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core import tensor_ops as tops
from ..device import resolve_device
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
    callable.  Micro-batches are built on ``device`` (default CUDA).
    """
    compute: Callable[[RaggedPaths], torch.Tensor]
    d: int
    max_len: int                      # longest accepted request (increments)
    min_bucket: int = 16              # bottom rung of the length ladder
    growth: float = 2.0               # ladder growth factor
    max_batch: int = 64               # top rung of the batch ladder
    ladder: Optional[np.ndarray] = None   # explicit rungs override
    device: Optional[object] = None

    def __post_init__(self):
        if self.ladder is None:
            self.ladder = bucket_ladder(self.max_len,
                                        min_len=self.min_bucket,
                                        growth=self.growth)
        self.ladder = np.asarray(self.ladder, np.int64)
        self.max_len = int(self.ladder[-1])
        self.device = resolve_device(self.device)
        self._queue: list[_Request] = []
        self._next_ticket = 0
        self.shapes_seen: set[tuple[int, int]] = set()
        self.batches = 0              # micro-batches fed to the engine
        self.padded_steps = 0         # Σ padded increments fed to the engine
        self.true_steps = 0           # Σ true increments served
        self.padded_rows = 0          # Σ batch rows fed to the engine
        self.true_rows = 0            # Σ real requests served

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
        return t

    @property
    def pending(self) -> int:
        return len(self._queue)

    def _pack_groups(self, queue) -> list:
        """Bucket + split the queue into micro-batches
        [(rung, B_pad, part, RaggedPaths)], with shape/padding accounting
        applied."""
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
                                           pad_to=rung, device=self.device)
                B_pad = batch_rung(len(part), self.max_batch)
                self.shapes_seen.add((rung, B_pad))
                self.padded_steps += rung * B_pad
                self.true_steps += int(sum(r.length for r in part))
                self.padded_rows += B_pad
                self.true_rows += len(part)
                groups.append((rung, B_pad, part, pad_batch(rp, B_pad)))
        return groups

    def flush(self) -> dict[int, torch.Tensor]:
        """Run every queued request through bucketed micro-batches; returns
        {ticket: result_row}."""
        queue, self._queue = self._queue, []
        out: dict[int, torch.Tensor] = {}
        for _, _, part, rp in self._pack_groups(queue):
            res = self.compute(rp)
            self.batches += 1
            for row, req in enumerate(part):
                out[req.ticket] = res[row]
        return out

    def stats(self) -> dict:
        """Shape-count + padding-waste accounting for the traffic so far."""
        return {
            "compiled_shapes": len(self.shapes_seen),
            "shapes": sorted(self.shapes_seen),
            "ladder": self.ladder.tolist(),
            "batches": self.batches,
            "padded_steps": self.padded_steps,
            "true_steps": self.true_steps,
            "padding_overhead": (self.padded_steps / self.true_steps
                                 if self.true_steps else 0.0),
            "occupancy": (self.true_rows / self.padded_rows
                          if self.padded_rows else 0.0),
        }

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
            incs = tops.path_increments(rp.values)
            x0 = rp.values[:, 0] if spec is not None and spec.basepoint \
                else None
            return ops.signature(incs, depth, backend=backend,
                                 lengths=rp.lengths, transform=spec, x0=x0,
                                 precision=precision,
                                 device=rp.values.device)

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
            incs = tops.path_increments(rp.values)
            S = ops.signature(incs, engine.depth, backend=engine.backend,
                              lengths=rp.lengths, precision=engine.precision,
                              device=engine.device)
            K = ops.gram(S, engine.ref_sigs, engine.weights,
                         backend=engine.backend,
                         block_words=engine.block_words,
                         precision=engine.precision, device=engine.device)
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
