"""``RaggedPaths``: a batch of variable-length paths as padding + lengths.

Port of ``repro.ragged.paths``.  A zero increment is the identity Chen
update, so a batch padded with frozen tails (every point past an example's
true end repeats its last point) has exactly the per-example signatures.

- ``values``  — (B, M_max+1, d) padded path points.
- ``lengths`` — (B,) int32 true increment counts.

Every signature entry point accepts a ``RaggedPaths`` in place of a path.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..core import tensor_ops as tops
from ..core.signature import as_lengths, length_mask, mask_increments
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class RaggedPaths:
    """Padded variable-length path batch (see module docstring)."""
    values: torch.Tensor    # (B, M_max+1, d) padded points
    lengths: torch.Tensor   # (B,) int32 increments per example

    @classmethod
    def from_list(cls, paths: Sequence, pad_to: int | None = None,
                  dtype=torch.float32, device=None) -> "RaggedPaths":
        """From a list of (M_i+1, d) arrays; pads to max(M_i) (or
        ``pad_to`` increments) with frozen tails, on ``device`` (default
        CUDA)."""
        dev = resolve_device(device)
        if not len(paths):
            raise ValueError("RaggedPaths.from_list needs >= 1 path")
        arrs = [np.asarray(p) for p in paths]
        d = arrs[0].shape[-1]
        for a in arrs:
            if a.ndim != 2 or a.shape[-1] != d:
                raise ValueError(f"every path must be (M_i+1, {d}); got "
                                 f"{[tuple(a.shape) for a in arrs]}")
            if a.shape[0] < 1:
                raise ValueError("every path needs >= 1 point")
        lengths = np.asarray([a.shape[0] - 1 for a in arrs], np.int32)
        M = int(lengths.max()) if pad_to is None else int(pad_to)
        if M < lengths.max():
            raise ValueError(f"pad_to={M} < longest path ({lengths.max()} "
                             "increments)")
        out = np.empty((len(arrs), M + 1, d), np.float64)
        for i, a in enumerate(arrs):
            out[i, :a.shape[0]] = a
            out[i, a.shape[0]:] = a[-1]          # frozen tail
        return cls(torch.from_numpy(out).to(dev, dtype),
                   torch.from_numpy(lengths).to(dev))

    @classmethod
    def from_segments(cls, flat, segment_points: Sequence[int],
                      pad_to: int | None = None, dtype=torch.float32,
                      device=None) -> "RaggedPaths":
        """From a flat (Σ(M_i+1), d) concatenation and per-path point counts
        (the CSR-style spelling of request queues)."""
        flat = flat.cpu().numpy() if torch.is_tensor(flat) else \
            np.asarray(flat)
        pts = np.asarray(segment_points, np.int64)
        if pts.sum() != flat.shape[0]:
            raise ValueError(f"segment points sum to {pts.sum()} but flat "
                             f"has {flat.shape[0]} rows")
        return cls.from_list(np.split(flat, np.cumsum(pts)[:-1]),
                             pad_to=pad_to, dtype=dtype, device=device)

    @classmethod
    def from_dense(cls, values, lengths, device=None) -> "RaggedPaths":
        """From an already-padded (B, M+1, d) batch + lengths.  The tail is
        not rewritten (signature entry points mask it anyway)."""
        values = torch.as_tensor(values, device=resolve_device(device))
        if values.ndim != 3:
            raise ValueError(f"values must be (B, M+1, d), got "
                             f"{tuple(values.shape)}")
        return cls(values, as_lengths(lengths, values.shape[0],
                                      values.device))

    @property
    def batch(self) -> int:
        return self.values.shape[0]

    @property
    def max_len(self) -> int:
        """Padded increment count M_max."""
        return self.values.shape[1] - 1

    @property
    def d(self) -> int:
        return self.values.shape[-1]

    def increments(self) -> torch.Tensor:
        """(B, M_max, d) increments with the padded tail zero-masked."""
        return mask_increments(tops.path_increments(self.values),
                               self.lengths)

    def point_mask(self) -> torch.Tensor:
        """(B, M_max+1) bool: True at meaningful points (k <= lengths)."""
        return length_mask(self.lengths + 1, self.values.shape[1])

    def terminal_points(self) -> torch.Tensor:
        """(B, d) each example's true endpoint X_{L_b}."""
        idx = self.lengths.long()[:, None, None].expand(-1, 1, self.d)
        return torch.gather(self.values, 1, idx)[:, 0]

    def pad_to(self, M: int) -> "RaggedPaths":
        """Re-pad to M increments (frozen tail); same lengths."""
        if M < self.max_len:
            raise ValueError(f"pad_to({M}) below current padding "
                             f"{self.max_len}")
        if M == self.max_len:
            return self
        tail = self.values[:, -1:].expand(-1, M - self.max_len, -1)
        return RaggedPaths(torch.cat([self.values, tail], dim=1),
                           self.lengths)

    def take(self, idx) -> "RaggedPaths":
        """Row-gather."""
        idx = torch.as_tensor(idx, device=self.values.device)
        return RaggedPaths(self.values[idx], self.lengths[idx])

    def __len__(self) -> int:
        return self.batch
