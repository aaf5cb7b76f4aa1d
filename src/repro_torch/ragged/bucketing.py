"""Length bucketing: a bounded ladder of padded shapes.

Port of ``repro.ragged.bucketing`` (host-side numpy).  Lengths are rounded
up a geometric ladder ``min_len, min_len·g, ..., >= max_len``, so the number
of distinct shapes is O(log(max_len / min_len)) while padding waste is
bounded by the growth factor ``g``.
"""
from __future__ import annotations

import numpy as np
import torch

from .paths import RaggedPaths


def bucket_ladder(max_len: int, min_len: int = 16,
                  growth: float = 2.0) -> np.ndarray:
    """Increasing increment-count rungs covering [1, max_len]; the last rung
    is always >= ``max_len``."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    if min_len < 1:
        raise ValueError(f"min_len must be >= 1, got {min_len}")
    if growth <= 1.0:
        raise ValueError(f"growth must be > 1, got {growth}")
    rungs = [min(min_len, max_len)]
    while rungs[-1] < max_len:
        rungs.append(min(max(int(np.ceil(rungs[-1] * growth)),
                             rungs[-1] + 1), max_len))
    return np.asarray(rungs, np.int64)


def assign_buckets(lengths, ladder: np.ndarray) -> np.ndarray:
    """(N,) lengths -> (N,) index of the smallest rung >= length."""
    lengths = np.asarray(lengths, np.int64)
    ladder = np.asarray(ladder, np.int64)
    if lengths.size and lengths.max() > ladder[-1]:
        raise ValueError(f"length {lengths.max()} exceeds the ladder's top "
                         f"rung {ladder[-1]}")
    if lengths.size and lengths.min() < 0:
        raise ValueError("lengths must be >= 0")
    return np.searchsorted(ladder, lengths, side="left").astype(np.int64)


def bucket_paths(rp: RaggedPaths, ladder=None, min_len: int = 16,
                 growth: float = 2.0) -> list[tuple[np.ndarray, RaggedPaths]]:
    """Split a ragged batch into per-rung sub-batches:
    ``[(orig_indices, sub_batch), ...]``, each sub-batch cut and padded to
    its rung's increment count.  The lengths are read on the host once;
    the row gathers stay on the batch's device, so a bucket is one
    engine launch."""
    lengths = rp.lengths.cpu().numpy()
    if ladder is None:
        ladder = bucket_ladder(max(int(lengths.max()), 1), min_len=min_len,
                               growth=growth)
    ladder = np.asarray(ladder, np.int64)
    which = assign_buckets(lengths, ladder)
    out = []
    for k in range(len(ladder)):
        idx = np.nonzero(which == k)[0]
        if idx.size == 0:
            continue
        sub = rp.take(idx)
        rung = int(ladder[k])
        sub = RaggedPaths(sub.values[:, :rung + 1], sub.lengths)
        out.append((idx, sub.pad_to(rung)))
    return out


def pad_batch(rp: RaggedPaths, target_batch: int) -> RaggedPaths:
    """Pad the batch axis with zero-length dummy rows (their results are
    dropped by the caller)."""
    B = rp.batch
    if target_batch < B:
        raise ValueError(f"target batch {target_batch} < current {B}")
    if target_batch == B:
        return rp
    pad = target_batch - B
    values = torch.cat([rp.values, rp.values.new_zeros(
        (pad, *rp.values.shape[1:]))], dim=0)
    lengths = torch.cat([rp.lengths, rp.lengths.new_zeros((pad,))], dim=0)
    return RaggedPaths(values, lengths)


def batch_rung(n: int, max_batch: int) -> int:
    """Round a micro-batch size up the power-of-two ladder (capped)."""
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    return min(int(2 ** np.ceil(np.log2(n))), max_batch)
