"""Gradient compression for data parallelism across ranks (port of
``repro.optim.compression``).

int8 error-feedback compression: gradients are quantised to int8 with a
per-tensor scale before the all-reduce, and the quantisation error is fed
back into the next step (EF-SGD).  Off by default; the reference declares
``TrainLoopConfig.grad_compression`` for it and does not read the field,
and neither does the port.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..distributed import collectives as C


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def int8_error_feedback_allreduce(grads: dict, error_state: dict, group=None):
    """Quantise, average over ``group``'s ranks (the reference's ``pmean``
    over an axis name) and feed the error back.  ``grads`` and
    ``error_state`` are dicts of tensors with the same keys.

    Returns (reduced fp32 grads, new error state)."""
    n = dist.get_world_size(group)
    red, new_e = {}, {}
    for k, g in grads.items():
        g32 = g.float() + error_state[k]
        q, scale = compress_int8(g32)
        deq = decompress_int8(q, scale)
        new_e[k] = g32 - deq
        red[k] = C.all_reduce_(deq.clone(), group, tag="int8_ef") / n
    return red, new_e


def init_error_state(grads: dict) -> dict:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}
