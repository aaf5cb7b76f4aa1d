"""Mesh construction over the default process group (port of
``repro.launch.mesh``).

Functions, not module constants: importing this module touches no process
group.  Each rank of the launch calls the same function (SPMD).  The
world is the default process group's (1 when none is initialised): start
one rank per card with ``torchrun --nproc-per-node=N``, or N gloo ranks on
the CPU (``torch.distributed.init_process_group("gloo", ...)``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import resolve_device


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(shape: tuple, names: tuple, device):
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialised process group: launch with "
            "torchrun --nproc-per-node=N, or call torch.distributed."
            "init_process_group first")
    n = 1
    for s in shape:
        n *= s
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(resolve_device(device).type, ranks,
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) with a
    ``"pod"`` axis: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    if _world() != need:
        raise ValueError(
            f"make_production_mesh(multi_pod={multi_pod}) needs a world of "
            f"{need} ranks but it has {_world()}: launch with torchrun "
            f"--nnodes=... --nproc-per-node=8 over {need // 8} hosts")
    return _mesh(shape, axes, device)


def make_dev_mesh(data: int = 1, model: int = 1, *, device=None):
    """Small ``("data", "model")`` mesh over the first data·model ranks.

    Validates the world size up front: a mesh larger than the world fails
    otherwise deep inside the process-group setup."""
    n = _world()
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data}, "
                         f"model={model}")
    if data * model > n:
        raise ValueError(
            f"make_dev_mesh(data={data}, model={model}) needs "
            f"{data * model} devices but only {n} are visible — launch with "
            f"torchrun --nproc-per-node={data * model} (one rank a card), "
            f"or {data * model} gloo ranks on the CPU, or shrink the mesh")
    return _mesh((data, model), ("data", "model"), device)


def make_sig_mesh(batch: int | None = None, *, device=None):
    """1-axis ``("data",)`` mesh for the signature stack: install it with
    ``sharding_ctx(make_sig_mesh())`` and every entry point in
    :mod:`repro_torch.kernels.ops` shards the "batch" logical axis over it.

    ``batch=None`` uses every rank of the world."""
    n = _world()
    if batch is None:
        batch = n
    if batch < 1:
        raise ValueError(f"batch axis must be >= 1, got {batch}")
    if batch > n:
        raise ValueError(
            f"make_sig_mesh(batch={batch}) needs {batch} devices but only "
            f"{n} are visible — launch with torchrun --nproc-per-node="
            f"{batch} (one rank a card), or {batch} gloo ranks on the CPU, "
            f"or shrink the axis")
    return _mesh((batch,), ("data",), device)
