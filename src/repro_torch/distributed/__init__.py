"""Data, tensor, expert and FSDP parallelism over ``torch.distributed``
(port of ``repro.distributed``): the logical-axis sharding context, the
parameter, cache, optimizer-state and batch shardings, their execution,
the collectives and their accounting.

Install a mesh (:mod:`repro_torch.launch.mesh`) with :func:`sharding_ctx`
and every entry point of :mod:`repro_torch.kernels.ops` splits its batch
over the mesh's data axes: each rank runs the kernels on its own rows, the
Gram runs as a send/recv ring, and results come back as DTensors placed
``Shard(0)``.  On a ``("data", "model")`` mesh,
:func:`repro_torch.distributed.model_parallel.shard_model` lays a model
out by :func:`repro_torch.distributed.sharding.param_specs` and its layers
run tensor-, expert- and FSDP-parallel.  ``launch/specs.py`` and
``dryrun`` are ROADMAP.md queue 1.
"""
from .ctx import (DEFAULT_RULES, current_mesh, current_rules, logical_axes,
                  logical_axis_size, named_sharding, resolve_spec, shard,
                  sharding_ctx)
from .hlo import collective_stats

__all__ = ["DEFAULT_RULES", "current_mesh", "current_rules", "logical_axes",
           "logical_axis_size", "named_sharding", "resolve_spec", "shard",
           "sharding_ctx", "collective_stats"]
