"""Data-parallel execution over ``torch.distributed`` (port of
``repro.distributed``): the logical-axis sharding context, batch
shardings, the collectives and their accounting.

Install a mesh (:mod:`repro_torch.launch.mesh`) with :func:`sharding_ctx`
and every entry point of :mod:`repro_torch.kernels.ops` splits its batch
over the mesh's data axes: each rank runs the kernels on its own rows, the
Gram runs as a send/recv ring, and results come back as DTensors placed
``Shard(0)``.  The model-parallel half (parameter, cache and optimizer
specs, ``dryrun``) is ROADMAP.md queue 1, item 15.
"""
from .ctx import (DEFAULT_RULES, current_mesh, current_rules, logical_axes,
                  logical_axis_size, named_sharding, resolve_spec, shard,
                  sharding_ctx)
from .hlo import collective_stats

__all__ = ["DEFAULT_RULES", "current_mesh", "current_rules", "logical_axes",
           "logical_axis_size", "named_sharding", "resolve_spec", "shard",
           "sharding_ctx", "collective_stats"]
