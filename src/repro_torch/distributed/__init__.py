"""Device meshes, logical-axis sharding rules and tensor parallelism of the
port (the port of ``repro.distributed``, with the port's :class:`Mesh` in
place of ``jax.sharding.Mesh``): ``mesh`` and ``sharding`` (the rules and
the context, ``sharding_context`` / ``current_rules`` /
``logically_sharded``), ``collectives`` (all-reduce, all-gather and
reduce-scatter over one axis's pieces, from a single controller) and
``tensor_parallel`` (a dense or moe model split over the model axis)."""
from repro_torch.distributed.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    MULTI_POD_SHAPE,
    POD_AXIS,
    SINGLE_POD_SHAPE,
    Mesh,
    axis_size,
    data_axes,
    local_mesh_for_testing,
    make_mesh,
)
from repro_torch.distributed.sharding import (
    LogicalSpec,
    ShardingRules,
    current_rules,
    logically_sharded,
    resolve_rules,
    sharding_context,
    tree_shardings,
)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "MULTI_POD_SHAPE", "POD_AXIS",
    "SINGLE_POD_SHAPE", "LogicalSpec", "Mesh", "ShardingRules", "axis_size",
    "current_rules", "data_axes", "local_mesh_for_testing",
    "logically_sharded", "make_mesh", "resolve_rules", "sharding_context",
    "tree_shardings",
]
