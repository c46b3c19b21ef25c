"""Device meshes and logical-axis sharding rules of the port (the port of
``repro.distributed``, with the port's :class:`Mesh` in place of
``jax.sharding.Mesh``; ``sharding_context``, ``current_rules`` and
``logically_sharded`` wait for ROADMAP Queue 1 item 10)."""
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
    resolve_rules,
    tree_shardings,
)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "MULTI_POD_SHAPE", "POD_AXIS",
    "SINGLE_POD_SHAPE", "LogicalSpec", "Mesh", "ShardingRules", "axis_size",
    "data_axes", "local_mesh_for_testing", "make_mesh",
    "resolve_rules", "tree_shardings",
]
