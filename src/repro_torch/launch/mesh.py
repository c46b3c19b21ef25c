"""Production meshes (the port of ``repro/launch/mesh.py``).

Single pod: 16 x 16 = 256 positions, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 positions, axes (pod, data, model) -- the pod
axis carries cross-pod data parallelism (hierarchical gradient reduction).

Without devices the mesh is abstract (shape and axis names only, as JAX's
``AbstractMesh``): what the dry run resolves its rules on.  With devices it
is a real mesh over them, row-major; no default picks devices, and nothing
falls back to the CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.distributed.mesh import (DATA_AXIS, MODEL_AXIS,
                                          MULTI_POD_SHAPE, POD_AXIS,
                                          SINGLE_POD_SHAPE, Mesh)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """The (16, 16) (data, model) mesh, or (2, 16, 16) (pod, data, model)
    with ``multi_pod``; abstract unless ``devices`` (256 or 512 of them,
    a device may repeat) are given."""
    shape = MULTI_POD_SHAPE if multi_pod else SINGLE_POD_SHAPE
    axes = ((POD_AXIS, DATA_AXIS, MODEL_AXIS) if multi_pod
            else (DATA_AXIS, MODEL_AXIS))
    return Mesh(shape, axes, devices)
