"""Mesh axis conventions (the port of ``repro/distributed/mesh.py``).

Physical axes:
    pod    -- across pods (multi-pod only); DP across pods
    data   -- intra-pod data parallelism (+ ZeRO-1 optimizer sharding)
    model  -- tensor parallelism (heads / mlp / experts / vocab)

Logical axes used by model code (resolved via distributed.sharding rules):
    batch, seq, kv_seq, embed, heads, kv_heads, head_dim, mlp, vocab,
    experts, layers, state, conv, inner, cell

A :class:`Mesh` is a shape over named axes and, unless it is abstract, a
row-major sequence of ``torch.device``s, one a position.  A device may
stand at several positions: a mesh of ``cuda:0`` four times splits work
four ways on one card (the tests and the one-card checks build such
meshes; no default does).  An abstract mesh (no devices, as JAX's
``AbstractMesh``) is enough for the rule tables.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

POD_AXIS = "pod"
DATA_AXIS = "data"
MODEL_AXIS = "model"

SINGLE_POD_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


class Mesh:
    """Named axes of given sizes over ``devices`` (row-major; ``None`` for
    an abstract mesh)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 devices: Optional[Sequence] = None):
        shape, axes = tuple(int(n) for n in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} must pair "
                             f"up, with distinct axis names")
        if any(n < 1 for n in shape):
            raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
        self.axis_names: Tuple[str, ...] = axes
        self.shape: Dict[str, int] = OrderedDict(zip(axes, shape))
        self.devices: Optional[Tuple[torch.device, ...]] = None
        if devices is not None:
            devs = tuple(torch.device(d) for d in devices)
            if len(devs) != self.size:
                raise ValueError(f"a {shape} mesh needs {self.size} devices, "
                                 f"got {len(devs)}")
            self.devices = devs

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def devices_along(self, axes: Sequence[str]) -> List[torch.device]:
        """The device at every position of ``axes`` (row-major, in the
        mesh's axis order), every other axis at its first position."""
        if self.devices is None:
            raise ValueError("an abstract mesh has no devices")
        flat = [0]
        for a in self.axis_names:
            n = self.shape[a] if a in axes else 1
            flat = [f * self.shape[a] + i for f in flat for i in range(n)]
        return [self.devices[f] for f in flat]

    def __repr__(self) -> str:
        devs = "abstract" if self.devices is None else \
            ", ".join(str(d) for d in self.devices)
        return f"Mesh({dict(self.shape)}, {devs})"


def _cuda_devices(n: Optional[int]) -> Tuple[torch.device, ...]:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n is None else int(n)
    if have == 0:
        raise RuntimeError("no CUDA device is available; pass the devices "
                           "explicitly (devices=['cpu', ...]) to build a "
                           "mesh on the CPU")
    if not 1 <= n <= have:
        raise ValueError(f"asked for {n} CUDA devices, {have} present")
    return tuple(torch.device("cuda", i) for i in range(n))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices``, or over the first ``prod(shape)`` CUDA
    devices (raises without enough cards; never falls back to the CPU)."""
    if devices is None:
        devices = _cuda_devices(math.prod(int(n) for n in shape))
    return Mesh(shape, axes, devices)


def data_axes(mesh: Mesh) -> tuple:
    """The axes batch shards over (pod+data when present)."""
    return tuple(a for a in (POD_AXIS, DATA_AXIS) if a in mesh.axis_names)


def axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def local_mesh_for_testing(n_devices: Optional[int] = None) -> Mesh:
    """A (1, n) mesh over the local CUDA devices."""
    devs = _cuda_devices(n_devices)
    return Mesh((1, len(devs)), (DATA_AXIS, MODEL_AXIS), devs)


def cell_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A 1-D data mesh for sharding simulation cell batches, over every
    CUDA device (or the first ``n_devices``); raises without a card.

    ``sim/engine.py`` resolves its ``cell`` logical axis against this
    (``run_cells(mesh=...)``; the ``"auto"`` default builds one over every
    card when more than one is present).
    """
    devs = _cuda_devices(n_devices)
    return Mesh((len(devs),), (DATA_AXIS,), devs)
