"""Logical-axis sharding rules (MaxText-style) with divisibility fallbacks
(the port of ``repro/distributed/sharding.py``).

Model code names each tensor dimension by a *logical* axis; a rule table
maps each logical axis to zero or more physical mesh axes.  Rules are
resolved per (config, mesh) at setup time: each logical axis has a
priority list of physical candidates and is only mapped when the
dimension size is known to divide the physical axis size.

The rules implement the distribution plan of DESIGN.md Sec 5:
    batch        -> (pod, data)       DP
    heads/kv/mlp/experts/vocab -> model   TP / EP
    head_dim     -> model             fallback TP when head counts don't divide
    kv_seq       -> data              sequence-sharded KV cache for long decode
    cell         -> (pod, data)       the engine's cell batch
    (ZeRO-1: optimizer state additionally sharded over data --
    train/optimizer.py)

A physical spec is a plain tuple, one entry a dimension: ``None``, one
axis name, or a tuple of names (what ``jax.sharding.PartitionSpec``
holds).

Inside model code the rules apply through a context, as in the
reference: :func:`sharding_context` makes a mesh and its rules current
(the split model's forward enters it, ``distributed/tensor_parallel.py``),
and :func:`logically_sharded` names a tensor's dimensions by logical axes.
The port has no partitioner to hand a constraint to, so inside a context
it checks the tensor instead: every dimension whose logical axis the rules
put on the ``model`` axis must hold the global size (carried by the rules
from ``sharding_dims``) divided by the model extent, and a shard that
holds the whole tensor raises.  ``inner`` is the exception: its entry in
``dims`` is the gcd of the SSM's channel counts (in_proj's outputs, the
conv's channels, d_inner), not a size, so it cannot judge a dimension;
the mixer's shard checks its widths against ``ssm_dims`` / m itself
(``models.ssm.apply_mamba2_shard``).  Outside a context it is a no-op, as
in JAX.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.distributed.mesh import (DATA_AXIS, MODEL_AXIS, POD_AXIS,
                                          Mesh, axis_size)

LogicalSpec = Tuple[Optional[str], ...]
# logical axes whose ``dims`` entry is a gcd of several sizes, not a size
GCD_AXES = ("inner",)
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


@dataclass(frozen=True)
class ShardingRules:
    """Mapping logical axis name -> tuple of physical mesh axes (or ());
    ``dims``: the global sizes the table was resolved for (not compared)."""

    table: Dict[str, Tuple[str, ...]]
    dims: Dict[str, int] = field(default_factory=dict, compare=False)

    def physical(self, logical: Optional[str]) -> Optional[Tuple[str, ...]]:
        if logical is None:
            return None
        axes = self.table.get(logical, ())
        return tuple(axes) if axes else None

    def spec(self, logical_spec: LogicalSpec) -> Spec:
        parts = []
        used: set = set()
        for name in logical_spec:
            phys = self.physical(name)
            if phys is None:
                parts.append(None)
            else:
                # A physical axis may appear at most once in a spec.
                phys = tuple(a for a in phys if a not in used)
                used.update(phys)
                parts.append(phys if len(phys) > 1 else (phys[0] if phys else None))
        return tuple(parts)


def _fits(dim: Optional[int], mesh: Mesh, axes: Sequence[str]) -> bool:
    if dim is None:
        return False
    size = 1
    for a in axes:
        if a not in mesh.axis_names:
            return False
        size *= mesh.shape[a]
    return dim % size == 0 and dim >= size


def resolve_rules(mesh: Mesh, dims: Dict[str, int]) -> ShardingRules:
    """Build the rule table for a given mesh and model dimension sizes.

    ``dims`` supplies the logical dimension sizes used for divisibility
    checks, e.g. {"batch": 256, "heads": 32, "kv_heads": 16, "head_dim": 128,
    "mlp": 36864, "vocab": 256000, "experts": 64, "embed": 4608, "seq": 4096}
    (``models.model.sharding_dims``), or {"cell": B} for the engine.
    """
    dp_axes = tuple(a for a in (POD_AXIS, DATA_AXIS) if a in mesh.axis_names)
    tp = (MODEL_AXIS,) if MODEL_AXIS in mesh.axis_names else ()
    table: Dict[str, Tuple[str, ...]] = {}

    # --- data parallel axes -------------------------------------------------
    if _fits(dims.get("batch"), mesh, dp_axes):
        table["batch"] = dp_axes
    elif DATA_AXIS in mesh.axis_names and _fits(dims.get("batch"), mesh, (DATA_AXIS,)):
        table["batch"] = (DATA_AXIS,)
    else:
        table["batch"] = ()

    # --- tensor parallel: attention ------------------------------------------
    heads_on_model = bool(tp) and _fits(dims.get("heads"), mesh, tp)
    kv_on_model = bool(tp) and _fits(dims.get("kv_heads"), mesh, tp)
    # Shard heads only when BOTH q-heads and kv-heads divide (so that the
    # whole attention block partitions on the same axis without resharding).
    table["q_seq"] = ()
    attn_kv_seq_tp = False
    if heads_on_model and kv_on_model:
        table["heads"] = tp
        table["kv_heads"] = tp
        table["head_dim"] = ()
    elif bool(tp) and dims.get("q_seq", 0) > 1 and _fits(dims.get("kv_seq"), mesh, tp):
        # Key/value-sequence context parallelism when the head counts do not
        # divide the model axis (starcoder2 kv=2, qwen2-vl kv=4, whisper
        # 20H): the KV sequence shards over 'model' for train/prefill.
        table["heads"] = ()
        table["kv_heads"] = ()
        table["head_dim"] = ()
        attn_kv_seq_tp = True
    elif bool(tp) and _fits(dims.get("head_dim"), mesh, tp):
        # Fallback TP on the head_dim (contracting) dimension (decode: the
        # single-query step has no sequence to shard; partials are tiny).
        table["heads"] = ()
        table["kv_heads"] = ()
        table["head_dim"] = tp
    else:
        table["heads"] = table["kv_heads"] = table["head_dim"] = ()

    # --- tensor parallel: mlp / experts / vocab -------------------------------
    table["mlp"] = tp if (tp and _fits(dims.get("mlp"), mesh, tp)) else ()
    table["experts"] = tp if (tp and _fits(dims.get("experts"), mesh, tp)) else ()
    table["vocab"] = tp if (tp and _fits(dims.get("vocab"), mesh, tp)) else ()
    table["state"] = ()
    # SSM: shard the (expanded) inner channel dim over model.
    table["inner"] = tp if (tp and _fits(dims.get("inner"), mesh, tp)) else ()

    # --- sequence ------------------------------------------------------------
    # Activations keep seq unsharded by default (fully utilized batch DP);
    # long-context decode shards the KV/state cache sequence over data when
    # the batch cannot use it (batch=1).
    table["seq"] = ()
    if attn_kv_seq_tp:
        table["kv_seq"] = tp
    elif not table["batch"] and DATA_AXIS in mesh.axis_names and _fits(dims.get("kv_seq"), mesh, (DATA_AXIS,)):
        table["kv_seq"] = (DATA_AXIS,)
    else:
        table["kv_seq"] = ()

    table["embed"] = ()
    table["layers"] = ()
    table["conv"] = ()

    # --- simulation cell batch (sim/engine.py) -------------------------------
    # Cells are embarrassingly parallel, so the cell axis takes every
    # data-parallel device it divides: (pod, data) -> (data,) -> replicated.
    if _fits(dims.get("cell"), mesh, dp_axes):
        table["cell"] = dp_axes
    elif (DATA_AXIS in mesh.axis_names
          and _fits(dims.get("cell"), mesh, (DATA_AXIS,))):
        table["cell"] = (DATA_AXIS,)
    else:
        table["cell"] = ()
    return ShardingRules(table=table,
                         dims={k: int(v) for k, v in dims.items() if v})


# --------------------------------------------------------------------------- #
# Context: model code calls logically_sharded(x, (..names..)), a check of a
# shard's local shape when a mesh+rules context is active, else a no-op.
# --------------------------------------------------------------------------- #

class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Optional[ShardingRules] = None


_CTX = _Ctx()


@contextmanager
def sharding_context(mesh: Mesh, rules: ShardingRules):
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_rules() -> Optional[ShardingRules]:
    return _CTX.rules


def logically_sharded(x: torch.Tensor, logical_spec: LogicalSpec
                      ) -> torch.Tensor:
    """``x`` itself.  Inside a context, raise unless each dimension whose
    logical axis the rules put on the model axis holds the global size
    divided by the model extent (a whole tensor where a shard belongs)."""
    if _CTX.mesh is None or _CTX.rules is None:
        return x
    m = axis_size(_CTX.mesh, MODEL_AXIS)
    if len(logical_spec) != x.dim():
        raise ValueError(f"logical spec {logical_spec} for a tensor of "
                         f"rank {x.dim()}")
    for i, name in enumerate(logical_spec):
        if name is None or name in GCD_AXES or \
                MODEL_AXIS not in _CTX.rules.table.get(name, ()):
            continue
        whole = _CTX.rules.dims.get(name)
        if whole and x.shape[i] != whole // m:
            raise ValueError(
                f"dimension {i} ({name!r}) of {tuple(x.shape)} holds "
                f"{x.shape[i]}; the rules put {name!r} on the model axis, "
                f"so a shard holds {whole} / {m} = {whole // m}")
    return x


def _is_spec(x: Any) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_shardings(mesh: Mesh, rules: ShardingRules, logical_tree) -> Any:
    """Map a tree (nested dicts, lists, tuples) of LogicalSpec tuples to
    their physical specs on ``mesh``; a spec naming an axis the mesh lacks
    raises."""
    if _is_spec(logical_tree):
        spec = rules.spec(logical_tree)
        for part in spec:
            for a in (part if isinstance(part, tuple) else (part,)):
                if a is not None and a not in mesh.axis_names:
                    raise ValueError(f"axis {a!r} of {spec} is not in {mesh}")
        return spec
    if isinstance(logical_tree, dict):
        return {k: tree_shardings(mesh, rules, v)
                for k, v in logical_tree.items()}
    if isinstance(logical_tree, (list, tuple)):
        return type(logical_tree)(tree_shardings(mesh, rules, v)
                                  for v in logical_tree)
    raise TypeError(f"not a logical spec or a tree of them: "
                    f"{logical_tree!r}")
