"""Tensor and expert parallelism over a mesh's model axis (the Megatron
layout), for the dense and moe families.

The reference partitions its programs with GSPMD at the logical-axis
constraints of its model code.  The port has no partitioner: a split
model is one ``nn.Module`` a mesh position, each holding that position's
slices of the parameters, and the dense stack loops over the positions of
each block from a single controller (``models/model.py``), joining them
with the collectives of ``distributed/collectives.py``:

* attention: ``wq``/``wk``/``wv`` column-parallel over ``heads`` and
  ``kv_heads`` (each shard runs the attention of its own heads, through
  the flash kernel where the unsplit model would), ``wo`` row-parallel,
  an all-reduce after it; the KV cache split along ``kv_heads``;
* the MLP: ``w_up``/``w_gate`` column-parallel over ``mlp``, ``w_down``
  row-parallel, an all-reduce after it;
* the moe block: the experts split over ``experts``, the router
  replicated, each shard's partial combine all-reduced; the shared
  experts as the MLP;
* the embedding: the table's rows split over ``vocab``, a masked lookup
  and an all-reduce, gemma's sqrt(d) scaling after the sum; the
  unembedding: the shard's columns of the logits, the final softcap
  elementwise, an all-gather along ``vocab``.

Which axes lie on ``model`` is the rules' choice
(``distributed.sharding.resolve_rules`` on ``models.model.sharding_dims``);
a part whose axis the rules leave off the model axis is replicated and
computed whole on every position, with no collective.  The layouts this
module does not split yet -- ``kv_seq`` (context parallelism), ``head_dim``
(decode's fallback) and ``inner`` (the SSM channels), and every family but
dense and moe -- are refused (:func:`unsupported_axes`), never run
unsplit.

Pieces are keyed by mesh position ``(d, j)``: ``d`` the flat index over the
data axes (pod, data), ``j`` the model index; never by device, so a mesh
that repeats ``cuda:0`` holds one module a position.  The model axis must
be the mesh's last.  A :class:`SplitLM` may hold only some positions: the
dry run holds mesh position 0 alone, on the meta device, and the
collectives stand in for the others.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.mesh import MODEL_AXIS, Mesh, axis_size, data_axes
from repro_torch.distributed.sharding import (ShardingRules, Spec,
                                              resolve_rules)
from repro_torch.models import model as M

# the logical axes this module splits over the model axis, and those it
# does not split yet (ROADMAP Queue 1 item 10b)
SPLIT_AXES = ("heads", "kv_heads", "mlp", "experts", "vocab")
NOT_SPLIT_YET = ("kv_seq", "head_dim", "inner")
SPLIT_FAMILIES = M.ATTENTION_FAMILIES

Position = Tuple[int, int]


def on_model(rules: ShardingRules, name: str) -> bool:
    return MODEL_AXIS in rules.table.get(name, ())


def unsupported_axes(cfg: ModelConfig, rules: ShardingRules) -> List[str]:
    """The logical axes the rules put on the model axis that the port does
    not split: ``kv_seq``, ``head_dim``, ``inner``, and for a family other
    than dense and moe every axis on it."""
    bad = [n for n in NOT_SPLIT_YET if on_model(rules, n)]
    if cfg.family not in SPLIT_FAMILIES:
        bad += [n for n in SPLIT_AXES if on_model(rules, n)]
    return bad


def model_dim(spec: Spec) -> Optional[int]:
    """The dimension a physical spec puts on the model axis, if any."""
    for i, e in enumerate(spec):
        if e == MODEL_AXIS or (isinstance(e, tuple) and MODEL_AXIS in e):
            return i
    return None


def local_config(cfg: ModelConfig, rules: ShardingRules, m: int
                 ) -> ModelConfig:
    """The config a shard's attention runs under: ``n_heads / m`` and
    ``n_kv_heads / m`` where the heads lie on the model axis (the softmax
    scale stays ``1/sqrt(head_dim)``); everything else as ``cfg``."""
    if m == 1 or not on_model(rules, "heads"):
        return cfg
    a = cfg.attention
    return cfg.replace(attention=dataclasses.replace(
        a, n_heads=a.n_heads // m, n_kv_heads=a.n_kv_heads // m))


def _assign(module: nn.Module, name: str, t: torch.Tensor,
            requires_grad: bool) -> None:
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    module[leaf] = nn.Parameter(t, requires_grad=requires_grad)


class SplitLM:
    """A dense or moe model split over ``mesh``'s model axis by ``rules``:
    ``pieces[(d, j)]`` is the module of data index ``d`` and model index
    ``j`` (on that position's device; on the meta device, or the source
    model's device, for an abstract mesh).  ``cfg`` is the whole model's
    config, ``local_cfg`` the one a shard's attention runs under."""

    is_split = True

    def __init__(self, cfg: ModelConfig, mesh: Mesh, rules: ShardingRules,
                 pieces: Dict[Position, nn.Module]):
        if MODEL_AXIS in mesh.axis_names and \
                mesh.axis_names[-1] != MODEL_AXIS:
            raise ValueError(f"the model axis must be the mesh's last, got "
                             f"{mesh.axis_names}")
        extra = set(mesh.axis_names) - set(data_axes(mesh)) - {MODEL_AXIS}
        if extra:
            raise ValueError(f"a split model's mesh has data axes and a "
                             f"model axis only, got {mesh.axis_names}")
        self.cfg, self.mesh, self.rules = cfg, mesh, rules
        self.extent = axis_size(mesh, MODEL_AXIS)
        self.data_extent = math.prod(mesh.shape[a] for a in data_axes(mesh))
        self.local_cfg = local_config(cfg, rules, self.extent)
        self.specs = {k: rules.spec(ls)
                      for k, ls in M.param_logical_specs(cfg).items()}
        self.pieces = dict(sorted(pieces.items()))

    # -- layout --------------------------------------------------------------
    def on_model(self, name: str) -> bool:
        return self.extent > 1 and on_model(self.rules, name)

    def data_indices(self) -> List[int]:
        return sorted({d for d, _ in self.pieces})

    def group(self, d: int) -> List[Tuple[int, nn.Module]]:
        """Data index ``d``'s pieces, ``(j, module)`` in model order."""
        return [(j, p) for (e, j), p in self.pieces.items() if e == d]

    @property
    def complete(self) -> bool:
        return len(self.pieces) == self.data_extent * self.extent

    def device(self, d: int, j: int) -> torch.device:
        return next(self.pieces[(d, j)].parameters()).device

    def vocab_offset(self, j: int) -> Optional[int]:
        return j * (self.cfg.vocab // self.extent) \
            if self.on_model("vocab") else None

    def expert_offset(self, j: int) -> Optional[int]:
        return j * (self.cfg.moe.n_experts // self.extent) \
            if self.on_model("experts") else None

    def modules(self) -> List[nn.Module]:
        return list(self.pieces.values())

    def parameters(self) -> Iterator[nn.Parameter]:
        for p in self.pieces.values():
            yield from p.parameters()

    def requires_grad_(self, flag: bool = True) -> "SplitLM":
        for p in self.pieces.values():
            p.requires_grad_(flag)
        return self

    def clone(self) -> "SplitLM":
        """A copy sharing no storage with this model."""
        pieces = {}
        for pos, p in self.pieces.items():
            out = M.model_class(self.cfg)(self.cfg)     # on the meta device
            for k, t in p.named_parameters():
                _assign(out, k, t.detach().clone(), t.requires_grad)
            out.cfg = self.cfg
            pieces[pos] = out
        return SplitLM(self.cfg, self.mesh, self.rules, pieces)

    # -- caches --------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16
                   ) -> dict:
        """The serving cache of every position: the unsplit layout with
        the shard's ``kv_heads`` and its data index's part of ``batch``."""
        if batch % self.data_extent:
            raise ValueError(f"batch {batch} does not split over "
                             f"{self.data_extent} data positions")
        b = batch // self.data_extent
        return {"pieces": {pos: M.init_cache(self.local_cfg, b, max_seq,
                                             dtype, device=self.device(*pos))
                           for pos in self.pieces}, "index": 0}

    def gather_cache(self, cache: dict) -> dict:
        """The unsplit cache (the K/V concatenated along ``kv_heads`` over
        the model positions and along the batch over the data positions),
        on position (0, 0)'s device."""
        dev = self.device(0, 0)
        pieces = cache["pieces"]
        kv_split = self.on_model("kv_heads")

        def whole(name):
            rows = []
            for d in self.data_indices():
                parts = [pieces[(d, j)]["kv"][name].to(dev)
                         for j, _ in self.group(d)]
                rows.append(torch.cat(parts, dim=2) if kv_split
                            else parts[0])
            return torch.cat(rows, dim=1)

        names = pieces[(0, 0)]["kv"].keys()
        return {"kv": {n: whole(n) for n in names}, "index": cache["index"]}

    def gather(self) -> nn.Module:
        """The unsplit model (data index 0's pieces concatenated along each
        leaf's model dimension), on position (0, 0)'s device."""
        if len(self.group(0)) != self.extent:
            raise ValueError("gathering needs every model position")
        dev = self.device(0, 0)
        named = [dict(p.named_parameters()) for _, p in self.group(0)]
        sd = {}
        for k, t in named[0].items():
            dim = model_dim(self.specs[k]) if self.extent > 1 else None
            sd[k] = (t.detach().to(dev, copy=True) if dim is None else
                     torch.cat([n[k].detach().to(dev) for n in named], dim))
        out = M.model_class(self.cfg)(self.cfg)
        out.load_state_dict(sd, strict=True, assign=True)
        return out


def split_rules(cfg: ModelConfig, mesh: Mesh) -> ShardingRules:
    """The rules a split model is laid out by: the mesh's rules for the
    config's dimensions (the batch and sequence do not enter the model
    axes)."""
    return resolve_rules(mesh, M.sharding_dims(cfg, 0))


def all_positions(mesh: Mesh) -> List[Position]:
    m = axis_size(mesh, MODEL_AXIS)
    n = math.prod(mesh.shape[a] for a in data_axes(mesh))
    return [(d, j) for d in range(n) for j in range(m)]


def split_model(model: nn.Module, mesh: Mesh,
                rules: Optional[ShardingRules] = None, *,
                positions: Optional[Sequence[Position]] = None) -> SplitLM:
    """``model`` split over ``mesh`` (every position, or ``positions``):
    each leaf whose spec puts a dimension on the model axis is cut into
    ``m`` contiguous slices along it, slice ``j`` copied to the devices of
    model index ``j``; a leaf that nothing divides is copied whole.  On a
    mesh with devices each piece goes to its position's device; on an
    abstract mesh to ``model``'s device (on the meta device: shapes
    only).  Raises ``NotImplementedError`` for a layout the port does not
    split (:func:`unsupported_axes`)."""
    cfg = model.cfg
    rules = rules or split_rules(cfg, mesh)
    bad = unsupported_axes(cfg, rules)
    if bad:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) on {dict(mesh.shape)}: the rules put "
            f"{bad} on the model axis, which the port does not split yet "
            f"(ROADMAP Queue 1 item 10b)")
    m = axis_size(mesh, MODEL_AXIS)
    positions = list(positions or all_positions(mesh))
    named = dict(model.named_parameters())
    src_dev = next(iter(named.values())).device
    specs = {k: rules.spec(ls)
             for k, ls in M.param_logical_specs(cfg).items()}
    pieces = {}
    for d, j in positions:
        dev = src_dev if mesh.devices is None else mesh.devices[d * m + j]
        piece = M.model_class(cfg)(cfg)          # on the meta device
        for k, p in named.items():
            dim = model_dim(specs[k]) if m > 1 else None
            t = p.detach()
            if dim is not None:
                n = t.shape[dim] // m
                t = t.narrow(dim, j * n, n)
            t = (torch.empty(t.shape, dtype=t.dtype, device="meta")
                 if dev.type == "meta" else
                 t.to(dev, copy=True).contiguous())
            _assign(piece, k, t, p.requires_grad)
        piece.cfg = cfg
        pieces[(d, j)] = piece
    return SplitLM(cfg, mesh, rules, pieces)
