"""Tensor and expert parallelism over a mesh's model axis (the Megatron
layout, context parallelism and the head_dim split), for every family.

The reference partitions its programs with GSPMD at the logical-axis
constraints of its model code.  The port has no partitioner: a split
model is one ``nn.Module`` a mesh position, each holding that position's
slices of the parameters, and the split stacks loop over the positions of
each block from a single controller (``models/model.py``), joining them
with the collectives of ``distributed/collectives.py``:

* attention: ``wq``/``wk``/``wv`` column-parallel over ``heads`` and
  ``kv_heads`` (each shard runs the attention of its own heads, through
  the flash kernel where the unsplit model would), ``wo`` row-parallel,
  an all-reduce after it; the KV cache split along ``kv_heads``.  Where
  the heads do not divide the axis the rules put ``kv_seq`` there for a
  call of several queries (context parallelism: each position computes
  every query and its part of the keys, the parts' softmax statistics
  combined; the KV cache along the sequence in parts of ``max_seq / m``)
  and ``head_dim`` for a decode step (each shard's channels of every
  head, the partial scores and ``wo``'s partial outputs all-reduced; the
  KV cache along ``head_dim``): ``models/parallel_attention.py``;
* the encdec family: the encoder's blocks and the decoder's
  self-attention as the dense family's, the cross-attention by the same
  layout (its K/V cache along ``kv_heads`` or ``head_dim``, whole under
  ``kv_seq``), the frames whole on every position;
* the MLP: ``w_up``/``w_gate`` column-parallel over ``mlp``, ``w_down``
  row-parallel, an all-reduce after it;
* the moe block: the experts split over ``experts``, the router
  replicated, each shard's partial combine all-reduced; the shared
  experts as the MLP;
* the Mamba2 mixer over ``inner``, head-aligned (:class:`LeafLayout`):
  GSPMD's contiguous cut of ``in_proj``'s ``[z, x, B, C, dt]`` columns
  would not fall on their boundaries, so shard ``j`` holds z's, x's and
  dt's columns of its heads and B's and C's whole, the conv its x
  channels and B's and C's, ``norm_scale`` and ``out_proj`` its channels;
  the gated RMSNorm's sum of squares is all-reduced, ``out_proj`` is
  row-parallel with an all-reduce after it; the SSM cache split by heads;
* the embedding: the table's rows split over ``vocab``, a masked lookup
  and an all-reduce, gemma's sqrt(d) scaling after the sum; the
  unembedding: the shard's columns of the logits, the final softcap
  elementwise, an all-gather along ``vocab``.

Which axes lie on ``model`` is the rules' choice
(``distributed.sharding.resolve_rules`` on ``models.model.sharding_dims``);
a part whose axis the rules leave off the model axis is replicated and
computed whole on every position, with no collective.  Where the rules
put nothing of the model on the model axis (mamba2-130m at 16) every
model position is a replica running the unsplit program on its rows.
Where the batch does not split over the data positions (a batch of 1),
every data position runs all of it; the hybrid family's KV cache may then
lie along the sequence over the data positions (``kv_seq`` on ``data``),
decode's attention combining their partial softmaxes.  The one layout
whose axis a tensor of the cell carries and this module does not split --
``kv_seq`` on the data axis outside the hybrid family -- is refused
(:func:`unsupported_axes`), never run unsplit.  The rules a split model
is laid out by are the caller's: ``split_model(model, mesh, rules)``;
by default :func:`split_rules`, which see no sequence and so choose
``head_dim`` where the heads do not divide.  A server whose prefill
and decode cells resolve different rules carries its cache across by
:meth:`SplitLM.gather_cache` and :meth:`SplitLM.split_cache`.

Pieces are keyed by mesh position ``(d, j)``: ``d`` the flat index over the
data axes (pod, data), ``j`` the model index; never by device, so a mesh
that repeats ``cuda:0`` holds one module a position.  The model axis must
be the mesh's last.  A :class:`SplitLM` may hold only some positions: the
dry run holds mesh position 0 alone, on the meta device, and the
collectives stand in for the others.  A :class:`LeafLayout`'s ``cut``
and ``join`` carry every leaf between the unsplit layout and the pieces
(the split model, its gradients, its optimizer state and its checkpoint
image).
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Dict, Iterator, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                          axis_size, data_axes)
from repro_torch.distributed.sharding import (ShardingRules, Spec,
                                              resolve_rules)
from repro_torch.launch import cost_analysis as CA
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import parallel_attention as PA
from repro_torch.models import ssm as SSM

# the families whose KV cache may lie along the sequence over the data axis
# (elsewhere refused: ROADMAP Queue 1, what stays refused)
KV_SEQ_ON_DATA_FAMILIES = ("hybrid",)

Position = Tuple[int, int]


def on_model(rules: ShardingRules, name: str) -> bool:
    return MODEL_AXIS in rules.table.get(name, ())


def on_data(rules: ShardingRules, name: str) -> bool:
    return DATA_AXIS in rules.table.get(name, ())


def _spec_names(tree) -> set:
    if isinstance(tree, dict):
        return set().union(*(_spec_names(v) for v in tree.values())) \
            if tree else set()
    return set(tree)


def carried_axes(cfg: ModelConfig) -> set:
    """The logical axes a tensor of ``cfg``'s cells carries: its
    parameters' (``param_logical_specs``), its serving cache's
    (``cache_logical_specs``), and for a family with attention the
    attention's ``kv_seq`` and ``head_dim``."""
    names = _spec_names(M.param_logical_specs(cfg))
    names |= _spec_names(M.cache_logical_specs(cfg))
    if cfg.family != "ssm":
        names |= {"kv_seq", "head_dim"}
    return names - {None}


def unsupported_axes(cfg: ModelConfig, rules: ShardingRules) -> List[str]:
    """The logical axes of a layout the port does not split, where a
    tensor of the cell carries them (:func:`carried_axes`): ``kv_seq`` on
    the data axis outside the hybrid family (a dense, moe or encdec cell
    at a batch that does not split over the data positions).  Every
    family splits every axis the rules put on the model axis."""
    if on_data(rules, "kv_seq") and "kv_seq" in carried_axes(cfg) \
            and cfg.family not in KV_SEQ_ON_DATA_FAMILIES:
        return ["kv_seq"]
    return []


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
    scale stays ``1/sqrt(head_dim)``); ``head_dim / m`` where ``head_dim``
    does, with the whole head's softmax scale (``query_scale``, or
    ``1/sqrt(head_dim)`` of the whole head, set as ``query_scale``);
    everything else as ``cfg``."""
    a = cfg.attention
    if m > 1 and on_model(rules, "heads"):
        return cfg.replace(attention=dataclasses.replace(
            a, n_heads=a.n_heads // m, n_kv_heads=a.n_kv_heads // m))
    if m > 1 and on_model(rules, "head_dim"):
        return cfg.replace(attention=dataclasses.replace(
            a, head_dim=a.head_dim // m, query_scale=L.query_scale(cfg)))
    return cfg


# --------------------------------------------------------------------------- #
# One layout for every leaf: the unsplit leaf <-> its model pieces
# --------------------------------------------------------------------------- #

class LeafLayout(NamedTuple):
    """How a leaf lies over ``m`` model positions.  ``dim`` None: whole on
    every position.  Else the leaf is, along ``dim``, the concatenation of
    ``segments`` (their sizes, in the unsplit order), each either cut into
    ``m`` contiguous parts (``split``) or held whole by every piece; a
    piece holds its part of each segment in the order ``order``."""

    dim: Optional[int]
    m: int = 1
    segments: Tuple[Tuple[int, bool], ...] = ()
    order: Tuple[int, ...] = ()

    def _piece_sizes(self) -> List[int]:
        return [n // self.m if split else n for n, split in self.segments]

    def cut(self, whole: torch.Tensor) -> List[torch.Tensor]:
        """The ``m`` pieces of ``whole`` (views where a piece is one
        contiguous slice, else new tensors)."""
        if self.dim is None:
            return [whole] * self.m
        offs = [0]
        for n, _ in self.segments:
            offs.append(offs[-1] + n)
        out = []
        for j in range(self.m):
            parts = []
            for i in self.order:
                n, split = self.segments[i]
                part = whole.narrow(self.dim, offs[i], n)
                if split:
                    part = part.narrow(self.dim, j * (n // self.m),
                                       n // self.m)
                parts.append(part)
            out.append(parts[0] if len(parts) == 1
                       else torch.cat(parts, dim=self.dim))
        return out

    def piece_size(self) -> int:
        """A piece's length along ``dim``."""
        return sum(self._piece_sizes())

    def shared(self) -> List[Tuple[int, int]]:
        """(offset, length) along ``dim`` of each whole segment within a
        piece: the part every piece holds the same."""
        sizes = self._piece_sizes()
        out, off = [], 0
        for i in self.order:
            if not self.segments[i][1]:
                if out and out[-1][0] + out[-1][1] == off:     # adjacent
                    out[-1] = (out[-1][0], out[-1][1] + sizes[i])
                else:
                    out.append((off, sizes[i]))
            off += sizes[i]
        return out

    def join(self, pieces: Sequence[torch.Tensor]) -> torch.Tensor:
        """The unsplit leaf from one piece a model position (on the first
        piece's device); a whole segment is taken from the first piece
        after a check that every piece holds it to the bit."""
        dev = pieces[0].device
        if self.dim is None:
            return pieces[0]
        sizes = self._piece_sizes()
        where, off = {}, 0
        for i in self.order:
            where[i] = off
            off += sizes[i]
        parts = []
        for i, (n, split) in enumerate(self.segments):
            got = [p.narrow(self.dim, where[i], sizes[i]) for p in pieces]
            if split:
                parts.append(torch.cat([g.to(dev) for g in got],
                                       dim=self.dim))
                continue
            if any(not torch.equal(g.to(dev), got[0]) for g in got[1:]):
                raise ValueError("the model pieces of a replicated segment "
                                 "differ")
            parts.append(got[0])
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=self.dim)


# in_proj's and the conv's segments, in the unsplit order: (name, split)
_IN_PROJ = (("z", True), ("x", True), ("B", False), ("C", False),
            ("dt", True))
_IN_PROJ_ORDER = (0, 1, 4, 2, 3)            # a piece: z, x, dt, B, C
_CONV = (("x", True), ("B", False), ("C", False))


def leaf_layouts(cfg: ModelConfig, rules: ShardingRules, m: int
                 ) -> Dict[str, LeafLayout]:
    """Every parameter's :class:`LeafLayout` over ``m`` model positions by
    ``rules``: a contiguous cut along the dimension its spec puts on the
    model axis, the Mamba2 mixer's ``in_proj`` and conv head-aligned
    (their B and C whole on every piece), whole where nothing is on the
    model axis.  Raises ValueError where the SSM heads do not divide."""
    logical = M.param_logical_specs(cfg)
    shapes = {k: tuple(p.shape) for k, p in
              M.model_class(cfg)(cfg).named_parameters()}
    out = {}
    for k, ls in logical.items():
        dim = model_dim(rules.spec(ls)) if m > 1 else None
        if dim is None:
            out[k] = LeafLayout(None, m)
            continue
        leaf = k.rsplit(".", 1)[-1]
        if ls[dim] == "inner":
            SSM.shard_dims(cfg, m)                      # the heads divide
        if ls[dim] == "inner" and leaf in ("in_proj", "conv_w", "conv_b"):
            d_inner, nheads, _ = SSM.ssm_dims(cfg)
            n = cfg.ssm.d_state
            size = dict(z=d_inner, x=d_inner, B=n, C=n, dt=nheads)
            segs, order = ((_IN_PROJ, _IN_PROJ_ORDER) if leaf == "in_proj"
                           else (_CONV, (0, 1, 2)))
            out[k] = LeafLayout(dim, m, tuple((size[s], sp)
                                              for s, sp in segs), order)
            continue
        n = shapes[k][dim]
        if n % m:
            raise ValueError(f"{k}: dim {dim} of {shapes[k]} does not "
                             f"split {m} ways")
        out[k] = LeafLayout(dim, m, ((n, True),), (0,))
    return out


def _assign(module: nn.Module, name: str, t: torch.Tensor,
            requires_grad: bool) -> None:
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    if isinstance(module, nn.ParameterDict):
        module[leaf] = nn.Parameter(t, requires_grad=requires_grad)
    else:
        setattr(module, leaf, nn.Parameter(t, requires_grad=requires_grad))


def _fits(n: int, parts: int) -> bool:
    """Whether ``n`` rows split over ``parts`` positions (the rules'
    test: a multiple, and at least one row a position)."""
    return n % parts == 0 and n >= parts


class SplitLM:
    """A model split over ``mesh``'s model axis by ``rules``:
    ``pieces[(d, j)]`` is the module of data index ``d`` and model index
    ``j`` (on that position's device; on the meta device, or the source
    model's device, for an abstract mesh).  ``cfg`` is the whole model's
    config, ``local_cfg`` the one a shard's attention runs under;
    ``layouts`` each leaf's :class:`LeafLayout`."""

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
        self.layouts = leaf_layouts(cfg, rules, self.extent)
        self.pieces = dict(sorted(pieces.items()))

    # -- layout --------------------------------------------------------------
    def on_model(self, name: str) -> bool:
        return self.extent > 1 and on_model(self.rules, name)

    @property
    def replicas(self) -> bool:
        """Whether the model positions are replicas: the rules put nothing
        of the model on the model axis (or there is one position), so each
        runs the unsplit program and no collective crosses the axis."""
        return all(lay.dim is None for lay in self.layouts.values())

    @property
    def attn_layout(self) -> str:
        """How attention lies over the model axis: ``"heads"`` (each shard
        its heads), ``"kv_seq"`` (context parallelism), ``"head_dim"``
        (each shard its channels of every head) or ``"whole"`` (every
        head on every position)."""
        for name in ("heads", "kv_seq", "head_dim"):
            if self.on_model(name):
                return name
        return "whole"

    @property
    def ssm_split(self) -> bool:
        """Whether the Mamba2 mixers are split over their heads."""
        return self.cfg.ssm is not None and self.on_model("inner")

    def batch_split(self, batch: int) -> bool:
        """Whether a batch of ``batch`` rows splits over the data
        positions; else every data position runs all of it."""
        return _fits(batch, self.data_extent)

    def seq_split(self, batch: int, max_seq: int) -> bool:
        """Whether a serving cache of ``batch`` rows and ``max_seq``
        positions holds its K/V along the sequence over the data
        positions: the hybrid family, a batch that does not split, and
        the rules' ``kv_seq`` on ``data`` for those sizes."""
        if self.data_extent == 1 or self.batch_split(batch) or \
                self.cfg.family not in KV_SEQ_ON_DATA_FAMILIES:
            return False
        rules = resolve_rules(self.mesh, M.sharding_dims(
            self.cfg, batch, kv_seq=max_seq, q_seq=1))
        return on_data(rules, "kv_seq")

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
    def _kv_parts(self, max_seq: int) -> int:
        """The sequence parts a K/V cache of ``max_seq`` lies in over the
        model axis: the extent under ``kv_seq`` (raises where it does not
        divide ``max_seq``), else 1."""
        if self.attn_layout != "kv_seq":
            return 1
        if max_seq % self.extent:
            raise ValueError(f"{max_seq} positions do not split over "
                             f"{self.extent} model positions (kv_seq)")
        return self.extent

    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16
                   ) -> dict:
        """The serving cache of every position: the unsplit layout with
        the shard's ``kv_heads`` or ``head_dim`` channels, its part of the
        sequence (``kv_seq``: ``max_seq / m`` slots), its SSM heads and
        conv channels (:func:`models.ssm.init_ssm_cache` of its shard),
        and its data index's part of ``batch`` -- or all of it where the
        batch does not split, the K/V then along the sequence over the
        data positions where :meth:`seq_split` says so (``"seq_parts"``).
        The encdec family's cross K/V as its self K/V, over the whole
        ``enc_seq``.  The ``kv_seq`` and ``head_dim`` layouts refuse an
        int8 cache (ValueError)."""
        n = self.data_extent
        b = batch // n if self.batch_split(batch) else batch
        parts = axis_size(self.mesh, DATA_AXIS) \
            if self.seq_split(batch, max_seq) else 1
        if max_seq % parts:
            raise ValueError(f"{max_seq} positions do not split over {parts} "
                             f"data positions")
        cfg = self.local_cfg
        if self.attn_layout in ("kv_seq", "head_dim"):
            PA.refuse_int8(cfg, self.attn_layout)
        seq = max_seq // parts // self._kv_parts(max_seq)
        n_kv = {"dense": cfg.n_layers, "moe": cfg.n_layers, "encdec":
                cfg.n_layers, "hybrid":
                cfg.n_layers // max(cfg.shared_attn_every, 1)}
        out = {}
        for pos in self.pieces:
            dev = self.device(*pos)
            c = {}
            if cfg.family in n_kv:
                c["kv"] = M.init_kv_cache(cfg, n_kv[cfg.family], b, seq,
                                          dtype, dev)
            if cfg.family == "encdec":
                a = cfg.attention
                shape = (cfg.n_layers, b, a.n_kv_heads, cfg.enc_seq,
                         a.head_dim)
                for name in ("cross_k", "cross_v"):
                    c[name] = torch.zeros(shape, dtype=dtype, device=dev)
            if cfg.ssm is not None:
                one = SSM.init_ssm_cache(
                    cfg, b, device=dev,
                    n_shards=self.extent if self.ssm_split else 1)
                c["ssm"] = {k: v[None].repeat(cfg.n_layers,
                                              *([1] * v.dim()))
                            for k, v in one.items()}
            out[pos] = c
        return {"pieces": out, "index": 0, "seq_parts": parts,
                "batch_parts": n if self.batch_split(batch) else 1}

    @staticmethod
    def _data_join(rows: List[torch.Tensor], cache: dict,
                   seq_dim: Optional[int]) -> torch.Tensor:
        """One cache leaf from each data index's part: along the sequence
        where the cache lies so, along the batch where it splits, else
        data index 0's after a check that every data index holds it to
        the bit."""
        if cache["seq_parts"] > 1 and seq_dim is not None:
            return torch.cat(rows, dim=seq_dim)
        if cache["batch_parts"] > 1:
            return torch.cat(rows, dim=1)
        if any(not torch.equal(r, rows[0]) for r in rows[1:]):
            raise ValueError("the data positions' replicated caches differ")
        return rows[0]

    def _kv_model_dim(self, cross: bool = False) -> Optional[int]:
        """The dimension of a (L, B, G, S, hd) K/V cache leaf the model
        positions split: ``kv_heads`` 2, ``kv_seq`` 3 (not the cross
        K/V's), ``head_dim`` 4; None where every position holds it
        whole."""
        dims = {"heads": 2, "kv_seq": None if cross else 3, "head_dim": 4}
        return dims.get(self.attn_layout)

    def _conv_dis(self) -> int:
        """The x channels of a shard's conv carry."""
        d_inner = SSM.ssm_dims(self.cfg)[0]
        return d_inner // self.extent if self.ssm_split else d_inner

    def gather_cache(self, cache: dict) -> dict:
        """The unsplit cache, on position (0, 0)'s device: the K/V (and
        the encdec family's cross K/V) concatenated over the model
        positions along the dimension their layout splits (``kv_heads``,
        the sequence under ``kv_seq``, ``head_dim``); the SSM state along
        its heads, the conv carry's x channels over the model positions
        and its B and C channels from model index 0 (after a check that
        every shard's are equal); then along the batch over the data
        positions (along the sequence for a K/V that lies so; the first
        data index's for a batch every data index ran whole)."""
        dev = self.device(0, 0)
        pieces = cache["pieces"]
        m_split = self.ssm_split

        def over_model(d, part, name):
            got = [(pieces[(d, j)][part] if name is None else
                    pieces[(d, j)][part][name]).to(dev)
                   for j, _ in self.group(d)]
            if part != "ssm":
                dim = self._kv_model_dim(cross=part != "kv")
                return got[0] if dim is None else torch.cat(got, dim=dim)
            if not m_split:
                return got[0]
            if name == "state":
                return torch.cat(got, dim=2)
            dis = self._conv_dis()                  # the conv carry
            bc = [g[..., dis:] for g in got]
            if any(not torch.equal(x, bc[0]) for x in bc[1:]):
                raise ValueError("the shards' B and C conv carries differ")
            return torch.cat([g[..., :dis] for g in got] + [bc[0]], dim=-1)

        out = {"index": cache["index"]}
        for part, seq_dim in (("kv", 3), ("ssm", None), ("cross_k", None),
                              ("cross_v", None)):
            if part not in pieces[(0, 0)]:
                continue
            names = [None] if part.startswith("cross") else \
                list(pieces[(0, 0)][part])
            got = {name: self._data_join(
                [over_model(d, part, name) for d in self.data_indices()],
                cache, seq_dim) for name in names}
            out[part] = got[None] if part.startswith("cross") else got
        return out

    def split_cache(self, whole: dict) -> dict:
        """The inverse of :meth:`gather_cache`: an unsplit serving cache
        (``models.model.init_cache``'s layout, on any device) cut into
        this split's pieces, each position's part copied to its device
        -- the controller's work, not a device's (no cost is counted).
        A server whose prefill and decode resolve different rules carries
        its cache from one split to the other by ``gather_cache`` and
        ``split_cache``."""
        with CA.paused():
            return self._split_cache(whole)

    def _split_cache(self, whole: dict) -> dict:
        ref = whole["kv"]["k"] if "kv" in whole else whole["ssm"]["state"]
        batch = ref.shape[1]
        max_seq = whole["kv"]["k"].shape[3] if "kv" in whole else 0
        n = self.data_extent
        split_b = self.batch_split(batch)
        parts = axis_size(self.mesh, DATA_AXIS) \
            if "kv" in whole and self.seq_split(batch, max_seq) else 1
        m = self.extent

        def cut(t, d, j, part, name):
            if split_b:                           # the data index's rows
                t = t.chunk(n, dim=1)[d]
            elif parts > 1 and part == "kv":      # its sequence part
                t = t.chunk(parts, dim=3)[d % parts]
            if part == "ssm":
                if not self.ssm_split:
                    return t
                if name == "state":
                    return t.chunk(m, dim=2)[j]
                dis = self._conv_dis()
                return torch.cat([t[..., j * dis:(j + 1) * dis],
                                  t[..., m * dis:]], dim=-1)
            dim = self._kv_model_dim(cross=part != "kv")
            return t if dim is None else t.chunk(m, dim=dim)[j]

        out = {}
        for pos in self.pieces:
            dev, c = self.device(*pos), {}
            for part, leaves in whole.items():
                if part == "index":
                    continue
                if isinstance(leaves, dict):
                    c[part] = {k: cut(v, *pos, part, k).to(
                        dev, copy=True).contiguous()
                        for k, v in leaves.items()}
                else:
                    c[part] = cut(leaves, *pos, part, None).to(
                        dev, copy=True).contiguous()
            out[pos] = c
        return {"pieces": out, "index": int(whole["index"]),
                "seq_parts": parts, "batch_parts": n if split_b else 1}

    def gather(self) -> nn.Module:
        """The unsplit model (data index 0's pieces joined leaf by leaf,
        ``LeafLayout.join``), on position (0, 0)'s device."""
        if len(self.group(0)) != self.extent:
            raise ValueError("gathering needs every model position")
        dev = self.device(0, 0)
        named = [dict(p.named_parameters()) for _, p in self.group(0)]
        sd = {k: self.layouts[k].join([n[k].detach().to(dev)
                                       for n in named]).clone()
              for k in named[0]}
        out = M.model_class(self.cfg)(self.cfg)
        out.load_state_dict(sd, strict=True, assign=True)
        return out


def split_rules(cfg: ModelConfig, mesh: Mesh) -> ShardingRules:
    """The default rules a split model is laid out by: the mesh's rules
    for the config's dimensions with no sequence (so ``head_dim`` where
    the heads do not divide the model axis, as for a decode step).  A
    cell's own rules -- ``kv_seq`` for a train or prefill cell of such a
    model -- come from ``resolve_rules(mesh, models.model.sharding_dims(
    cfg, batch, kv_seq=..., q_seq=...))``."""
    return resolve_rules(mesh, M.sharding_dims(cfg, 0))


def all_positions(mesh: Mesh) -> List[Position]:
    m = axis_size(mesh, MODEL_AXIS)
    n = math.prod(mesh.shape[a] for a in data_axes(mesh))
    return [(d, j) for d in range(n) for j in range(m)]


def split_model(model: nn.Module, mesh: Mesh,
                rules: Optional[ShardingRules] = None, *,
                positions: Optional[Sequence[Position]] = None) -> SplitLM:
    """``model`` split over ``mesh`` (every position, or ``positions``):
    each leaf cut by its :class:`LeafLayout` (:func:`leaf_layouts`), piece
    ``j`` copied to the devices of model index ``j``; a leaf that nothing
    divides is copied whole.  On a mesh with devices each piece goes to
    its position's device; on an abstract mesh to ``model``'s device (on
    the meta device: shapes only).  Raises ``NotImplementedError`` for a
    layout the port does not split (:func:`unsupported_axes`: ``kv_seq``
    on the data axis outside the hybrid family) and ValueError for a model
    extent that does not divide the SSM heads."""
    cfg = model.cfg
    rules = rules or split_rules(cfg, mesh)
    bad = unsupported_axes(cfg, rules)
    if bad:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) on {dict(mesh.shape)}: the rules put "
            f"{bad} where the port does not split them (ROADMAP Queue 1: "
            f"what stays refused)")
    m = axis_size(mesh, MODEL_AXIS)
    layouts = leaf_layouts(cfg, rules, m)
    positions = list(positions or all_positions(mesh))
    named = dict(model.named_parameters())
    src_dev = next(iter(named.values())).device
    cuts = {}
    pieces = {}
    for d, j in positions:
        dev = src_dev if mesh.devices is None else mesh.devices[d * m + j]
        piece = M.model_class(cfg)(cfg)          # on the meta device
        for k, p in named.items():
            if k not in cuts:
                cuts[k] = layouts[k].cut(p.detach())
            t = cuts[k][j]
            t = (torch.empty(t.shape, dtype=t.dtype, device="meta")
                 if dev.type == "meta" else
                 t.to(dev, copy=True).contiguous())
            _assign(piece, k, t, p.requires_grad)
        piece.cfg = cfg
        pieces[(d, j)] = piece
    return SplitLM(cfg, mesh, rules, pieces)
