"""train_step factory: microbatched gradient accumulation + AdamW (the port
of ``repro/train/step.py``).

The returned step has the signature ``(TrainState, batch) -> (TrainState,
metrics)``.  It runs eagerly: the forward and backward of
:func:`repro_torch.models.model.loss_fn` per microbatch, float32
accumulation of the gradients, then :func:`adamw_update`.  The working
parameters (an ``nn.Module``, ``requires_grad``) and the optimizer state
are updated in place and returned; a caller that needs the old state keeps
a :meth:`TrainState.clone`.

Every family trains: ssm, dense, moe, hybrid and encdec.  Neither
hand-written kernel of their serving paths has a backward, in the JAX
package or here: training runs the SSD through ``ssd_chunked`` and
attention through ``_attention_core`` (encdec: its cross-attention
through the plain form) under autograd, as the JAX package trains them,
so a config with ``use_flash_kernel=True`` is refused.  An encdec batch
carries 'frames' (B, enc_seq, d_model) beside the tokens and labels; the
microbatch split slices every entry along the batch, frames too.  A moe step
averages the blocks' ``moe_aux_loss`` and ``moe_dropped_frac`` over the
microbatches with the loss.

ZeRO-1 (:func:`shard_train_state`): the AdamW state is split over a mesh's
data axis (``train/optimizer.py``), and each batch device (the positions of
the mesh's data axes) gets a replica of the working parameters -- one a
device, so on one card every position shares one.  The step then splits
the global batch contiguously over the batch devices and each part into
``n_microbatches``, and adds every microbatch's float32 gradient into one
accumulator in global microbatch order (device-major, as one unsharded
loop over all the microbatches would), divides by their count, updates
the state piece by piece and casts each piece into every replica.  So a
split batch steps bitwise as the unsplit one with as many microbatches,
except through the global norm (see ``train/optimizer.py``).
``grad_constraint`` (:func:`~repro_torch.train.optimizer.
zero1_grad_constraint`) puts the accumulated gradients into the ZeRO-1
layout before the update; with ``zero1_grads_in_scan`` the accumulator
itself lives in that layout and takes each microbatch's slices.

Tensor parallelism x ZeRO-1 (a mesh whose model axis is above 1):
:func:`shard_train_state` returns a :class:`SplitTrainState` -- the model
split by position (``distributed.tensor_parallel``), each model piece's
AdamW state split over the data positions of its model index.  Its step
runs microbatch by microbatch, each data position's model group in turn
(where the batch does not split over the data positions, each runs all
of it); the replicated leaves' gradients, and the segments of a leaf
every piece holds whole (B's and C's columns of a head-aligned Mamba2
``in_proj`` and conv), are all-reduced over the model positions -- none
where the model positions are replicas --, the gradients
reduce-scattered over the data axis into the ZeRO-1 layout (all-reduced
over the pods first), each piece updated with the norm of all of them
(a replicated leaf or segment counted once), and the new master
all-gathered over the data axis into every piece
(``distributed.collectives``: the bytes a cost counter sees).  It agrees
with the unsplit step by T2's rule (partial products summed in another
order), and its checkpoint image is the unsplit state's, leaf for leaf
(``tensor_parallel.LeafLayout.join``).
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, Mapping, NamedTuple, Optional,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.mesh import (DATA_AXIS, MODEL_AXIS, POD_AXIS,
                                          Mesh, axis_size, data_axes)
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import ShardingRules, resolve_rules
from repro_torch.distributed.tensor_parallel import split_model
from repro_torch.launch import cost_analysis as CA
from repro_torch.models import model as M
from repro_torch.train.optimizer import (
    AdamWConfig,
    AdamWState,
    Sharded,
    _split_dim,
    adamw_update,
    data_devices,
    global_norm,
    init_adamw,
    params_from_master,
    shard_state,
    zero1_grad_constraint,
    zero1_state_shardings,
)

_OPT_PARTS = ("master", "m", "v")


def _copy_model(params: M.LM, device) -> M.LM:
    """A copy of the working parameters on ``device`` (``nn.Parameter``
    leaves, requiring grad), sharing no storage with ``params``."""
    cfg = params.cfg
    out = M.model_class(cfg)(cfg)               # on the meta device
    out.load_state_dict({k: p.detach().to(device, copy=True) for k, p
                         in params.named_parameters()},
                        strict=True, assign=True)
    return out.requires_grad_(True)


class TrainState(NamedTuple):
    params: M.LM         # param_dtype (bf16) working copy, requires grad
    opt: AdamWState      # fp32 master + moments (ZeRO-1: Sharded leaves)
    # ZeRO-1: the working parameters of each batch device, in mesh order
    # (one module a device; ``params`` is the first); () unsharded
    replicas: Tuple[M.LM, ...] = ()

    def modules(self) -> list:
        """The distinct working-parameter modules: one a batch device."""
        out = []
        for m in self.replicas or (self.params,):
            if not any(m is o for o in out):
                out.append(m)
        return out

    def tree(self) -> Dict[str, torch.Tensor]:
        """The state as one flat mapping (the checkpoint layout):
        ``params/<name>``, ``opt/step``, ``opt/{master,m,v}/<name>``; a
        sharded leaf is gathered whole, so the image does not depend on
        the mesh."""
        out = {f"params/{k}": p for k, p in self.params.named_parameters()}
        out["opt/step"] = self.opt.step
        for part in _OPT_PARTS:
            out.update({f"opt/{part}/{k}": t.gather()
                        if isinstance(t, Sharded) else t
                        for k, t in getattr(self.opt, part).items()})
        return out

    @torch.no_grad()
    def load_tree(self, tree: Mapping[str, torch.Tensor]) -> "TrainState":
        """Copy a :meth:`tree` mapping into this state in place (into
        every replica, and into the pieces of a sharded leaf)."""
        for rep in self.modules():
            for k, p in rep.named_parameters():
                p.copy_(tree[f"params/{k}"])
        self.opt.step.copy_(tree["opt/step"])
        for part in _OPT_PARTS:
            for k, t in getattr(self.opt, part).items():
                whole = tree[f"opt/{part}/{k}"]
                for piece, sl in (t.slices(whole) if isinstance(t, Sharded)
                                  else ((t, whole),)):
                    piece.copy_(sl)
        return self

    def clone(self) -> "TrainState":
        """A copy that shares no storage with this state."""
        copies = {id(m): _copy_model(m, next(m.parameters()).device)
                  for m in self.modules()}
        parts = {p: {k: t.map(torch.clone) if isinstance(t, Sharded)
                     else t.clone()
                     for k, t in getattr(self.opt, p).items()}
                 for p in _OPT_PARTS}
        return TrainState(copies[id(self.params)],
                          AdamWState(step=self.opt.step.clone(), **parts),
                          tuple(copies[id(m)] for m in self.replicas))


def zero1_specs(cfg: ModelConfig, mesh: Mesh,
                rules: Optional[ShardingRules] = None) -> AdamWState:
    """The ZeRO-1 specs of ``cfg``'s AdamW state on ``mesh``: the
    parameters' logical specs (``models.model.param_logical_specs``)
    resolved by ``rules`` (default: the mesh's rules with no sequence),
    widened by ``zero1_spec``."""
    rules = rules or resolve_rules(mesh, M.sharding_dims(cfg, 0))
    shapes = {k: tuple(p.shape) for k, p
              in M.model_class(cfg)(cfg).named_parameters()}
    return zero1_state_shardings(
        {k: rules.spec(ls) for k, ls in M.param_logical_specs(cfg).items()},
        shapes, mesh)


def batch_devices(mesh: Mesh) -> list:
    """The devices a ZeRO-1 step splits the global batch over: the
    positions of the mesh's data axes (pod, data), in mesh order."""
    data_devices(mesh)                      # refuses an abstract mesh
    return mesh.devices_along(data_axes(mesh))


def shard_train_state(state: TrainState, mesh: Mesh, *, positions=None,
                      rules: Optional[ShardingRules] = None
                      ) -> Union[TrainState, "SplitTrainState"]:
    """``state`` with its AdamW state split ZeRO-1-style over ``mesh``'s
    data axis (:func:`~repro_torch.train.optimizer.shard_state`: by copy,
    each whole leaf dropped from ``state`` once split) and a replica of
    the working parameters on each batch device (``state.params`` itself
    where it already lies there).

    A mesh with a model axis above 1 (tensor parallelism): a
    :class:`SplitTrainState` -- the parameters split by position, each
    model piece's AdamW state over the data positions of its model index
    -- of every position, or of ``positions`` (``(d, j)``; the dry run's
    state on the meta device holds ``[(0, 0)]``), laid out by ``rules``
    (default ``tensor_parallel.split_rules``; a train cell of a model
    whose heads do not divide the model axis resolves ``kv_seq``
    there)."""
    if axis_size(mesh, MODEL_AXIS) > 1 or positions is not None:
        return _split_train_state(state, mesh, positions, rules)
    cfg = state.params.cfg
    constraint = zero1_grad_constraint(mesh, zero1_specs(cfg, mesh).master)
    opt = shard_state(state.opt, constraint)
    have = next(state.params.parameters()).device
    mods = {have: state.params}
    reps = []
    for dev in batch_devices(mesh):
        if dev not in mods:
            mods[dev] = _copy_model(state.params, dev)
        reps.append(mods[dev])
    return TrainState(reps[0], opt, tuple(reps))


# --------------------------------------------------------------------------- #
# Tensor parallelism x ZeRO-1: a state split over a (data, model) mesh
# --------------------------------------------------------------------------- #

class SplitTrainState(NamedTuple):
    """A train state over a mesh with a model axis above 1: the working
    parameters split by position (``params``, a
    :class:`~repro_torch.distributed.tensor_parallel.SplitLM`), and for
    each model index ``j`` the AdamW state of its piece, each leaf split
    over the data positions of model index ``j`` (pod 0) along
    ``zero_dims[name]`` (None: whole, a copy a data position), in mesh
    order.
    A state of the dry run holds mesh position 0 alone."""

    params: Any                       # SplitLM
    opts: Tuple[AdamWState, ...]      # one a model index
    zero_dims: Dict[str, Optional[int]]

    def modules(self) -> list:
        return self.params.modules()

    def _whole(self, k: str, leaves: list) -> torch.Tensor:
        """Leaf ``k`` from one piece a model index, on position (0, 0)'s
        device (``tensor_parallel.LeafLayout.join``)."""
        dev = self.params.device(0, 0)
        return self.params.layouts[k].join([t.to(dev) for t in leaves])

    def tree(self) -> Dict[str, torch.Tensor]:
        """The checkpoint image, in the unsplit state's layout: every leaf
        gathered over the data positions and the model positions (needs
        every position)."""
        split = self.params
        if not split.complete:
            raise ValueError("the image of a state needs every position")
        named = [dict(p.named_parameters()) for _, p in split.group(0)]
        out = {f"params/{k}": self._whole(k, [n[k] for n in named])
               for k in named[0]}
        out["opt/step"] = self.opts[0].step
        for part in _OPT_PARTS:
            leaves = [getattr(o, part) for o in self.opts]
            out.update({f"opt/{part}/{k}": self._whole(
                k, [t[k].gather() for t in leaves]) for k in leaves[0]})
        return out

    @torch.no_grad()
    def load_tree(self, tree: Mapping[str, torch.Tensor]
                  ) -> "SplitTrainState":
        """Copy a :meth:`tree` mapping into this state in place."""
        split = self.params
        for (d, j), piece in split.pieces.items():
            for k, p in piece.named_parameters():
                p.copy_(split.layouts[k].cut(tree[f"params/{k}"])[j])
        for j, opt in enumerate(self.opts):
            opt.step.copy_(tree["opt/step"])
            for part in _OPT_PARTS:
                for k, t in getattr(opt, part).items():
                    whole = split.layouts[k].cut(tree[f"opt/{part}/{k}"])[j]
                    for piece, sl in t.slices(whole):
                        piece.copy_(sl)
        return self

    def clone(self) -> "SplitTrainState":
        """A copy that shares no storage with this state."""
        opts = tuple(AdamWState(step=o.step.clone(), **{
            part: {k: t.map(torch.clone) for k, t in getattr(o, part).items()}
            for part in _OPT_PARTS}) for o in self.opts)
        return SplitTrainState(self.params.clone(), opts,
                               dict(self.zero_dims))


def _data_layout(mesh: Mesh) -> Tuple[int, int]:
    """(pod extent, data extent) of ``mesh``."""
    return axis_size(mesh, POD_AXIS), axis_size(mesh, DATA_AXIS)


def split_zero_dims(cfg: ModelConfig, mesh: Mesh,
                    rules: Optional[ShardingRules] = None
                    ) -> Dict[str, Optional[int]]:
    """The dimension ZeRO-1 splits each leaf's model piece along over the
    data axis (``zero1_spec`` of the leaf's spec on ``mesh`` by
    ``rules``), None where nothing divides."""
    specs = zero1_specs(cfg, mesh, rules).master
    return {k: _split_dim(spec, DATA_AXIS) for k, spec in specs.items()}


def _split_train_state(state: TrainState, mesh: Mesh, positions=None,
                       rules: Optional[ShardingRules] = None
                       ) -> SplitTrainState:
    """``state`` split over ``mesh``: its parameters by position
    (``split_model``), each model piece's AdamW state over the data
    positions of its model index (pod 0), by copy, each whole leaf of
    ``state`` dropped once its pieces exist."""
    cfg = state.params.cfg
    split = split_model(state.params, mesh, rules, positions=positions)
    m = split.extent
    n_pod, n_data = _data_layout(mesh)
    zdims = split_zero_dims(cfg, mesh, split.rules)
    # the data positions of pod 0 present, for each model index
    owners = {j: [e for e in range(n_data) if (e, j) in split.pieces]
              for j in range(m)}
    present = [j for j in range(m) if owners[j]]
    parts = {j: {part: {} for part in _OPT_PARTS} for j in present}
    for part in _OPT_PARTS:
        src = getattr(state.opt, part)
        for k in list(src):
            whole = src[k]
            zd = zdims[k]
            for j in present:
                local = split.layouts[k].cut(whole)[j]
                if zd is None:      # a copy a data position
                    pieces = [(local, split.device(e, j))
                              for e in owners[j]]
                else:
                    if local.shape[zd] % n_data:
                        raise ValueError(
                            f"{k}: dim {zd} of its model piece "
                            f"{tuple(local.shape)} does not split over "
                            f"{n_data} data positions")
                    n = local.shape[zd] // n_data
                    pieces = [(local.narrow(zd, e * n, n), split.device(e, j))
                              for e in owners[j]]
                out = []
                for t, dev in pieces:
                    c = torch.empty(t.shape, dtype=torch.float32, device=dev)
                    out.append(c.copy_(t))
                parts[j][part][k] = Sharded(tuple(out), zd)
            del src[k]
    opts = tuple(AdamWState(step=state.opt.step.to(
        split.device(owners[j][0], j), copy=True), **parts[j])
        for j in present)
    return SplitTrainState(split.requires_grad_(True), opts, zdims)


def _reduce_over_data(split, j: int, k: str, zd: Optional[int],
                      by_d: Dict[int, torch.Tensor]) -> Sharded:
    """The sum over the data positions of model index ``j``'s float32
    gradients of leaf ``k`` (``by_d``: one a data index present), in the
    ZeRO-1 layout: all-reduced over the pods, then reduce-scattered over
    the data axis along ``zd`` (all-reduced where ``zd`` is None)."""
    n_pod, n_data = _data_layout(split.mesh)
    origin = j == 0
    if n_pod > 1:
        for e in sorted({d % n_data for d in by_d}):
            pods = [d for d in sorted(by_d) if d % n_data == e]
            out = C.all_reduce([by_d[d] for d in pods], extent=n_pod,
                               origin=origin and e == 0)
            by_d[pods[0]] = out[0]
    at_pod0 = [by_d[e] for e in range(n_data) if e in by_d]
    if zd is None:
        return Sharded(tuple(C.all_reduce(at_pod0, extent=n_data,
                                          origin=origin)), None)
    return Sharded(tuple(C.reduce_scatter(at_pod0, zd, extent=n_data,
                                          origin=origin)), zd)


def _shared_mask(lay, device) -> Optional[torch.Tensor]:
    """1 along the layout's model dimension where a piece holds its own
    part, 0 where it holds a segment every piece holds (B and C of a
    head-aligned mixer leaf); None where it holds nothing shared."""
    spans = lay.shared()
    if lay.dim is None or not spans:
        return None
    mask = torch.ones(lay.piece_size(), dtype=torch.float32, device=device)
    for off, n in spans:
        mask[off:off + n] = 0.0
    return mask


def _split_train_step(state: SplitTrainState, batch: Mapping[str, Any],
                      cfg: ModelConfig, opt_cfg: AdamWConfig, schedule,
                      n_microbatches: int, in_scan: bool):
    """One step of a split state (see :func:`make_train_step`)."""
    split = state.params
    m, n_dp = split.extent, split.data_extent
    n_pod, n_data = _data_layout(split.mesh)
    present = split.data_indices()
    b = batch["tokens"].shape[0]
    n_total = n_dp * n_microbatches
    # where the batch does not split over the data positions each runs all
    # of it (the rules replicate it), in n_microbatches parts
    whole_batch = not split.batch_split(b)
    rows = b if whole_batch else b // n_dp
    if rows % n_microbatches:
        raise ValueError(f"batch {b} % (data positions {n_dp} x "
                         f"n_microbatches {n_microbatches}) != 0")
    per, mb = (0 if whole_batch else rows), rows // n_microbatches
    layouts = split.layouts
    names = [k for k, _ in split.group(present[0])[0][1].named_parameters()]
    # leaves every model position holds whole, and the leaves of which each
    # holds a segment whole: their gradients are summed over the model
    # positions (none where the positions are replicas)
    replicated = [k for k in names if m > 1 and layouts[k].dim is None]
    shared = {k: layouts[k].shared() for k in names
              if layouts[k].dim is not None and layouts[k].shared()}
    summed = [] if split.replicas else replicated
    zdims = state.zero_dims

    def grads_of(d: int, micro) -> Dict[int, Dict[str, torch.Tensor]]:
        """Each model position's float32 gradients on one microbatch, the
        replicated leaves' and segments' summed over the model
        positions."""
        group = split.group(d)
        for _, p in group:
            p.zero_grad(set_to_none=True)
        with torch.enable_grad():
            scaled, metrics = M._split_loss_terms(split, micro, cfg, d)
            torch.autograd.backward(scaled)
        out = {j: {k: p.grad.float() for k, p in piece.named_parameters()}
               for j, piece in group}
        for _, p in group:
            p.zero_grad(set_to_none=True)
        for k in summed:
            tot = C.all_reduce([out[j][k] for j, _ in group], extent=m,
                               origin=d == 0)
            for (j, _), g in zip(group, tot):
                out[j][k] = g
        for k, spans in shared.items():
            dim = layouts[k].dim
            for off, n in spans:
                tot = C.all_reduce([out[j][k].narrow(dim, off, n)
                                    for j, _ in group], extent=m,
                                   origin=d == 0)
                for (j, _), g in zip(group, tot):
                    out[j][k] = out[j][k].clone()
                    out[j][k].narrow(dim, off, n).copy_(g)
        return out, {k: v.detach() for k, v in metrics.items()}

    owners = sorted({j for _, j in split.pieces})
    acc: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}
    zacc: Dict[int, Dict[str, Sharded]] = {}
    m_sum: Dict[int, Dict[str, torch.Tensor]] = {}
    for i in range(n_microbatches):
        by_d = {}
        for d in present:
            dev = split.device(d, split.group(d)[0][0])
            # each position moves (and widens) its own tokens and labels
            micro = {k: torch.as_tensor(v)[d * per + i * mb:
                                           d * per + (i + 1) * mb]
                     for k, v in batch.items()}
            g, metrics = grads_of(d, micro)
            with CA.paused():           # the controller's bookkeeping
                tot = m_sum.setdefault(d, _zero_metrics(cfg, dev))
                for k in tot:
                    tot[k] += metrics[k]
            if in_scan:
                by_d[d] = g
            else:
                for j, gj in g.items():
                    a = acc.setdefault((d, j), {})
                    for k, t in gj.items():
                        a[k] = a[k] + t if k in a else t
        for j in owners if in_scan else ():
            for k in names:
                r = _reduce_over_data(split, j, k, zdims[k],
                                      {d: by_d[d][j][k] for d in by_d})
                z = zacc.setdefault(j, {})
                z[k] = r if k not in z else Sharded(
                    tuple(x + y for x, y in zip(z[k].shards, r.shards)),
                    r.dim)
    if not in_scan:
        for j in owners:
            zacc[j] = {k: _reduce_over_data(
                split, j, k, zdims[k], {d: acc[(d, j)][k] for d in present
                                        if (d, j) in acc})
                for k in names}
        acc.clear()
    grads = {j: {k: g.map(lambda t: t / t.new_tensor(float(n_total)))
                 for k, g in zacc[j].items()} for j in owners}
    # the norm over every piece, a replicated leaf or segment once (each
    # position sums the squares of all its pieces, and of their shared
    # segments, as each device does)
    dev0 = state.opts[0].step.device

    def squares(j, k, g):
        out = []
        off = 0
        for x in g.shards:             # each data position's own work
            whole = torch.sum(torch.square(x))
            mask = _shared_mask(layouts[k], x.device) if k in shared \
                else None
            if mask is None:
                out.append((whole, whole))
                continue
            dim = layouts[k].dim
            mk = mask if g.dim != dim else mask[off:off + x.shape[dim]]
            off += x.shape[dim] if g.dim == dim else 0
            view = [-1 if i == dim else 1 for i in range(x.dim())]
            out.append((whole, torch.sum(torch.square(x) * mk.view(view))))
        return out

    sq = {(j, k): squares(j, k, g) for j in owners
          for k, g in grads[j].items()}
    with CA.paused():           # an all-reduce of the partial sums
        gnorm = torch.sqrt(sum(
            (whole if j == owners[0] else own).to(dev0)
            for (j, k), xs in sq.items()
            for whole, own in (xs if zdims[k] is not None else xs[:1])
            if j == owners[0] or k not in replicated))
    with CA.paused():
        lr_scale = schedule(state.opts[0].step)
    new_opts = []
    for j, opt in zip(owners, state.opts):
        master, new = adamw_update(opt_cfg, grads[j], opt, lr_scale,
                                   gnorm=gnorm.to(opt.step.device))
        new_opts.append(new)
        es = [e for e in range(n_data) if (e, j) in split.pieces]
        with torch.no_grad():
            for k in names:
                w, zd = master[k], zdims[k]
                whole = list(w.shards) if zd is None else \
                    C.all_gather(list(w.shards), zd, extent=n_data,
                                 origin=j == 0)
                for (d, jj), piece in split.pieces.items():
                    if jj == j:
                        src = whole[es.index(d % n_data)]
                        dict(piece.named_parameters())[k].copy_(src)
    totals = {k: C.all_reduce([m_sum[d][k] for d in present], extent=n_dp)[0]
              for k in m_sum[present[0]]}
    with CA.paused():
        metrics = {k: v / v.new_tensor(float(n_total))
                   for k, v in totals.items()}
        metrics["grad_norm"] = gnorm
        metrics["lr_scale"] = torch.as_tensor(lr_scale, dtype=torch.float32)
        metrics["step"] = new_opts[0].step.float()
    return state._replace(opts=tuple(new_opts)), metrics


def require_trainable_family(cfg: ModelConfig) -> None:
    """Training is ported for every family; an unknown one raises."""
    M._require_ported(cfg)


def serving_kernel(cfg: ModelConfig) -> Tuple[str, str]:
    """Why training turns ``use_flash_kernel`` off for ``cfg``'s family --
    the clause naming the hand-written kernels the knob turns on, which
    have no backward -- and the plain paths training runs in their place."""
    if cfg.family in M.ATTENTION_FAMILIES:
        return ("the flash-attention kernel has no backward",
                "_attention_core")
    if cfg.family == "encdec":
        return ("the flash-attention kernel has no backward",
                "_attention_core and the plain cross-attention")
    if cfg.family == "hybrid":
        return ("the SSD kernel and the flash-attention kernel have no "
                "backward", "ssd_chunked and _attention_core")
    return "the SSD kernel has no backward", "ssd_chunked"


def require_trainable(cfg: ModelConfig) -> None:
    """Refuse a config that training cannot run faithfully."""
    require_trainable_family(cfg)
    if cfg.use_flash_kernel:
        why, plain = serving_kernel(cfg)
        raise ValueError(
            f"training needs use_flash_kernel=False: {why} (in the JAX "
            f"package or in the port), so training runs {plain}; pass "
            f"dataclasses.replace(cfg, use_flash_kernel=False)")


def _named(params: M.LM) -> Dict[str, torch.Tensor]:
    return dict(params.named_parameters())


def init_train_state(seed: Union[int, torch.Generator], cfg: ModelConfig,
                     device=None) -> TrainState:
    """The port's init (:func:`repro_torch.models.init_params`: a seed
    draws on the CPU, a ``torch.Generator`` on its own device) with
    trainable parameters, and a fresh AdamW state."""
    require_trainable_family(cfg)
    params = M.init_params(seed, cfg, device=device).requires_grad_(True)
    return TrainState(params=params, opt=init_adamw(_named(params)))


def from_reference(state_np: Any, cfg: ModelConfig, device=None) -> TrainState:
    """The port's state holding a JAX ``TrainState`` given as numpy arrays
    (``params`` the ``init_params`` pytree; ``opt`` an ``AdamWState`` with
    ``step`` and the ``master``/``m``/``v`` pytrees), the layer-stacked
    leaves split per layer through ``models.model.reference_state``'s
    naming."""
    require_trainable_family(cfg)
    params_np, opt = state_np[0], state_np[1]
    params = M.from_reference(params_np, cfg, device).requires_grad_(True)
    dev = next(params.parameters()).device
    parts = {}
    for part in _OPT_PARTS:
        flat = M.reference_state(getattr(opt, part), cfg)
        parts[part] = {k: torch.from_numpy(np.array(a, dtype=np.float32))
                       .to(dev) for k, a in flat.items()}
    step = torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                        device=dev)
    return TrainState(params, AdamWState(step=step, **parts))


def _zero_metrics(cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    """The metrics a microbatched step averages: the loss and the
    cross-entropy, and for the moe family the aux loss and the dropped
    share."""
    names = ("loss", "ce")
    if cfg.family == "moe":
        names += ("moe_aux_loss", "moe_dropped_frac")
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in names}


def _to_device(batch: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """The batch as tensors on ``device``: the integer entries (tokens,
    labels, positions) as int64, the encdec 'frames' in their own floating
    dtype."""
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else M._tensor(np.asarray(v))
        out[k] = t.to(device=device, dtype=t.dtype if t.is_floating_point()
                      else torch.long)
    return out


def compute_grads(params: M.LM, batch: Mapping[str, torch.Tensor],
                  cfg: ModelConfig
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Gradients of :func:`loss_fn` by name (in the parameters' dtypes) and
    its metrics; leaves no ``.grad`` on the parameters."""
    params.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss, metrics = M.loss_fn(params, batch, cfg)
        loss.backward()
    grads = {k: p.grad for k, p in params.named_parameters()}
    params.zero_grad(set_to_none=True)
    return grads, {k: v.detach() for k, v in metrics.items()}


def _accumulate(acc: Dict[str, Any], grads: Mapping[str, torch.Tensor]
                ) -> None:
    """``acc += grads`` in float32, leaf by leaf, in place; a
    :class:`Sharded` accumulator takes each piece's slice."""
    for k, g in grads.items():
        a = acc[k]
        for piece, sl in (a.slices(g) if isinstance(a, Sharded)
                          else ((a, g),)):
            piece += sl.to(piece.device).float()


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    schedule: Callable[[torch.Tensor], torch.Tensor],
    *,
    n_microbatches: int = 1,
    grad_constraint: Optional[Callable] = None,
    zero1_grads_in_scan: bool = False,
) -> Callable[[TrainState, Mapping[str, Any]],
              Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the train step.  ``batch``: ``{'tokens', 'labels'}`` (B, S)
    integer arrays or tensors (encdec: and 'frames' (B, enc_seq,
    d_model)), moved to the parameters' device -- for a ZeRO-1 state,
    split over its batch devices, each part moved to its own.

    ``grad_constraint`` (optional) re-shards the accumulated gradients
    (ZeRO-1 layout) before the optimizer consumes them: a callable from
    ``{name: float32 gradient}`` (any subset of the names) to the layout,
    as :func:`~repro_torch.train.optimizer.zero1_grad_constraint` builds
    it.  By default it is applied once after the microbatch loop;
    ``zero1_grads_in_scan`` additionally keeps the accumulator itself in
    that layout (smaller, at the cost of a slice-add a leaf and
    microbatch).  A :class:`SplitTrainState` carries its own ZeRO-1 layout
    (``grad_constraint`` must be None); ``zero1_grads_in_scan`` then
    reduce-scatters each microbatch's gradients over the data axis."""
    require_trainable(cfg)
    in_scan = grad_constraint is not None and zero1_grads_in_scan

    def train_step(state: TrainState, batch: Mapping[str, Any]):
        if isinstance(state, SplitTrainState):
            if grad_constraint is not None:
                raise ValueError(
                    "a split state carries its own ZeRO-1 layout; build "
                    "its step without grad_constraint")
            return _split_train_step(state, batch, cfg, opt_cfg, schedule,
                                     n_microbatches, zero1_grads_in_scan)
        dev = state.opt.step.device
        reps = state.replicas or (state.params,)
        n_total = len(reps) * n_microbatches
        if n_total == 1:
            grads, metrics = compute_grads(state.params,
                                           _to_device(batch, dev), cfg)
        else:
            b = batch["tokens"].shape[0]
            if b % n_total:
                raise ValueError(
                    f"batch {b} % (batch devices {len(reps)} x "
                    f"n_microbatches {n_microbatches}) != 0")
            mb = b // n_total
            g_sum = {}
            for k, p in state.params.named_parameters():
                zero = torch.zeros(p.shape, dtype=torch.float32, device=dev)
                # one whole leaf at a time into the layout
                g_sum.update(grad_constraint({k: zero}) if in_scan
                             else {k: zero})
            m_sum = _zero_metrics(cfg, dev)
            per = mb * n_microbatches
            for j, rep in enumerate(reps):
                part = _to_device({k: v[j * per:(j + 1) * per]
                                   for k, v in batch.items()},
                                  next(rep.parameters()).device)
                for i in range(n_microbatches):
                    micro = {k: v[i * mb:(i + 1) * mb]
                             for k, v in part.items()}
                    grads, metrics = compute_grads(rep, micro, cfg)
                    _accumulate(g_sum, grads)
                    m_sum = {k: m_sum[k] + metrics[k].to(dev)
                             for k in m_sum}
            n = torch.tensor(float(n_total), device=dev)
            grads = {k: g.map(lambda t: t / n.to(t.device))
                     if isinstance(g, Sharded) else g / n
                     for k, g in g_sum.items()}
            metrics = {k: v / n for k, v in m_sum.items()}

        if grad_constraint is not None:
            grads = grad_constraint(grads)
        lr_scale = schedule(state.opt.step)
        master, new_opt = adamw_update(opt_cfg, grads, state.opt, lr_scale)
        for rep in state.modules():
            params_from_master(master, _named(rep))
        metrics = dict(metrics)
        metrics["grad_norm"] = global_norm(grads)
        metrics["lr_scale"] = torch.as_tensor(lr_scale, dtype=torch.float32)
        metrics["step"] = new_opt.step.float()
        return state._replace(opt=new_opt), metrics

    return train_step
