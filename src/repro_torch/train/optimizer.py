"""AdamW from scratch (the port of ``repro/train/optimizer.py:1-108``).

Layout: model parameters live in ``param_dtype`` (bf16 by default); the
optimizer state holds an fp32 master copy plus Adam moments.  Updates:
grads -> fp32, Adam math in fp32, master update, parameters re-cast to
``param_dtype`` (:func:`params_from_master`).

The port's parameter "pytree" is a flat mapping of the model's parameter
names (``blocks.3.mixer.a_log``) to tensors; the no-decay substrings are
matched against those names, as the JAX package matches its key paths
(``blocks/mixer/a_log``).  Every division is by a tensor (IEEE division on
every device; on CUDA a division by a Python float multiplies by its
reciprocal).

ZeRO-1 (the port of ``zero1_spec`` and ``zero1_state_shardings``): a
leaf's spec is widened with the mesh's data axis on its largest divisible
free dimension, and :func:`shard_state` splits the state by those specs.
A leaf whose spec names the data axis becomes a :class:`Sharded` -- one
contiguous piece a data position, each on that position's device; a leaf
that nothing divides stays whole on the first data device (one piece,
``dim`` None), as the reference replicates it.  :func:`adamw_update` runs
piece by piece; :func:`params_from_master` is the all-gather, casting each
piece into its slice of a working parameter.  The update is elementwise,
so a sharded state steps bitwise as the whole one, except for the global
norm: over sharded gradients it adds per-piece partial sums, as XLA's
sharded reduction does, so it (and a step that clips by it) agrees to
rounding only.  With a model axis above 1 (tensor parallelism,
``train/step.py``'s ``SplitTrainState``) each model piece's state is split
over the data positions of its model index, in mesh order, by the spec
the piece's leaf widens to; :func:`adamw_update` then takes the norm of
every piece's gradients (``gnorm``), computed once for all of them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import (Callable, Dict, Iterator, List, Mapping, NamedTuple,
                    Optional, Sequence, Tuple, Union)

import torch

from repro_torch.distributed.mesh import MODEL_AXIS, Mesh, axis_size
from repro_torch.distributed.sharding import Spec
from repro_torch.launch import cost_analysis as CA

Params = Mapping[str, torch.Tensor]


class Sharded(NamedTuple):
    """One leaf of a ZeRO-1 state: contiguous pieces along ``dim``, one a
    data position in mesh order, each on that position's device (pieces
    may share a device); ``dim`` None: the whole leaf, one piece (a split
    state's: one copy a data position, all equal)."""

    shards: Tuple[torch.Tensor, ...]
    dim: Optional[int]

    def slices(self, whole: torch.Tensor
               ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Each piece beside the slice of ``whole`` (a tensor of the
        leaf's shape) it holds."""
        if self.dim is None:
            for t in self.shards:
                yield t, whole
            return
        off = 0
        for t in self.shards:
            n = t.shape[self.dim]
            yield t, whole.narrow(self.dim, off, n)
            off += n

    def gather(self, device=None) -> torch.Tensor:
        """The whole leaf, on ``device`` (default: the first piece's)."""
        dev = self.shards[0].device if device is None else device
        if self.dim is None:
            return self.shards[0].to(dev)
        return torch.cat([t.to(dev) for t in self.shards], dim=self.dim)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Sharded":
        return Sharded(tuple(fn(t) for t in self.shards), self.dim)


Leaf = Union[torch.Tensor, Sharded]


class AdamWState(NamedTuple):
    step: torch.Tensor                 # () int32, on the first data device
    master: Dict[str, Leaf]            # fp32 master copy
    m: Dict[str, Leaf]                 # fp32 first moment
    v: Dict[str, Leaf]                 # fp32 second moment


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # names (substrings) excluded from weight decay
    no_decay_substrings: Tuple[str, ...] = ("norm", "bias", "scale", "dt_bias", "a_log", "d_skip")


def init_adamw(params: Params) -> AdamWState:
    """Master copies and zero moments, on the parameters' devices."""
    master = {k: p.detach().float().clone() for k, p in params.items()}
    dev = next(iter(master.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev), master=master,
        m={k: torch.zeros_like(x) for k, x in master.items()},
        v={k: torch.zeros_like(x) for k, x in master.items()})


def global_norm(tree: Mapping[str, Leaf]) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, on the first leaf's
    device; a :class:`Sharded` leaf adds its pieces' partial sums."""
    dev = None
    total = 0
    for t in tree.values():
        parts = t.shards if isinstance(t, Sharded) else (t,)
        dev = parts[0].device if dev is None else dev
        total = total + sum(torch.sum(torch.square(x.float())).to(dev)
                            for x in parts)
    return torch.sqrt(total)


def _like(g: Leaf, master: Leaf) -> Leaf:
    """The gradient ``g`` in ``master``'s layout: a whole tensor split into
    ``master``'s pieces (each on its piece's device), a :class:`Sharded`
    gathered onto a whole master's device."""
    if isinstance(master, Sharded):
        if isinstance(g, Sharded):
            if g.dim != master.dim or len(g.shards) != len(master.shards):
                raise ValueError("gradient and master are sharded "
                                 "differently")
            return g
        return Sharded(tuple(sl.to(t.device) for t, sl in master.slices(g)),
                       master.dim)
    return g.gather(master.device) if isinstance(g, Sharded) else g


def _adam_leaf(cfg: AdamWConfig, decay: bool, master, m, v, g, k: dict):
    g = g.float() * k["clip"]
    m1 = cfg.b1 * m + (1.0 - cfg.b1) * g
    v1 = cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g)
    update = (m1 / k["b1c"]) / (torch.sqrt(v1 / k["b2c"]) + k["eps"])
    if decay:
        update = update + cfg.weight_decay * master
    return master - k["lr"] * update, m1, v1


MASTER_SLACK = 1.0       # master_gap_bound's factor above the linear term


def master_gap_bound(cfg: AdamWConfig, step: int, master: torch.Tensor,
                     m_ref: torch.Tensor, m_other: torch.Tensor,
                     v_ref: torch.Tensor, lr: float, *,
                     rtol: float = 1e-5, atol: float = 1e-6
                     ) -> torch.Tensor:
    """How far two AdamW states that start from the same master may differ
    in their new master, element by element, given their new first
    moments: ``lr · |Δm̂| / (√v̂ + eps) · (1 + MASTER_SLACK)`` plus ``rtol ·
    |master| + atol`` for the float32 noise of the rest of the update.

    ``Δm̂`` is the moments' difference, bias-corrected at ``step`` (the
    step the new state has taken), and ``v̂`` the reference's second
    moment, bias-corrected.  The update ``m̂ / (√v̂ + eps)`` moves by at most
    ``|Δm̂| / (√v̂ + eps)`` for a small difference, the second moment's own
    change pulling the other way; at the first step a difference that
    flips the sign of a gradient near eps moves it by up to twice that,
    which the slack covers.  A gradient far below eps (the split's float32
    reordering of a 1e-9 gradient) is thus held to what its own noise can
    do, not to a share of ``lr``."""
    b1c = 1.0 - cfg.b1 ** step
    b2c = 1.0 - cfg.b2 ** step
    dm = (m_other.float() - m_ref.float()).abs() / b1c
    vhat = v_ref.float() / b2c
    return (lr * (1.0 + MASTER_SLACK) * dm / (vhat.sqrt() + cfg.eps)
            + rtol * master.float().abs() + atol)


def adamw_update(
    cfg: AdamWConfig,
    grads: Params,
    state: AdamWState,
    lr_scale: Union[torch.Tensor, float] = 1.0,
    gnorm: Optional[torch.Tensor] = None,
) -> Tuple[Dict[str, torch.Tensor], AdamWState]:
    """One AdamW step.  Returns (new fp32 master, new state); the inputs are
    not modified.  ``gnorm``: the global norm the clip uses, when the
    gradients are one part of a larger tree (default: theirs)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    # the step's scalars: bookkeeping a cost counter leaves out (a split
    # state's are computed once a model index, not once a position)
    with CA.paused():
        step = state.step + 1
        c = gnorm.new_tensor
        clip = torch.clamp(c(cfg.grad_clip) / torch.clamp(gnorm, min=1e-12),
                           max=1.0)
        stepf = step.float()
        b1c = 1.0 - c(cfg.b1) ** stepf
        b2c = 1.0 - c(cfg.b2) ** stepf
        lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                      device=gnorm.device)
        scalars = dict(clip=clip, b1c=b1c, b2c=b2c, lr=lr, eps=c(cfg.eps))
    on: Dict[torch.device, dict] = {gnorm.device: scalars}

    def at(dev: torch.device) -> dict:
        if dev not in on:
            with CA.paused():
                on[dev] = {k: x.to(dev) for k, x in scalars.items()}
        return on[dev]

    master_new, m_new, v_new = {}, {}, {}
    for name, g in grads.items():
        master, m, v = state.master[name], state.m[name], state.v[name]
        g = _like(g, master)
        decay = cfg.weight_decay > 0 and not any(
            s in name for s in cfg.no_decay_substrings)
        if isinstance(master, Sharded):
            out = [_adam_leaf(cfg, decay, *ts, at(ts[0].device))
                   for ts in zip(master.shards, m.shards, v.shards,
                                 g.shards)]
            master_new[name], m_new[name], v_new[name] = (
                Sharded(tuple(o[i] for o in out), master.dim)
                for i in range(3))
        else:
            master_new[name], m_new[name], v_new[name] = _adam_leaf(
                cfg, decay, master, m, v, g, at(master.device))
    return master_new, AdamWState(step=step, master=master_new, m=m_new,
                                  v=v_new)


@torch.no_grad()
def params_from_master(master: Mapping[str, Leaf], like: Params) -> None:
    """Copy the fp32 master into the working parameters, in place (cast to
    each parameter's dtype, round to nearest even as ``astype`` does); a
    :class:`Sharded` leaf's pieces go into their slices of the parameter
    (the all-gather, with no whole float32 leaf made)."""
    for k, p in like.items():
        w = master[k]
        if isinstance(w, Sharded):
            for t, sl in w.slices(p):
                sl.copy_(t)
        else:
            p.copy_(w)


# --------------------------------------------------------------------------- #
# ZeRO-1 sharding of the optimizer state
# --------------------------------------------------------------------------- #

def zero1_spec(spec: Spec, shape: Tuple[int, ...], mesh: Mesh,
               data_axis: str = "data") -> Spec:
    """Widen a param spec with the data axis (largest free dim).

    Picks the largest dimension not already sharded whose size divides the
    data-axis size, and adds ``data_axis`` there.  Falls back to the
    original spec when nothing divides (tiny tensors stay replicated --
    they are negligible).
    """
    if data_axis not in mesh.axis_names:
        return spec
    dsize = mesh.shape[data_axis]
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in entries:
        if e is None:
            continue
        used.update(e if isinstance(e, tuple) else (e,))
    if data_axis in used:
        return spec
    # candidate dims: unsharded, divisible by dsize
    cands = [(shape[i], i) for i, e in enumerate(entries)
             if e is None and shape[i] % dsize == 0 and shape[i] >= dsize]
    if not cands:
        # try widening an already-sharded dim with (existing, data)
        for i, e in enumerate(entries):
            if e is None:
                continue
            ax = e if isinstance(e, tuple) else (e,)
            size = 1
            for a in ax:
                size *= mesh.shape[a]
            if shape[i] % (size * dsize) == 0:
                entries[i] = tuple(ax) + (data_axis,)
                return tuple(entries)
        return spec
    _, dim = max(cands)
    entries[dim] = data_axis
    return tuple(entries)


def zero1_state_shardings(param_specs: Mapping[str, Spec],
                          param_shapes: Mapping[str, Tuple[int, ...]],
                          mesh: Mesh, data_axis: str = "data") -> AdamWState:
    """The ZeRO-1 specs of an :class:`AdamWState` given per-param specs
    and shapes: ``master``, ``m`` and ``v`` widened by :func:`zero1_spec`,
    ``step`` replicated (``()``)."""
    master = {k: zero1_spec(spec, tuple(param_shapes[k]), mesh, data_axis)
              for k, spec in param_specs.items()}
    return AdamWState(step=(), master=master, m=dict(master),
                      v=dict(master))


def data_devices(mesh: Mesh, data_axis: str = "data",
                 model_index: int = 0) -> List[torch.device]:
    """The devices a ZeRO-1 state is split over: the data axis's positions
    at model index ``model_index`` (the first position of every other
    axis).  Raises for an abstract mesh."""
    if mesh.devices is None:
        raise ValueError("a ZeRO-1 state needs a mesh with devices, got an "
                         "abstract one")
    m = axis_size(mesh, MODEL_AXIS)
    if not 0 <= model_index < m:
        raise ValueError(f"model index {model_index} of an axis of {m}")
    devs = mesh.devices_along((data_axis, MODEL_AXIS))
    return devs[model_index::m]


def _split_dim(spec: Spec, data_axis: str) -> Optional[int]:
    for i, e in enumerate(spec):
        if e == data_axis or (isinstance(e, tuple) and data_axis in e):
            return i
    return None


def _split(t: torch.Tensor, dim: Optional[int],
           devices: Sequence[torch.device]) -> Sharded:
    """``t`` in float32, split along ``dim`` over ``devices`` into copies
    (``dim`` None: whole, on the first device; a contiguous float32 tensor
    already there is taken as it is)."""
    if dim is None:
        if (t.device == devices[0] and t.dtype == torch.float32
                and t.is_contiguous()):
            return Sharded((t,), None)
        pieces = ((t, devices[0]),)
    else:
        n = t.shape[dim] // len(devices)
        pieces = ((t.narrow(dim, j * n, n), d) for j, d in enumerate(devices))
    out = []
    for piece, dev in pieces:
        c = torch.empty(piece.shape, dtype=torch.float32, device=dev)
        c.copy_(piece)
        out.append(c)
    return Sharded(tuple(out), dim)


class _Zero1Constraint:
    """The ZeRO-1 layout as a gradient constraint (the port of the
    reference's ``with_sharding_constraint`` on ``NamedSharding``s): maps
    ``{name: whole float32 gradient}`` -- any subset of the names -- to
    ``{name: Sharded}``, splitting each leaf by its spec's data axis over
    the mesh's data devices; a leaf already :class:`Sharded` passes
    through."""

    def __init__(self, mesh: Mesh, specs: Mapping[str, Spec],
                 data_axis: str = "data"):
        self.devices = data_devices(mesh, data_axis)
        self.dims = {k: _split_dim(spec, data_axis)
                     for k, spec in specs.items()}

    def __call__(self, tree: Mapping[str, Leaf]) -> Dict[str, Sharded]:
        return {k: g if isinstance(g, Sharded)
                else _split(g, self.dims[k], self.devices)
                for k, g in tree.items()}


def zero1_grad_constraint(mesh: Mesh, specs: Mapping[str, Spec],
                          data_axis: str = "data") -> _Zero1Constraint:
    """The ``grad_constraint`` of ``make_train_step`` for a mesh and the
    ZeRO-1 specs (``zero1_state_shardings(...).master``)."""
    return _Zero1Constraint(mesh, specs, data_axis)


def shard_state(state: AdamWState, constraint: _Zero1Constraint
                ) -> AdamWState:
    """``state`` split into ``constraint``'s layout, by copy, leaf by leaf:
    each whole leaf is dropped from ``state``'s dicts as soon as its pieces
    exist, so no whole float32 leaf outlives its split (the caller's
    ``state`` is left with empty ``master``/``m``/``v``).  ``step`` moves
    to the first data device."""
    parts = {}
    for part in ("master", "m", "v"):
        src = getattr(state, part)
        parts[part] = {}
        for k in list(src):
            parts[part][k] = constraint({k: src[k]})[k]
            del src[k]
    return AdamWState(step=state.step.to(constraint.devices[0]), **parts)
