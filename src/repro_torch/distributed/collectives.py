"""Collectives over the pieces of one mesh axis, from a single controller.

The port runs a split model from one Python thread: a value that lives on
every position of an axis is a list of tensors, one a position in mesh
order, each on its position's device (positions may share a device: a
mesh of ``cuda:0`` repeated splits one card).  Three collectives combine
them, as ``jax.lax.psum`` / ``all_gather`` / ``psum_scatter`` do in a
partitioned program:

* :func:`all_reduce` -- the sum, on every position;
* :func:`all_gather` -- the pieces concatenated along ``dim``, on every
  position;
* :func:`reduce_scatter` -- the sum, split along ``dim``, position ``j``
  keeping part ``j``.

Sums run in mesh order (position 0 + 1 + ...), in float32 for floating
pieces and rounded once to the pieces' dtype, so a result does not depend
on the devices.  Each is an ``autograd.Function`` whose backward is the
conjugate collective (the sum's backward broadcasts the summed gradient,
the gather's is a reduce-scatter, the reduce-scatter's a gather), so a
gradient crosses devices the way the value did.  No thread waits on
another: PyTorch's autograd engine runs one worker thread a CUDA device,
and on a mesh that repeats ``cuda:0`` a barrier inside a backward would
never be met.

Each call reports the bytes one device puts in to the active cost counter
(``launch.cost_analysis``), under the reference's names: the all-reduce
and all-gather a piece, the reduce-scatter the whole local tensor.  The
sums and copies themselves are communication and are not counted as
bytes of the program.  ``origin=False`` reports nothing: a caller that
runs the same collective in several groups (one a data position) reports
only the group that holds mesh position 0, whose program the counter
describes.

A list shorter than the axis (``extent``) stands for the first positions
of it, on the meta device only: the dry run runs mesh position 0's
program alone, and the collectives give it results of the right shapes
(an all-gather ``extent`` times as long along ``dim``, a reduce-scatter's
part ``1/extent``) and count what that position would put in.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.launch import cost_analysis as CA


def _extent(pieces: Sequence[torch.Tensor], extent: Optional[int]) -> int:
    m = len(pieces) if extent is None else int(extent)
    if not pieces or len(pieces) > m:
        raise ValueError(f"{len(pieces)} pieces for an axis of {m}")
    if len(pieces) < m and any(p.device.type != "meta" for p in pieces):
        raise ValueError(f"{len(pieces)} pieces for an axis of {m}: only "
                         f"the meta device stands for absent positions")
    return m


def _sum(pieces: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum in mesh order on the first piece's device, in float32 for
    floating pieces, rounded once to their dtype."""
    dev, dt = pieces[0].device, pieces[0].dtype
    acc = pieces[0].float() if dt.is_floating_point else pieces[0]
    for p in pieces[1:]:
        acc = acc + p.to(dev, acc.dtype)
    return acc.to(dt)


def _spread(t: torch.Tensor, like: Sequence[torch.Tensor],
            parts: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
    """``t`` (or ``parts[j]``) as a new tensor on each position's device."""
    return [(t if parts is None else parts[j]).to(p.device, copy=True)
            for j, p in enumerate(like)]


def _gather(pieces, dim: int, m: int) -> torch.Tensor:
    if len(pieces) < m:
        return torch.cat([pieces[0]] * m, dim=dim)
    dev = pieces[0].device
    return torch.cat([p.to(dev) for p in pieces], dim=dim)


def _scatter(pieces, dim: int, m: int) -> List[torch.Tensor]:
    if len(pieces) < m:
        n = pieces[0].shape[dim] // m
        return [p.narrow(dim, 0, n).clone() for p in pieces]
    parts = _sum(pieces).chunk(m, dim=dim)
    return _spread(None, pieces, list(parts))


def _check_split(pieces, dim: int, m: int) -> None:
    if pieces[0].shape[dim] % m:
        raise ValueError(f"dim {dim} of {tuple(pieces[0].shape)} does not "
                         f"split {m} ways")


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, origin, *pieces):
        ctx.m, ctx.origin = m, origin
        with CA.paused():
            if len(pieces) < m:
                return tuple(p.clone() for p in pieces)
            return tuple(_spread(_sum(pieces), pieces))

    @staticmethod
    def backward(ctx, *grads):
        grads = _fill(grads)
        if ctx.origin:
            CA.report_collective("all-reduce", CA.nbytes(grads[0]))
        with CA.paused():
            out = _AllReduce.forward(ctx, ctx.m, False, *grads)
        return (None, None) + tuple(out)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, dim, origin, *pieces):
        ctx.m, ctx.dim, ctx.origin = m, dim, origin
        with CA.paused():
            whole = _gather(pieces, dim, m)
            return tuple(_spread(whole, pieces))

    @staticmethod
    def backward(ctx, *grads):
        grads = _fill(grads)
        if ctx.origin:
            CA.report_collective("reduce-scatter", CA.nbytes(grads[0]))
        with CA.paused():
            out = _scatter(grads, ctx.dim, ctx.m)
        return (None, None, None) + tuple(out)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, dim, origin, *pieces):
        ctx.m, ctx.dim, ctx.origin = m, dim, origin
        with CA.paused():
            return tuple(_scatter(pieces, dim, m))

    @staticmethod
    def backward(ctx, *grads):
        grads = _fill(grads)
        if ctx.origin:
            CA.report_collective("all-gather", CA.nbytes(grads[0]))
        with CA.paused():
            whole = _gather(grads, ctx.dim, ctx.m)
            out = _spread(whole, grads)
        return (None, None, None) + tuple(out)


def _fill(grads) -> List[torch.Tensor]:
    """The output gradients, zeros for an output nothing used."""
    like = next(g for g in grads if g is not None)
    return [torch.zeros_like(like) if g is None else g for g in grads]


def all_reduce(pieces: Sequence[torch.Tensor], *, extent: Optional[int] = None,
               origin: bool = True) -> List[torch.Tensor]:
    """The sum of ``pieces`` (one a position, same shape), in mesh order,
    as a new tensor on every position's device."""
    m = _extent(pieces, extent)
    if origin:
        CA.report_collective("all-reduce", CA.nbytes(pieces[0]))
    return list(_AllReduce.apply(m, origin, *pieces))


def all_gather(pieces: Sequence[torch.Tensor], dim: int, *,
               extent: Optional[int] = None,
               origin: bool = True) -> List[torch.Tensor]:
    """``pieces`` concatenated along ``dim`` in mesh order, as a new tensor
    on every position's device."""
    m = _extent(pieces, extent)
    if origin:
        CA.report_collective("all-gather", CA.nbytes(pieces[0]))
    return list(_AllGather.apply(m, dim, origin, *pieces))


def reduce_scatter(pieces: Sequence[torch.Tensor], dim: int, *,
                   extent: Optional[int] = None,
                   origin: bool = True) -> List[torch.Tensor]:
    """The sum of ``pieces`` in mesh order, split into ``extent`` equal
    parts along ``dim``: part ``j`` on position ``j``'s device."""
    m = _extent(pieces, extent)
    _check_split(pieces, dim, m)
    if origin:
        CA.report_collective("reduce-scatter", CA.nbytes(pieces[0]))
    return list(_ReduceScatter.apply(m, dim, origin, *pieces))
