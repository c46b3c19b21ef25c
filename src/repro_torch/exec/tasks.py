"""Work units the executor runs (the port of ``repro/exec/tasks.py``).

A :class:`StageTask` is the executor's unit of computation, quantized into
*supersteps*: the executor calls :meth:`StageTask.step` once per superstep
and may persist the returned payload at any superstep boundary.  The
contract that makes crash-and-resume testable end to end:

* **Determinism** -- ``step`` is a pure function of ``(payload,
  superstep)`` and ``init`` of the dependency payloads, so a run killed at
  superstep s and resumed from the last committed checkpoint produces a
  final payload bit-identical to an uninterrupted run on the same device.
* **Serializability** -- payloads are ``{name: tensor}`` dicts on the
  task's device, exactly what :mod:`repro_torch.ckpt.store` persists with
  integrity hashes.

Two tasks: :class:`MixTask`, a cheap deterministic float64 recurrence, and
:class:`PowerIterTask`, a float32 power iteration whose matrix rides inside
the checkpoint and whose matvec runs on the device.  Both take ``device``:
``None`` is CUDA (raising without a card), ``"cpu"`` the CPU.

Across devices and against the reference the payloads agree to rounding,
not bit for bit: ``cos`` on the card and a torch sum reduce in another
order and round the last bits differently from numpy's pairwise sums.
:func:`from_reference_payload` carries a reference task's numpy payload
across (its PRNG-drawn matrix included, which torch cannot redraw).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.device import F64, div, resolve_device


@runtime_checkable
class StageTask(Protocol):
    """One stage's work unit, advanced one superstep at a time."""

    def init(self, deps: Dict[str, Any]) -> Any:
        """The superstep-0 payload, folding in dependency outputs."""
        ...

    def step(self, payload: Any, superstep: int) -> Any:
        """The payload after executing ``superstep`` (pure, deterministic)."""
        ...


def _fold_scalar(payload: Any) -> float:
    """A deterministic scalar digest of a dependency payload, so DAG edges
    are load-bearing: corrupting or dropping a dependency changes every
    downstream payload.  Leaves in key order, each the float64 sum of its
    elements' cosines."""
    leaves = ([payload[key] for key in sorted(payload)]
              if isinstance(payload, dict) else [payload])
    total = 0
    for leaf in leaves:
        t = torch.as_tensor(leaf).to(F64)
        total = total + float(torch.cos(t).sum())
    return float(total)


def from_reference_payload(payload_np: Dict[str, Any],
                           device=None) -> Dict[str, torch.Tensor]:
    """A reference task's numpy payload as the port's: each leaf a tensor
    of the same dtype and shape on ``device`` (``None``: CUDA)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
            for k, v in payload_np.items()}


@dataclass(frozen=True)
class MixTask:
    """Cheap deterministic float64 recurrence (tests, the digital twin).

    ``x`` evolves by a contractive cosine map salted per superstep, and
    ``checksum`` accumulates a running digest -- any lost or repeated
    superstep changes the final checksum, which is how the resume tests
    detect silently dropped work.
    """

    dim: int = 64
    salt: int = 0
    device: Optional[str] = None

    def init(self, deps: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        dev = resolve_device(self.device)
        x = div(torch.arange(self.dim, dtype=F64, device=dev) + 1.0,
                float(self.dim)) + float(self.salt)
        for name in sorted(deps):
            x = x + 1e-3 * _fold_scalar(deps[name])
        return {"x": x, "checksum": torch.zeros((), dtype=F64, device=dev)}

    def step(self, payload: Dict[str, Any], superstep: int
             ) -> Dict[str, torch.Tensor]:
        x = torch.cos(payload["x"] * 1.0001) + 1e-6 * (superstep + self.salt)
        return {"x": x, "checksum": payload["checksum"] + x.sum()}


@dataclass(frozen=True)
class PowerIterTask:
    """A real work unit: power iteration on a PSD float32 matrix.

    The matrix is derived from ``seed`` (a ``torch.Generator`` on the CPU,
    so every device starts from the same bits) and carried in the payload,
    so it is checkpointed with the state the way optimizer state rides a
    training checkpoint.  Each superstep is one matvec and a normalize on
    the device, converging ``eig`` to the dominant eigenvalue.
    """

    dim: int = 128
    seed: int = 0
    device: Optional[str] = None

    def init(self, deps: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        dev = resolve_device(self.device)
        gen = torch.Generator(device="cpu").manual_seed(int(self.seed))
        a = torch.randn(self.dim, self.dim, generator=gen,
                        dtype=torch.float32).to(dev)
        mat = div(a @ a.T, float(self.dim)) + torch.eye(
            self.dim, dtype=torch.float32, device=dev)
        v = torch.ones(self.dim, dtype=torch.float32, device=dev)
        for name in sorted(deps):
            v = v + torch.tensor(1e-3 * _fold_scalar(deps[name]),
                                 dtype=torch.float32, device=dev)
        return {"mat": mat, "v": v / torch.linalg.vector_norm(v),
                "eig": torch.zeros((), dtype=torch.float32, device=dev)}

    def step(self, payload: Dict[str, Any], superstep: int
             ) -> Dict[str, torch.Tensor]:
        mat, v = payload["mat"], payload["v"]
        w = mat @ v
        return {"mat": mat, "v": w / torch.linalg.vector_norm(w),
                "eig": torch.dot(v, w)}
