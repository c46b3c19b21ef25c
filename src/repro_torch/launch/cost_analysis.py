"""Per-op cost counting of one device's program (the port's counterpart of
``repro/launch/hlo_analysis.py``).

The reference reads XLA's compiled, partitioned HLO, recovers every while
loop's trip count and multiplies the loop bodies by it.  Eager PyTorch runs
each op as it comes, so a Python loop over layers or microbatches is
counted as it executes and no trip count is recovered.  :class:`CostCounter`
is a ``TorchDispatchMode`` over one program (on the meta device for the dry
run, on the card for the check that it counts what runs):

* **FLOPs** of the products, by ``torch.utils.flop_counter``'s formulas
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions and their
  backwards: 2 · prod(result) · prod(contracting dims), the reference's
  ``dot`` and ``convolution`` count);
* **bytes** of each op's tensor operands and results: every eager op is a
  kernel boundary, which is the reference's fusion-boundary convention.
  Views and aliases move nothing and count nothing; an uninitialised
  ``empty`` counts nothing;
* **collective bytes by kind** (the reference's names,
  :data:`COLLECTIVE_OPS`), reported by ``distributed.collectives``: the
  bytes one device puts in, as the reference counts an HLO collective's
  operands;
* **the hand-written kernels' work**, reported by their wrappers
  (:func:`report_kernel`), which launch through ctypes under no torch
  operator, so no dispatch mode sees them: flash attention the dense
  products its plain version runs, the SSD scan ``ssd_chunked``'s
  products, the quant and sim-step kernels their bytes only;
* **a high-water mark of live bytes**: every storage a non-aliasing op
  creates under the mode is held until its last tensor dies
  (``weakref.finalize`` on the storage object, since meta tensors all have
  ``data_ptr() == 0`` and views share storages).

Reports run through module-level functions so the kernels and the
collectives need no counter at hand; with no counter active they do
nothing.  :func:`paused` stops the counting of FLOPs and bytes (the
collectives' own sums and copies are communication, counted by kind), but
not the tracking of live storages.
"""
from __future__ import annotations

import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_ACTIVE: List["CostCounter"] = []
_PAUSED = [0]
_UNINITIALISED = frozenset({"empty", "empty_strided", "empty_like",
                            "new_empty", "new_empty_strided"})


@dataclass
class CostReport:
    """What one device's program costs (the fields of ``HloReport`` that
    apply, plus the kernels' reports, the op count and the live-bytes
    high-water mark)."""

    dot_flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, float] = field(default_factory=dict)
    kernel_flops: float = 0.0         # of dot_flops, reported by kernels
    kernel_bytes: float = 0.0         # of bytes_accessed, likewise
    n_ops: int = 0
    high_water_bytes: int = 0         # live bytes made under the counter

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def to_dict(self) -> dict:
        return {
            "dot_flops": self.dot_flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": dict(self.collective_bytes),
            "collective_counts": dict(self.collective_counts),
            "total_collective_bytes": self.total_collective_bytes,
            "kernel_flops": self.kernel_flops,
            "kernel_bytes": self.kernel_bytes,
            "n_ops": self.n_ops,
            "high_water_bytes": self.high_water_bytes,
        }


def _counting() -> List["CostCounter"]:
    return [] if _PAUSED[0] else _ACTIVE


@contextmanager
def paused():
    """Stop counting FLOPs and bytes inside (live storages are still
    tracked)."""
    _PAUSED[0] += 1
    try:
        yield
    finally:
        _PAUSED[0] -= 1


def report_kernel(flops: float = 0.0, nbytes: float = 0.0) -> None:
    """A hand-written kernel's work (its wrapper reports it where it
    launches the kernel, or stands in for it on the meta device)."""
    for c in _counting():
        r = c.report
        r.dot_flops += flops
        r.kernel_flops += flops
        r.bytes_accessed += nbytes
        r.kernel_bytes += nbytes


def report_collective(kind: str, nbytes: float) -> None:
    """One collective of ``kind`` (:data:`COLLECTIVE_OPS`) that puts
    ``nbytes`` of one device's data in."""
    if kind not in COLLECTIVE_OPS:
        raise ValueError(f"unknown collective {kind!r}")
    for c in _counting():
        r = c.report
        r.collective_bytes[kind] = r.collective_bytes.get(kind, 0.0) + nbytes
        r.collective_counts[kind] = r.collective_counts.get(kind, 0.0) + 1


_COMPOSITE: set = set()
_PRIMITIVE: set = set()


def _composite(func) -> bool:
    has = torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
    (_COMPOSITE if has else _PRIMITIVE).add(func)
    return has


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts the program run under it (see the module docstring); the
    result is :attr:`report`."""

    def __init__(self):
        super().__init__()
        self.report = CostReport()
        self._live: Dict[int, int] = {}
        self._live_bytes = 0
        self._depth = 0

    def __enter__(self):
        if not self._depth:
            _ACTIVE.append(self)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if not self._depth:
            _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._live_bytes += n
        weakref.finalize(st, self._free, key)
        r = self.report
        r.high_water_bytes = max(r.high_water_bytes, self._live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _COMPOSITE or (func not in _PRIMITIVE and _composite(func)):
            # under inference mode a composite op (matmul, einsum) reaches
            # the mode whole: run its decomposition, whose ops come back
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        returns = func._schema.returns
        aliasing = any(r.alias_info is not None for r in returns)
        if not aliasing:
            for t in outs:
                self._track(t)
        if _PAUSED[0]:
            return out
        r = self.report
        r.n_ops += 1
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            r.dot_flops += count(*args, **kwargs, out_val=out)
        writes = any(r_.alias_info is not None and r_.alias_info.is_write
                     for r_ in returns)
        if aliasing and not writes:
            return out          # a view: nothing moves
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        moved = sum(nbytes(t) for t in ins)
        if func.overloadpacket.__name__ not in _UNINITIALISED:
            moved += sum(nbytes(t) for t in outs)
        r.bytes_accessed += moved
        return out
