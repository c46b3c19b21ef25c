"""The traced run: ``torch.profiler`` over a window, reduced once to
what the per-layer readers need.

A traced run profiles two windows after its untraced one: one with the
device's activity alone (``device``), which the host's profiling cannot
slow, for the idle share, the kernels' device times and the rooflines;
and one with the host's operators too (``host``), for the attribution of
device time to operators and the labels of the idle gaps.

* The window is the benchmark's own span ``perfbench.window``; device
  activity (kernels, copies, sets) is clipped to it.  Where the trace has
  no host events, every device event is the window's (the window starts
  and ends with a synchronisation) and its length is the host clock's.
* ``busy_s``: the union of the device intervals; the idle share is the
  rest of the window.
* Operator attribution copies ``chip_smoke.py``'s ``_operator_kernels``
  rule: every CPU event that launched kernels owns their device time,
  except CUPTI's "Command Buffer Full" events (the host waiting on a full
  launch queue), whose kernels their operators carry too.  A kernel is a
  product's where its operator or an ancestor of it is a matrix product
  (``aten::mm``, ``bmm``, ``addmm``, ``baddbmm``, ``matmul``, ``einsum``,
  ``linear`` and their backward nodes).
* The port's hand-written kernels are named by their files under
  ``kernels/`` (``NAMES``): they launch through ctypes under no operator,
  and are told by their names.
* The idle gaps between device intervals are labelled by the innermost
  host event that spans the gap's start.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Tuple

WINDOW_SPAN = "perfbench.window"
PRODUCT_OPS = frozenset({
    "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::matmul",
    "aten::einsum", "aten::linear", "aten::_scaled_mm"})
_PRODUCT_BACKWARD = re.compile(
    r"(Mm|Bmm|Addmm|Baddbmm|Matmul|Einsum|Linear|UnsafeMm)Backward")
COMMAND_BUFFER_FULL = "Command Buffer Full"


def _is_product(names: Iterable[str]) -> bool:
    return any(n in PRODUCT_OPS or _PRODUCT_BACKWARD.search(n)
               for n in names)


@contextmanager
def profiled(what: Optional[str]):
    """A ``torch.profiler`` context: None (no profiler), ``"device"``
    (the device's activity alone; the CPU's where there is no card) or
    ``"host"`` (the CPU's and the device's)."""
    if what is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA] if card else [ProfilerActivity.CPU]
    if what == "host" and card:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts, record_shapes=False,
                 with_stack=False) as prof:
        yield prof


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class TraceSummary:
    """The window's trace, reduced.  Times in seconds."""

    def __init__(self, prof, host_window_s: float):
        from torch.autograd import DeviceType

        from . import counts

        self.port_kernels = {k: counts.kernel(k).NAMES
                             for k in counts.kernel_names()}
        events = prof.events()
        self.skipped = 0
        win = [e for e in events if e.name == WINDOW_SPAN
               and e.device_type == DeviceType.CPU]
        if win:
            w0, w1 = win[0].time_range.start, win[0].time_range.end
            self.window_s = (w1 - w0) * 1e-6
        else:
            ranges = [e.time_range for e in events
                      if e.device_type != DeviceType.CPU]
            w0 = min((r.start for r in ranges), default=0.0)
            w1 = max((r.end for r in ranges), default=0.0)
            self.window_s = host_window_s
        dev_set = set()
        host: List[Tuple[float, float, str]] = []
        self.product_s = 0.0
        spans = {e.name for e in events if e.device_type == DeviceType.CPU
                 and (getattr(e, "is_user_annotation", False)
                      or e.name.startswith("perfbench."))}
        for e in events:
            t0, t1 = e.time_range.start, e.time_range.end
            if e.device_type != DeviceType.CPU:
                # a span's device-side copy is no device work
                if getattr(e, "is_user_annotation", False) \
                        or e.name in spans:
                    self.skipped += 1
                    continue
                a, b = max(t0, w0), min(t1, w1)
                if b > a:
                    dev_set.add((e.name, a, b))
                continue
            if t1 > w0 and t0 < w1 and e.name != WINDOW_SPAN:
                host.append((t0, t1, e.name))
            if not e.kernels or e.name == COMMAND_BUFFER_FULL \
                    or not (w0 <= t0 <= w1):
                continue
            own = sum(k.duration for k in e.kernels
                      if not self._is_port(k.name))
            if own <= 0:
                continue
            names = [e.name]
            p = e.cpu_parent
            while p is not None:
                names.append(p.name)
                p = p.cpu_parent
            if _is_product(names):
                self.product_s += own * 1e-6
        dev = sorted(dev_set, key=lambda x: x[1])
        self.device_s = sum(b - a for _, a, b in dev) * 1e-6
        by_name: Dict[str, float] = defaultdict(float)
        count: Dict[str, int] = defaultdict(int)
        for n, a, b in dev:
            by_name[n] += (b - a) * 1e-6
            count[n] += 1
        self.by_name = dict(by_name)
        self.count = dict(count)
        busy = _merge([(a, b) for _, a, b in dev])
        self.busy_s = sum(b - a for a, b in busy) * 1e-6
        self.gaps = self._label_gaps(busy, host, w0, w1)

    def _is_port(self, name: str) -> bool:
        return any(k in name for ks in self.port_kernels.values()
                   for k in ks)

    def port_kernel_s(self, kernel: str) -> float:
        return sum(s for n, s in self.by_name.items()
                   if any(k in n for k in self.port_kernels[kernel]))

    def diagnostics(self) -> Dict[str, object]:
        return {"device_events": sum(self.count.values()),
                "annotations_skipped": self.skipped,
                "window_s": self.window_s, "device_s": self.device_s,
                "busy_s": self.busy_s, "product_s": self.product_s,
                **{f"{k}_s": self.port_kernel_s(k)
                   for k in self.port_kernels}}

    @property
    def port_s(self) -> float:
        return sum(self.port_kernel_s(k) for k in self.port_kernels)

    @staticmethod
    def _label_gaps(busy, host, w0: float, w1: float
                    ) -> Dict[str, float]:
        """Idle seconds by the innermost host event spanning each gap's
        start (the window's edges count as gaps too)."""
        host.sort()
        starts = [h[0] for h in host]
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        out: Dict[str, float] = defaultdict(float)
        for i in range(0, len(edges), 2):
            g0, g1 = edges[i], edges[i + 1]
            if g1 <= g0:
                continue
            label = "(no host event)"
            j = bisect.bisect_right(starts, g0) - 1
            for k in range(j, max(-1, j - 4000), -1):
                if host[k][1] >= g0:
                    label = host[k][2]
                    break
            out[label] += (g1 - g0) * 1e-6
        return dict(out)

    def device_ops(self, n: int = 10) -> List[List]:
        """The device operations that took most time."""
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:120], v] for k, v in ops]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest idle gaps by what the host was doing."""
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:120], v] for k, v in gaps]


def summarize(prof, host_window_s: float) -> Optional[TraceSummary]:
    return None if prof is None else TraceSummary(prof, host_window_s)
