"""One run of one cell: set-up, the timed window, the check, the result.

The kind (``kinds/<kind>.py``) supplies a ``Bench`` with ``setup()``,
``unit(i)`` (one timed unit: a request or a step, ending in the read-back
its client waits for; returns a record with the host clock's ``t0``,
``t_call`` (the program's call returned) and ``t1``, the unit's
``tokens`` and ``ok``), ``release()`` (frees the program's state),
``check(precision)`` (the numbers compared with the plain reference) and
the counts the readers use (``unit_flops()``, ``kernel_work(kernel)``).

The window runs whole units until ``seconds`` have passed on the host
clock, then synchronises: a rate is the tokens of every unit over the
time from the window's start to the end of the last.  Every run has this
untraced window, and the metrics read by the host's clock come from it.
The traced run (``trace``) follows it with two more windows of the same
length under ``torch.profiler`` (``trace.py``): one with the device's
activity alone, for the idle share, the kernels' times and the
rooflines, and one with the host's operators too, for the attribution to
operators and the labels of the idle gaps.  The untraced run reads the
cell's end-to-end metrics, the traced run its per-layer metrics.
"""
from __future__ import annotations

import math
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from . import compare, core
from . import trace as T


@dataclass
class Run:
    """What the metric readers read."""

    bench: Any
    setup_s: float
    records: List[Dict[str, Any]]           # the untraced window's units
    window_s: float                         # its length (host clock)
    trace: Optional[T.TraceSummary]         # the device-only window
    traced_units: int                       # the units of that window
    ops: Optional[T.TraceSummary]           # the window with host events
    peaks: Optional[Dict[str, float]]


def peaks_for(device_name: str) -> Optional[Dict[str, float]]:
    table = core.read_json(core.BENCH_DIR / "harness" / "peaks.json")
    return table.get(device_name)


def _sync(device: str) -> None:
    import torch
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def window(bench, start: int, seconds: float, device: str,
           profile: Optional[str] = None):
    """Units ``start``, ``start + 1``, ... until ``seconds`` have passed,
    under the profiler ``profile`` names (``trace.profiled``); returns
    (records, host seconds, trace summary or None)."""
    from torch.autograd.profiler import record_function

    records = []
    with T.profiled(profile) as prof:
        _sync(device)
        with record_function(T.WINDOW_SPAN):
            t0 = time.perf_counter()
            i = start
            while True:
                records.append(bench.unit(i))
                i += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            _sync(device)
            t1 = time.perf_counter()
    return records, t1 - t0, T.summarize(prof, t1 - t0)


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def read_metrics(run: Run, specs: List[Dict[str, Any]]) -> Dict[str, dict]:
    out = {}
    for m in specs:
        reader = core.load_module(core.BENCH_DIR / "metrics"
                                  / f"{m['name']}.py")
        v = reader.read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(cell: core.Cell, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", scale: str = "full",
             t_start: Optional[float] = None,
             precision: str = "float32") -> Dict[str, Any]:
    """The result of one run (the last line's object)."""
    import torch

    t_start = time.time() if t_start is None else t_start
    bench = cell.kind.Bench(cell, seed, device, scale)
    bench.t_start, bench.marks = t_start, [("imports", time.time() - t_start)]
    bench.setup()
    _sync(device)
    setup_s = time.time() - t_start
    records, window_s, _ = window(bench, bench.first_unit, seconds, device)
    units = list(records)
    summary = ops = None
    traced_units = 0
    if traced:
        got, _, summary = window(bench, bench.first_unit + len(units),
                                 seconds, device, "device")
        units += got
        traced_units = len(got)
        got, _, ops = window(bench, bench.first_unit + len(units),
                             seconds, device, "host")
        units += got
        for what, t in (("device", summary), ("host", ops)):
            print(f"trace ({what}): {t.diagnostics()}", file=sys.stderr)
    on_card = device.startswith("cuda")
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    peak_mem = torch.cuda.max_memory_allocated() if on_card else 0
    run = Run(bench=bench, setup_s=setup_s, records=records,
              window_s=window_s, trace=summary,
              traced_units=traced_units, ops=ops,
              peaks=peaks_for(name) if on_card else None)
    metrics = read_metrics(run, cell.per_layer if traced
                           else cell.end_to_end)
    bad_modules = core.forbidden_loaded()
    bench.release()
    numbers = bench.check(precision)
    checks = compare.judge(numbers, cell.limits)
    dev = {"platform": "gpu" if on_card else "cpu", "kind": name,
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": int(peak_mem)}
    if on_card:
        dev["power_limit_w"] = power_limit_w()
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    failed = sum(1 for r in units if not r["ok"])
    result = {"correct": bool(checks) and failed == 0
              and all(c["ok"] for c in checks.values()),
              "attempted": len(units), "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = {"device_ops": summary.device_ops(),
                               "idle_gaps": ops.idle_gaps()}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    result["_readings"] = {k: v for k, v in numbers.items()
                           if k not in checks}
    result["_setup_marks"] = getattr(bench, "marks", [])
    result["_forbidden_modules"] = bad_modules
    return result


def emit(result: Dict[str, Any]) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard out."""
    import json

    marks = result.get("_setup_marks", [])
    if marks:
        print("setup: " + ", ".join(f"{n} {t:.2f} s" for n, t in marks),
              file=sys.stderr)
    for k, v in result.get("_readings", {}).items():
        print(f"reading {k} = {v!r} (not compared)", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    out = {k: v for k, v in result.items() if not k.startswith("_")}
    print(json.dumps(_plain(out), allow_nan=False), flush=True)


def _plain(x):
    """The result with every non-finite number as null (strict JSON)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x
