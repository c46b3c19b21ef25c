"""What the metric files under ``metrics/`` compute, each from the run's
window records (host clock), its trace summary and the counts.  A reader
that finds nothing to read returns None, and the metric is left out of
the line; none returns 0 for a share of a peak or a roofline."""
from __future__ import annotations

from typing import Optional


def tokens_per_s(run) -> Optional[float]:
    """Tokens of every unit of the window over the window's time."""
    if not run.records or run.window_s <= 0:
        return None
    return sum(r["tokens"] for r in run.records) / run.window_s


def enqueue_share(run) -> Optional[float]:
    """Host seconds inside the program's call over the units' wall time,
    in %."""
    wall = sum(r["t1"] - r["t0"] for r in run.records)
    if wall <= 0:
        return None
    return 100.0 * sum(r["t_call"] - r["t0"] for r in run.records) / wall


def mfu(run) -> Optional[float]:
    """The model operations of the window's units over its time, over
    the card's dense bf16 peak, in %."""
    if run.peaks is None or run.window_s <= 0 or not run.records:
        return None
    flops = len(run.records) * run.bench.unit_flops()
    return 100.0 * flops / run.window_s / run.peaks["bf16_flops_per_s"]


def nonproduct_share(run) -> Optional[float]:
    """Device time of operators that are neither matrix products nor the
    port's kernels, over the window's device time, in % (the window
    traced with the host's operators)."""
    t = run.ops
    if t is None or t.device_s <= 0:
        return None
    return 100.0 * (t.device_s - t.product_s - t.port_s) / t.device_s


def idle_share(run) -> Optional[float]:
    """The window's time with no device activity, in % (the window
    traced with the device's activity alone)."""
    t = run.trace
    if t is None or t.window_s <= 0 or t.device_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline(run, kernel: str) -> Optional[float]:
    """The bound time of the kernel's work in the traced window's units
    over the kernel's device time there, in %.  The work is the
    yardstick's for one unit (``counts.kernel_work``: a layer's call
    times the model's layers that make it), whatever calls run it; its
    bound the larger of operations over the bf16 peak and bytes over the
    memory bandwidth."""
    t = run.trace
    if t is None or run.peaks is None:
        return None
    work = run.bench.kernel_work(kernel)
    secs = t.port_kernel_s(kernel)
    if work is None or secs <= 0 or run.traced_units == 0:
        return None
    p = run.peaks
    bound = max(work["flops"] / p["bf16_flops_per_s"],
                work["bytes"] / p["hbm_bytes_per_s"])
    return 100.0 * run.traced_units * bound / secs
