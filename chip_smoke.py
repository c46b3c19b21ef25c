"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # full run (one card, ~minutes)
    python3 chip_smoke.py --quick    # build + kernel checks at a small size

Drives only ``repro_torch`` (never jax, never the JAX package ``repro``):

1. card and environment (``nvidia-smi`` name and power limit, versions);
2. builds ``src/repro_torch/kernels/csrc/sim_step.cu`` with nvcc for
   sm_90a and prints the build seconds and the ``-Xptxas -v`` report;
3. kernel against its plain torch version on the card: a mixed batch of
   4,096 cells with every static flag, Philox draws, several chunks --
   every ``_State`` field must be bitwise equal;
4. across devices: parity draws, kernel on the card against the plain
   version on the CPU -- counts exact, floats within 1e-9 relative;
5. main path: the paper's Fig. 4 grids (4 seeds, 12 h of work, k = 16)
   through ``compare_grid`` -- at least 16 of the 18 static rows must show
   relative runtime > 100% and every oracle gap must lie in [0.95, 1.05];
6. main path: the fleet grid, 10,000 class-pooled gossip cells of
   k = 1,000,000 peers, through ``run_cells(step="fused")`` -- every cell
   must complete.  The kernel launches of phases 5 and 6 are the main
   path's count; the comparisons below launch outside it;
7. each kernel variant the main path ran, against the plain step on the
   card at its shapes: the Fig. 4 batches through ``run_cells`` with
   ``step="fused"`` and ``step="scan"`` (every ``BatchResult`` field
   equal), and the fleet batch one chunk bitwise on every ``_State``
   field and end to end through the scan path; the fleet kernel is timed
   by CUDA events beside its plain version;
8. a ``kernels`` JSON line (launches on the main path, error, times,
   bound), the card's name and power limit, and the final result line.

Any failed phase exits non-zero before the result line is printed.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks used for the bound (no tensor cores in play).
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
# FP64 operations of one step of one class-pooled adaptive gossip cell
# (the fleet grid's path: constant hazard, no store, no shock), counted
# from csrc/sim_step.cu with every arithmetic operation, comparison-select
# and math-library call as one operation: _attempt 104 (of which the
# 4-iteration Lambert W 74), _apply without the estimator 121, pooled
# estimator 12, class-pooled update 241 (the 16-term Poisson unroll 88).
OPS_PER_FLEET_CELL_STEP = 104 + 121 + 12 + 241

REPORT: dict = {}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    REPORT["failed"] = msg
    _dump()
    sys.exit(1)


def _dump() -> None:
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(REPORT, indent=1,
                                                    default=str))


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def cuda_ms(fn, reps: int = 1) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def mixed_cells(n: int):
    """n cells over every static flag of the kernel: pooled fixed/adaptive/
    oracle over the five scenario kinds, store R=3 and R=0, a two-class
    store mix, shocks (fleet-wide and class-scoped), and class-pooled
    gossip at k = 64 and k = 1e6."""
    from repro_torch.p2p import StoreSpec
    from repro_torch.sim import (CellSpec, PeerClass, PeerClassMix,
                                 PolicyConfig, ShockSpec, scenario)

    scens = [scenario("constant", mtbf=4000.0),
             scenario("doubling", mtbf0=7200.0, double_after=3 * 3600.0),
             scenario("diurnal", mtbf=4000.0, amplitude=0.5,
                      period=6 * 3600.0),
             scenario("flash_crowd", mtbf=7200.0, spike_mtbf=900.0,
                      at=3600.0, duration=1800.0),
             scenario("trace", times=(0.0, 1800.0, 5400.0),
                      mtbfs=(7200.0, 2000.0, 5000.0))]
    mix = PeerClassMix((PeerClass("stable"),
                        PeerClass("volatile", hazard_mult=3.0, speed=0.7,
                                  uplink_mult=0.5)), (0.6, 0.4))
    pols = [PolicyConfig(kind="adaptive", prior_mu=1 / 4000.0, prior_v=20.0),
            PolicyConfig(kind="fixed", fixed_T=1800.0),
            PolicyConfig(kind="oracle")]
    gossip = PolicyConfig(kind="adaptive", prior_mu=1 / 4000.0, prior_v=20.0,
                          regime="gossip", gossip_period=600.0)
    kw = dict(work=4 * 3600.0, V=20.0, T_d=50.0, max_wall_time=40 * 3600.0)
    base = [CellSpec(scenario=s, policy=p, **kw) for s in scens for p in pols]
    base += [CellSpec(scenario=scens[0], policy=p, store=StoreSpec(R=3), **kw)
             for p in pols]
    base += [CellSpec(scenario=scens[0], policy=pols[0],
                      store=StoreSpec(R=0), **kw),
             CellSpec(scenario=scens[2], policy=pols[2], store=StoreSpec(R=3),
                      mix=mix, **kw),
             CellSpec(scenario=scens[0], policy=pols[0],
                      shock=ShockSpec(rate=2e-4, kill_frac=0.3), **kw),
             CellSpec(scenario=scens[0], policy=pols[0], store=StoreSpec(R=3),
                      mix=mix, shock=ShockSpec(rate=2e-4, kill_frac=0.5,
                                               scope="volatile"), **kw),
             CellSpec(scenario=scens[0], policy=gossip, k=64, n_slots=256,
                      **kw),
             CellSpec(scenario=scenario("constant", mtbf=4000.0 * 1e5),
                      policy=gossip, k=1_000_000, n_slots=4_000_000, **kw)]
    import dataclasses
    return [dataclasses.replace(base[i % len(base)], seed=i)
            for i in range(n)]


def phase_env() -> None:
    import torch

    REPORT["nvidia_smi"] = nvidia_smi()
    REPORT["python"] = sys.version.split()[0]
    REPORT["torch"] = torch.__version__
    REPORT["cuda"] = torch.version.cuda
    REPORT["device_count"] = torch.cuda.device_count()
    REPORT["device"] = torch.cuda.get_device_name(0)
    print(f"[1] {REPORT['nvidia_smi']} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | devices {REPORT['device_count']}",
          flush=True)
    # How this PyTorch build rounds the operations the bitwise contract
    # depends on (informational; the plain step divides by device tensors).
    x = torch.linspace(0.1, 7.3, 10001, dtype=torch.float64, device="cuda")
    three = torch.tensor(3.0, dtype=torch.float64, device="cuda")
    REPORT["div_by_python_scalar_is_true_division"] = bool(
        torch.equal(x / 3.0, x / three))
    REPORT["div_by_device_scalar_is_true_division"] = bool(
        torch.equal(x / three, (x.cpu() / 3.0).cuda()))
    REPORT["pow2_is_x_times_x"] = bool(torch.equal(x ** 2, x * x))
    print(f"    div by python scalar == true div: "
          f"{REPORT['div_by_python_scalar_is_true_division']}; "
          f"div by device scalar == true div: "
          f"{REPORT['div_by_device_scalar_is_true_division']}; "
          f"x**2 == x*x: {REPORT['pow2_is_x_times_x']}", flush=True)


def ptxas_table(log: str) -> list:
    """(store, het, shock, pm, registers, spill-store bytes) per kernel
    instantiation, from nvcc's ``-Xptxas -v`` report."""
    rows, flags, spill = [], None, None
    for line in log.splitlines():
        m = re.search(r"sim_step_kernelILb(\d)ELb(\d)ELb(\d)ELb(\d)E", line)
        if m:
            flags, spill = tuple(int(g) for g in m.groups()), None
            continue
        sp = re.search(r"(\d+) bytes spill stores", line)
        if flags is not None and spill is None and sp:
            spill = int(sp.group(1))
        r = re.search(r"Used (\d+) registers", line)
        if flags is not None and r:
            rows.append(flags + (int(r.group(1)), spill))
            flags = None
    return rows


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.monotonic()
    build.build(["sim_step"])
    build.load("sim_step")
    log = build.BUILD_LOG["sim_step"]
    REPORT["build_seconds"] = time.monotonic() - t0
    REPORT["ptxas"] = log["ptxas"]
    REPORT["ptxas_table"] = ptxas_table(log["ptxas"])
    print(f"[2] built sim_step.cu in {REPORT['build_seconds']:.1f} s; "
          f"(store, het, shock, pm) -> registers, spill-store bytes:",
          flush=True)
    for row in REPORT["ptxas_table"]:
        print(f"    {row[:4]} -> {row[4]} registers, {row[5]} bytes spilled",
              flush=True)


def _state_diff(a, b):
    import torch

    out, worst = {}, 0.0
    for name, x, y in zip(a._fields, a, b):
        if x.is_floating_point():
            same = (x == y) | (torch.isnan(x) & torch.isnan(y))
            d = (x - y).abs()
            d = d[torch.isfinite(d)]
            if d.numel():
                worst = max(worst, float(d.max()))
        else:
            same = x == y
        out[name] = int((~same).sum())
    return out, worst


def phase_kernel_vs_plain(n_cells: int, chunks: int, chunk: int) -> float:
    import torch

    from repro_torch.kernels import sim_step
    from repro_torch.sim import engine
    from repro_torch.sim.draws import PhiloxDraws

    cells = mixed_cells(n_cells)
    p_np = engine._pack(cells)
    flags = engine.batch_flags(cells, p_np)
    assert all(flags.values()), flags
    p = engine.from_reference(p_np, device="cuda")
    s = engine._init_state(p, 1)
    src = PhiloxDraws([c.seed for c in cells], True, "cuda")
    total, worst = {}, 0.0
    for _ in range(chunks):
        d = src.next(chunk)
        a, ta = sim_step.fused_chunk(s, p, d, macro_threshold=0.05, **flags)
        b, tb = sim_step.fused_chunk_ref(s, p, d, macro_threshold=0.05,
                                         **flags)
        torch.cuda.synchronize()
        diff, w = _state_diff(a, b)
        worst = max(worst, w)
        for k, v in diff.items():
            total[k] = total.get(k, 0) + v
        total["steps_taken"] = total.get("steps_taken", 0) + int(
            (ta != tb).sum())
        s = a
    fin = int(s.finished.sum())
    REPORT["kernel_vs_plain"] = dict(cells=n_cells, chunks=chunks,
                                     chunk=chunk, mismatches=total,
                                     max_abs_err=worst, finished=fin)
    print(f"[3] kernel vs plain on the card: {n_cells} cells, {chunks} x "
          f"{chunk} steps, {fin} finished; mismatches per field: "
          f"{total}; max |err| {worst}", flush=True)
    if any(total.values()):
        fail("kernel differs from the plain torch step")
    return worst


def phase_across_devices() -> None:
    import numpy as np

    from repro_torch.sim import run_cells

    cells = mixed_cells(64)
    a = run_cells(cells, device="cuda", draws="numpy", chunk=128)
    b = run_cells(cells, device="cpu", draws="numpy", chunk=128)
    bad = []
    for f in ("n_checkpoints", "n_failures", "n_server_restores",
              "n_peer_restores", "completed"):
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            bad.append(f)
    rel = 0.0
    for f in ("wall_time", "wasted_work", "checkpoint_time", "restore_time",
              "server_bytes"):
        x, y = getattr(a, f), getattr(b, f)
        r = np.abs(x - y) / np.maximum(np.abs(y), 1e-300)
        rel = max(rel, float(np.max(np.where(x == y, 0.0, r))))
    REPORT["across_devices"] = dict(cells=64, count_mismatch=bad,
                                    max_rel_err=rel)
    print(f"[4] card kernel vs CPU plain, parity draws: count mismatches "
          f"{bad}, max rel err {rel:.3g}", flush=True)
    if bad or rel > 1e-9:
        fail("card and CPU disagree")


FIG4_KW = dict(seeds=range(4), work=12 * 3600.0, k=16)  # benchmarks KW


def phase_fig4() -> None:
    import numpy as np

    from repro_torch.sim import fig4_dynamic, fig4_static

    rows = {}
    for name, fn in (("fig4_static", fig4_static),
                     ("fig4_dynamic", fig4_dynamic)):
        t0 = time.monotonic()
        res = fn(**FIG4_KW)
        sec = time.monotonic() - t0
        rows[name] = [(m, c.fixed_T, c.relative_runtime, c.oracle_gap)
                      for m, cs in sorted(res.items()) for c in cs]
        print(f"[5] {name}: {len(rows[name])} rows in {sec:.2f} s "
              f"(mtbf, fixed_T, rel_runtime %, oracle_gap)", flush=True)
        for r in rows[name]:
            print(f"    {r[0]:.0f} {r[1]:.0f} {r[2]:.1f} {r[3]:.3f}",
                  flush=True)
        REPORT[name] = dict(seconds=sec, rows=rows[name])
    static = np.array([r[2] for r in rows["fig4_static"]])
    gaps = np.array([r[3] for name in rows for r in rows[name]])
    if (static > 100.0).sum() < 16:
        fail(f"only {(static > 100.0).sum()}/18 fig4_static rows > 100%")
    if not ((gaps >= 0.95) & (gaps <= 1.05)).all():
        fail(f"oracle_gap outside [0.95, 1.05]: {gaps}")


def _result_diff(a, b) -> dict:
    """Elements that differ per BatchResult field (floats: equal or both
    NaN)."""
    import dataclasses

    import numpy as np

    out = {}
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if not isinstance(x, np.ndarray):
            out[f.name] = int(x != y)
            continue
        same = x == y
        if x.dtype.kind == "f":
            same |= np.isnan(x) & np.isnan(y)
        out[f.name] = int((~same).sum())
    return out


def _flag_key(flags: dict) -> str:
    """The kernel instantiation a batch runs, as (store, het, shock, pm)."""
    return "".join(str(int(flags[f])) for f in (
        "any_store", "any_het", "any_shock", "any_pm"))


def phase_fig4_vs_plain() -> None:
    """The Fig. 4 batches (216 cells each) through run_cells with the kernel
    and with the plain step on the card: every BatchResult field equal."""
    from repro_torch.sim import engine, run_cells
    from repro_torch.sim.experiments import (fig4_dynamic_entries,
                                             fig4_static_entries, grid_cells)

    for name, entries in (("fig4_static", fig4_static_entries()),
                          ("fig4_dynamic", fig4_dynamic_entries())):
        cells = grid_cells(entries, **FIG4_KW)
        key = _flag_key(engine.batch_flags(cells, engine._pack(cells)))
        t0 = time.monotonic()
        a = run_cells(cells, step="fused")
        b = run_cells(cells, step="scan")
        diff = _result_diff(a, b)
        REPORT[name]["vs_plain"] = dict(cells=len(cells), variant=key,
                                        mismatches=diff,
                                        seconds=time.monotonic() - t0)
        print(f"[7] {name} kernel vs plain step on the card: {len(cells)} "
              f"cells, variant (store, het, shock, pm) {key}, "
              f"{a.n_steps} steps; mismatches per field {diff}", flush=True)
        if any(diff.values()):
            fail(f"{name}: kernel and plain step disagree")


def fleet_cells(B: int):
    from repro_torch.sim import CellSpec, PolicyConfig, scenario

    k = 1_000_000
    scen = scenario("constant", mtbf=250.0 * 1e6)
    pol = PolicyConfig(kind="adaptive", prior_mu=1.0 / (250.0 * 1e6),
                       prior_v=20.0, regime="gossip", gossip_period=600.0,
                       gossip_fanout=2)
    return [CellSpec(scenario=scen, policy=pol, seed=s, k=k, n_slots=4 * k,
                     work=1800.0, V=20.0, T_d=50.0) for s in range(B)]


def phase_fleet(B: int) -> dict:
    """The fleet grid through run_cells with the kernel (main path)."""
    import torch

    from repro_torch.sim import run_cells

    cells = fleet_cells(B)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    res = run_cells(cells, step="fused")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    mem = torch.cuda.max_memory_allocated()
    if not res.completed.all():
        fail(f"{int((~res.completed).sum())} fleet cells did not complete")
    return dict(cells=cells, res=res, wall=wall, mem=mem)


def phase_fleet_measure(run: dict) -> dict:
    """The fleet batch stage by stage on the host clock (where the time of
    run_cells goes), the kernel against the plain step on one chunk (bitwise,
    then timed by CUDA events), the bound, and the plain scan path end to
    end (every BatchResult field equal to the kernel's)."""
    import torch

    from repro_torch.kernels import sim_step
    from repro_torch.sim import engine, run_cells
    from repro_torch.sim.draws import PhiloxDraws

    cells, res, wall, mem = run["cells"], run["res"], run["wall"], run["mem"]
    B = len(cells)
    stages = {}
    t = time.monotonic()
    p_np = engine._pack(cells)
    flags = engine.batch_flags(cells, p_np)
    stages["pack_s"] = time.monotonic() - t
    t = time.monotonic()
    p = engine.from_reference(p_np, device="cuda")
    s0 = engine._init_state(p, 1)
    torch.cuda.synchronize()
    stages["to_device_s"] = time.monotonic() - t
    t = time.monotonic()
    d = PhiloxDraws([c.seed for c in cells], flags["any_pm"], "cuda").next(256)
    torch.cuda.synchronize()
    stages["draws_s"] = time.monotonic() - t
    kw = dict(macro_threshold=0.05, **flags)
    t = time.monotonic()
    s1, taken1 = sim_step.fused_chunk(s0, p, d, **kw)
    torch.cuda.synchronize()
    stages["fused_chunk_s"] = time.monotonic() - t
    t = time.monotonic()
    engine._result(s1, p_np, 256)
    stages["result_s"] = time.monotonic() - t
    # The plain step on the same chunk: bitwise equal to the kernel, and
    # its count of the cell-steps this data needs sets the bound.
    cell_steps = torch.zeros(B, dtype=torch.int64, device="cuda")
    s2, taken2 = sim_step.fused_chunk_ref(s0, p, d, cell_steps=cell_steps,
                                          **kw)
    torch.cuda.synchronize()
    chunk_diff, worst = _state_diff(s1, s2)
    chunk_diff["steps_taken"] = int((taken1 != taken2).sum())
    key = _flag_key(flags)
    print(f"[7] fleet chunk, kernel vs plain step on the card: variant "
          f"(store, het, shock, pm) {key}; mismatches per field "
          f"{chunk_diff}", flush=True)
    if any(chunk_diff.values()):
        fail("fleet chunk: kernel and plain step disagree")
    params = sim_step.pack_params(p)
    st0 = sim_step.pack_state(s0)
    st = st0.clone()
    taken = torch.zeros(-(-B // sim_step.WARP), dtype=torch.int32,
                        device="cuda")
    reps, total = 20, 0.0
    for i in range(reps + 1):
        st.copy_(st0)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        sim_step.launch(params, st, d, taken, **kw)
        b.record()
        torch.cuda.synchronize()
        if i:  # the first launch warms up
            total += a.elapsed_time(b)
    ms = total / reps
    wrapper_ms = cuda_ms(lambda: sim_step.fused_chunk(s0, p, d, **kw), reps=5)
    plain_ms = cuda_ms(lambda: sim_step.fused_chunk_ref(s0, p, d, **kw))
    active = int(cell_steps.sum())
    L = p.trace_t.shape[1]
    n_draw = d.shape[1]
    bytes_moved = 8 * (active * n_draw
                       + B * (len(sim_step.PARAM_ROWS)
                              + 4 * len(sim_step.TAB4) + 2 + 2 * L)
                       + 2 * B * len(sim_step.STATE_ROWS))
    ops = active * OPS_PER_FLEET_CELL_STEP
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_OPS_PER_S * 1e3
    # The plain scan path end to end on the same batch.
    t1 = time.monotonic()
    res_scan = run_cells(cells, step="scan")
    torch.cuda.synchronize()
    scan_wall = time.monotonic() - t1
    scan_diff = _result_diff(res, res_scan)
    out = dict(cells=B, variant=key, wall_s=wall, cells_per_s=B / wall,
               n_steps=res.n_steps, max_memory_allocated=mem,
               kernel_ms_per_chunk=ms, wrapper_ms_per_chunk=wrapper_ms,
               host_stages=stages, plain_ms_per_chunk=plain_ms,
               chunk_vs_plain=chunk_diff, max_abs_err=worst,
               steps_per_warp_max=int(taken.max()),
               steps_per_warp_mean=float(taken.float().mean()),
               active_cell_steps=active, bytes=bytes_moved, ops=ops,
               bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
               scan_wall_s=scan_wall, scan_vs_fused=scan_diff)
    REPORT["fleet"] = out
    print(f"[7] fleet grid: {B} cells x k=1e6 in {wall:.3f} s "
          f"({B / wall:.0f} cells/s), {res.n_steps} steps run, peak "
          f"{mem / 2**20:.1f} MiB; stages {stages}; kernel {ms:.4f} "
          f"ms/chunk (with packing {wrapper_ms:.4f}) vs plain "
          f"{plain_ms:.1f} ms/chunk (steps/warp max {int(taken.max())}); "
          f"bound max({t_bytes:.4f} ms bytes, {t_ops:.4f} ms ops); plain "
          f"scan path end to end {scan_wall:.2f} s, mismatches per field "
          f"against the kernel's run {scan_diff}", flush=True)
    if any(scan_diff.values()):
        fail("fleet grid: plain scan path and kernel path disagree")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    quick = "--quick" in sys.argv[1:]
    phase_env()
    phase_build()
    from repro_torch.kernels import sim_step

    worst = phase_kernel_vs_plain(256 if quick else 4096, 2 if quick else 4,
                                  64 if quick else 128)
    phase_across_devices()
    if quick:
        _dump()
        print(json.dumps({"quick": True}))
        return 0
    sim_step.LAUNCHES = 0          # the main path starts here
    phase_fig4()
    fleet_run = phase_fleet(10_000)
    launches = sim_step.LAUNCHES   # ... and ends here
    REPORT["main_path_launches"] = launches
    print(f"[6] main path (Fig. 4 static + dynamic, fleet grid): "
          f"{launches} sim_step launches", flush=True)
    if launches < 1:
        fail("the main path launched no sim_step kernel")
    # Held against the plain step: each variant the main path ran, at its
    # shapes (the checks fail the run on any mismatch).
    phase_fig4_vs_plain()
    fleet = phase_fleet_measure(fleet_run)
    bound = max(fleet["bound_bytes_ms"], fleet["bound_ops_ms"])
    kernels = {"kernels": [{
        "name": "sim_step", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sim_step.cu",
        "replaces": "src/repro/kernels/sim_step.py:63",
        "launches": launches, "max_abs_err": max(worst, fleet["max_abs_err"]),
        "bitwise": True,
        "ms": fleet["kernel_ms_per_chunk"],
        "plain_ms": fleet["plain_ms_per_chunk"], "bound_ms": bound,
        "bound_by": ("bytes" if fleet["bound_bytes_ms"]
                     >= fleet["bound_ops_ms"] else "operations"),
        "library_ms": None}]}
    REPORT["kernels"] = kernels
    _dump()
    print(json.dumps(kernels))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
