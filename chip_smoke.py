"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # full run (one card, ~minutes)
    python3 chip_smoke.py --quick    # build + kernel checks at a small size

Drives only ``repro_torch`` (never jax, never the JAX package ``repro``):

1. card and environment (``nvidia-smi`` name and power limit, versions);
2. builds ``src/repro_torch/kernels/csrc/sim_step.cu`` and ``ssd_scan.cu``
   with nvcc for sm_90a (one nvcc per source, started together) and prints
   the build seconds and the ``-Xptxas -v`` reports;
3. sim_step kernel against its plain torch version on the card: a mixed
   batch of 4,096 cells with every static flag, Philox draws, several
   chunks -- every ``_State`` field must be bitwise equal;
4. across devices: parity draws, kernel on the card against the plain
   version on the CPU -- counts exact, floats within 1e-9 relative;
S1. ssd_scan kernel against its plain torch version on the card at the
   serving shape (b 8, s 1024, h 24, p 64, n 128, Q 256, bf16 x/B/C) with
   a zero and a random initial state, and at s < Q and s = Q: y within
   1e-2 (one bf16 rounding of y after float32 sums in another order), the
   final state within 1e-4;
S2. across devices: the mamba2 SMOKE config in float32, prefill and four
   teacher-forced decode steps, kernel on the card against the plain
   version on the CPU -- logits and caches within 1e-4; at a 32-token
   prompt (two chunks) and a 40-token one (zero-padded to three chunks
   for the kernel);
5. main path: the paper's Fig. 4 grids (4 seeds, 12 h of work, k = 16)
   through ``compare_grid`` -- at least 16 of the 18 static rows must show
   relative runtime > 100% and every oracle gap must lie in [0.95, 1.05];
6. main path: the fleet grid, 10,000 class-pooled gossip cells of
   k = 1,000,000 peers, through ``run_cells(step="fused")`` -- every cell
   must complete.  The sim_step launches of phases 5 and 6 are that
   path's count;
S3. main path: ``repro_torch.serve`` on the full mamba2-130m (24 layers,
   d_model 768, bf16, the port's seeded init): ``greedy_generate`` of 32
   tokens after a 1024-token prompt, batch 8 -- 24 ssd_scan launches (one
   per layer); then prefill seconds and decode tokens/s through the step
   factories, peak device memory, and the prefill seconds of the plain
   ``ssd_chunked`` path (``use_flash_kernel=False``) on the same input;
S4. the same parameters and prompt with ``use_flash_kernel=False`` (the
   plain ``ssd_chunked`` path on the card): last-position prefill logits
   and four teacher-forced decode steps' logits.  bf16: elementwise within
   5e-2 + 5e-2|b|, widened only where two plain implementations (the
   kernel's plain version against ``ssd_chunked``, the bf16 noise floor
   measured in the same run) cross it, to at most 1.2x their gap; relative
   RMS within 5e-2.  The same parameters in float32 within 1e-4
   elementwise;
7. each sim_step variant the main path ran, against the plain step on
   the card at its shapes (every ``BatchResult`` / ``_State`` field
   equal); the fleet kernel timed by CUDA events beside its plain version;
S5. ``torch.profiler`` over one warm prefill and five decode steps:
   device time by kernel, launches per step, the device's idle share;
S6. the ssd_scan kernel timed by CUDA events at the serving shape beside
   its plain version, and its bound;
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

# H100 SXM data-sheet peaks used for the bounds.
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
FP32_OPS_PER_S = 67e12          # float32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12      # bf16 tensor cores, dense
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
    build.build(["sim_step", "ssd_scan"])
    build.load("sim_step")
    build.load("ssd_scan")
    log = build.BUILD_LOG["sim_step"]
    REPORT["build_seconds"] = time.monotonic() - t0
    REPORT["ptxas"] = log["ptxas"]
    REPORT["ptxas_table"] = ptxas_table(log["ptxas"])
    REPORT["ssd_build_seconds"] = build.BUILD_LOG["ssd_scan"]["seconds"]
    REPORT["ssd_ptxas"] = build.BUILD_LOG["ssd_scan"]["ptxas"]
    print(f"[2] built sim_step.cu and ssd_scan.cu in "
          f"{REPORT['build_seconds']:.1f} s (ssd_scan.cu "
          f"{REPORT['ssd_build_seconds']:.1f} s); sim_step "
          f"(store, het, shock, pm) -> registers, spill-store bytes:",
          flush=True)
    for row in REPORT["ptxas_table"]:
        print(f"    {row[:4]} -> {row[4]} registers, {row[5]} bytes spilled",
              flush=True)
    for line in REPORT["ssd_ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"    ssd_scan: {line.strip()}", flush=True)


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


# --------------------------------------------------------------------------- #
# mamba2 serving slice: the SSD kernel and the serve path
# --------------------------------------------------------------------------- #

ARCH = "mamba2-130m"
SERVE_SHAPE = dict(b=8, s=1024, h=24, p=64, n=128, chunk=256)
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS, SERVE_FORCED = 8, 1024, 32, 4
SSD_Y_TOL = 1e-2       # bf16 y: one rounding (2^-8 relative) + f32 reorder
SSD_F32_TOL = 1e-4     # float32 y and the final state: f32 sums reordered
LOGIT_TOL = 5e-2       # bf16 logits (tests/test_models_smoke.py's bound)
NOISE_FACTOR = 1.2     # bf16 logits may exceed LOGIT_TOL elementwise only
                       # where two plain paths do, by at most this factor


def ssd_inputs(b, s, h, p, n, dtype, seed, with_init, **_):
    """x, dt, A, B, C, initial state on the card, made as
    tests/test_kernels.py makes them, from a seeded generator."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    x = normal(b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(normal(b, s, h)) * 0.1
    A = -torch.exp(normal(h) * 0.3)
    B = (normal(b, s, n) * 0.5).to(dtype)
    C = (normal(b, s, n) * 0.5).to(dtype)
    init = normal(b, h, p, n) if with_init else None
    return x, dt, A, B, C, init


def _gap(a, b, tol: float) -> dict:
    """How far a lies from b, in float32: max |a - b|, its largest ratio to
    tol + tol |b| (within tolerance when <= 1), the relative RMS gap, and
    whether a is finite."""
    a, b = a.float(), b.float()
    d = (a - b).abs()
    return dict(max_abs=float(d.max()),
                max_ratio=float((d / (tol + tol * b.abs())).max()),
                rel_rms=float(d.square().mean().sqrt()
                              / b.square().mean().sqrt()),
                finite=bool(a.isfinite().all()))


def _ok(g: dict) -> bool:
    return g["finite"] and g["max_ratio"] <= 1.0


def phase_ssd_kernel_vs_plain() -> float:
    """The ssd_scan kernel against its plain version on the card."""
    import torch

    from repro_torch.kernels import ssd_scan

    sh = SERVE_SHAPE
    cases = [("serve, zero state", dict(sh), False),
             ("serve, random state", dict(sh), True),
             ("s < Q", dict(sh, s=128), True),
             ("s = Q", dict(sh, s=256), False)]
    worst, rows = 0.0, []
    for i, (name, shape, with_init) in enumerate(cases):
        x, dt, A, B, C, init = ssd_inputs(dtype=torch.bfloat16, seed=100 + i,
                                          with_init=with_init, **shape)
        y, st = ssd_scan.ssd_scan(x, dt, A, B, C, chunk=shape["chunk"],
                                  initial_state=init)
        y_p, st_p = ssd_scan.ssd_scan_plain(x, dt, A, B, C,
                                            chunk=shape["chunk"],
                                            initial_state=init)
        torch.cuda.synchronize()
        gy, gs = _gap(y, y_p, SSD_Y_TOL), _gap(st, st_p, SSD_F32_TOL)
        ey, es = gy["max_abs"], gs["max_abs"]
        worst = max(worst, ey, es)
        rows.append(dict(case=name, shape=shape, y=gy, state=gs,
                         ok=_ok(gy) and _ok(gs)))
        print(f"[S1] ssd_scan kernel vs plain on the card, {name} "
              f"{shape}: max |dy| {ey:.3g} (tol {SSD_Y_TOL}), max |dstate| "
              f"{es:.3g} (tol {SSD_F32_TOL})", flush=True)
    REPORT["ssd_kernel_vs_plain"] = rows
    if not all(r["ok"] for r in rows):
        fail("ssd_scan kernel differs from its plain version")
    return worst


def _serve_run(model, cfg, prompt, forced):
    """Prefill + teacher-forced decode steps: the last-position logits of
    each and the caches."""
    from repro_torch.serve.step import make_prefill_step, make_serve_step

    pre = make_prefill_step(cfg, max_seq=prompt.shape[1] + forced.shape[1])
    srv = make_serve_step(cfg)
    logits, cache = pre(model, {"tokens": prompt})
    out = [logits[:, -1]]
    first_cache = cache
    for k in range(forced.shape[1]):
        logits, cache = srv(model, cache, {"tokens": forced[:, k:k + 1]})
        out.append(logits[:, -1])
    return out, first_cache


def phase_serve_card_vs_cpu() -> dict:
    """The SMOKE config in float32 with the kernel on: the card against the
    plain version on the CPU."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params

    cfg = get_smoke_config(ARCH).replace(param_dtype="float32",
                                         compute_dtype="float32",
                                         use_flash_kernel=True)
    g = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (2, 44), generator=g)
    models = {dev: init_params(0, cfg, device=dev) for dev in ("cuda", "cpu")}
    gaps = []
    for n in (32, 40):            # 40 is off the chunk grid: padded
        res = {dev: _serve_run(m, cfg, toks[:, :n].to(dev),
                               toks[:, n:n + 4].to(dev))
               for dev, m in models.items()}
        pairs = list(zip(res["cuda"][0], res["cpu"][0])) + [
            (res["cuda"][1]["ssm"][k], res["cpu"][1]["ssm"][k])
            for k in ("state", "conv")]
        gaps += [_gap(a.cpu(), b, SSD_F32_TOL) for a, b in pairs]
    errs = [g["max_abs"] for g in gaps]
    ok = all(_ok(g) for g in gaps)
    REPORT["serve_card_vs_cpu"] = dict(max_abs_err=max(errs), errs=errs)
    print(f"[S2] mamba2 SMOKE float32, kernel on the card vs plain on the "
          f"CPU, prompts of 32 and 40 tokens: prefill + 4 decode logits and "
          f"caches, max |d| "
          f"{max(errs):.3g} (tol {SSD_F32_TOL})", flush=True)
    if not ok:
        fail("mamba2 SMOKE: card and CPU disagree")
    return REPORT["serve_card_vs_cpu"]


def serve_setup():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config(ARCH)
    assert cfg.use_flash_kernel
    t0 = time.monotonic()
    model = init_params(0, cfg, device="cuda")
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           generator=g).cuda()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[S3] mamba2-130m: {n_params:,} parameters from the port's seeded "
          f"init in {time.monotonic() - t0:.1f} s", flush=True)
    return cfg, model, prompt


def phase_serve(cfg, model, prompt) -> dict:
    """Main path: greedy_generate on the full config (the kernel path)."""
    import torch

    from repro_torch.serve import greedy_generate

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    out = greedy_generate(model, cfg, prompt, SERVE_TOKENS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    mem = torch.cuda.max_memory_allocated()
    if tuple(out.shape) != (SERVE_BATCH, SERVE_TOKENS) or not bool(
            ((out >= 0) & (out < cfg.vocab)).all()):
        fail(f"greedy_generate gave {tuple(out.shape)} tokens out of range")
    return dict(tokens=out, wall=wall, mem=mem)


def phase_serve_measure(cfg, model, prompt, run) -> dict:
    """Prefill seconds and decode tokens/s through the step factories (warm),
    then the plain ssd_chunked path on the same parameters and prompt."""
    import torch

    from repro_torch.serve.step import make_prefill_step, make_serve_step

    pre = make_prefill_step(cfg, max_seq=SERVE_PROMPT + SERVE_TOKENS)
    srv = make_serve_step(cfg)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        logits, cache = pre(model, {"tokens": prompt})
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(SERVE_TOKENS - 1):
        logits, cache = srv(model, cache, {"tokens": tok})
        tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    dec = time.monotonic() - t0
    tok_s = SERVE_BATCH * (SERVE_TOKENS - 1) / dec
    # the plain ssd_chunked path's prefill on the same input, warmed once
    plain_pre = make_prefill_step(cfg.replace(use_flash_kernel=False),
                                  max_seq=SERVE_PROMPT + SERVE_TOKENS)
    plain_times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        plain_pre(model, {"tokens": prompt})
        torch.cuda.synchronize()
        plain_times.append(time.monotonic() - t0)
    plain_times = plain_times[1:]
    out = dict(batch=SERVE_BATCH, prompt=SERVE_PROMPT, tokens=SERVE_TOKENS,
               greedy_wall_s=run["wall"], peak_bytes=run["mem"],
               prefill_s=times, plain_prefill_s=plain_times, decode_s=dec,
               decode_tok_s=tok_s)
    print(f"[S3] serve mamba2-130m, batch {SERVE_BATCH}, prompt "
          f"{SERVE_PROMPT}, {SERVE_TOKENS} greedy tokens: greedy_generate "
          f"{run['wall']:.3f} s (first call), prefill "
          f"{', '.join(f'{t:.4f}' for t in times)} s (warm), decode "
          f"{SERVE_TOKENS - 1} steps in {dec:.3f} s = {tok_s:.1f} tok/s, "
          f"peak {run['mem'] / 2**30:.2f} GiB; plain ssd_chunked path "
          f"prefill {', '.join(f'{t:.4f}' for t in plain_times)} s (warm)",
          flush=True)
    REPORT["serve"] = out
    return out


def phase_serve_vs_plain(cfg, model, prompt, run) -> dict:
    """Kernel path against the plain ssd_chunked path on the card: the
    last-position prefill logits and SERVE_FORCED teacher-forced decode
    steps' logits, same parameters, prompt and forced tokens.

    bf16 (the serving config): held elementwise at LOGIT_TOL + LOGIT_TOL
    |b|, as tests/test_models_smoke.py holds bf16 logits.  On a 24-layer
    bf16 stack two plain implementations of the same SSD (the kernel's
    plain version and ssd_chunked) can already cross that bound, so the
    run measures their gap, the noise floor, on the same input: the
    kernel path may exceed the bound only where the floor does, and by at
    most NOISE_FACTOR times the floor's ratio.  Its relative RMS gap is
    held at LOGIT_TOL.  float32 at full width (the same seeded
    parameters): held elementwise at SSD_F32_TOL.
    """
    import torch
    from unittest import mock

    from repro_torch.kernels import ops, ssd_scan
    from repro_torch.models import init_params

    forced = run["tokens"][:, :SERVE_FORCED]
    plain_cfg = cfg.replace(use_flash_kernel=False)
    k_out, k_cache = _serve_run(model, cfg, prompt, forced)
    p_out, p_cache = _serve_run(model, plain_cfg, prompt, forced)
    # a second plain implementation in the kernel's place: its plain version
    with mock.patch.object(ops, "ssd_scan", ssd_scan.ssd_scan_plain):
        q_out, _ = _serve_run(model, cfg, prompt, forced)
    k, p, q = (torch.stack(o) for o in (k_out, p_out, q_out))
    bf16, floor = _gap(k, p, LOGIT_TOL), _gap(q, p, LOGIT_TOL)
    bf16["limit_ratio"] = max(1.0, NOISE_FACTOR * floor["max_ratio"])
    bf16["argmax_agree"] = float((k.argmax(-1) == p.argmax(-1)).float().mean())
    st_err = float((k_cache["ssm"]["state"] - p_cache["ssm"]["state"]
                    ).abs().max())
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    model32 = init_params(0, cfg32, device="cuda")
    k32, _ = _serve_run(model32, cfg32, prompt, forced)
    p32, _ = _serve_run(model32, cfg32.replace(use_flash_kernel=False),
                        prompt, forced)
    f32 = _gap(torch.stack(k32), torch.stack(p32), SSD_F32_TOL)
    del model32
    out = dict(bf16=bf16, bf16_plain_vs_plain=floor, bf16_state_err=st_err,
               f32=f32)
    REPORT["serve_vs_plain"] = out
    print(f"[S4] mamba2-130m kernel path vs plain ssd_chunked path on the "
          f"card, prefill + {SERVE_FORCED} teacher-forced decode logits: "
          f"bf16 rel RMS {bf16['rel_rms']:.4g} (tol {LOGIT_TOL}), max |d| "
          f"{bf16['max_abs']:.4g} = {bf16['max_ratio']:.3f} x "
          f"({LOGIT_TOL} + {LOGIT_TOL}|b|) (limit "
          f"{bf16['limit_ratio']:.3f} x), argmax agree "
          f"{bf16['argmax_agree']:.3f}, max |dstate| {st_err:.3g}; noise "
          f"floor (kernel's plain version vs ssd_chunked): rel RMS "
          f"{floor['rel_rms']:.4g}, max |d| {floor['max_abs']:.4g} = "
          f"{floor['max_ratio']:.3f} x; float32 at full width: max |d| "
          f"{f32['max_abs']:.3g} = {f32['max_ratio']:.4f} x ({SSD_F32_TOL} "
          f"+ {SSD_F32_TOL}|b|)", flush=True)
    if not (bf16["finite"] and bf16["max_ratio"] <= bf16["limit_ratio"]
            and bf16["rel_rms"] <= LOGIT_TOL and _ok(f32)):
        fail("mamba2-130m: kernel path and plain path disagree")
    return out


def _kernel_rows(prof) -> list:
    """(name, device microseconds, count) of each kernel a profile saw.
    Only the device's own rows: an operator's row repeats the time of the
    kernels it launched."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((e.key, float(us), e.count))
    return sorted(rows, key=lambda r: -r[1])


def phase_serve_profile(cfg, model, prompt, serve: dict) -> dict:
    """Where the serving time goes: ``torch.profiler`` over one warm
    prefill and 5 decode steps; device time by kernel, kernels per step,
    and the device's idle share against the unprofiled host-clock times of
    S3 (kernels run one at a time on the one stream)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.step import make_prefill_step, make_serve_step

    pre = make_prefill_step(cfg, max_seq=SERVE_PROMPT + SERVE_TOKENS)
    srv = make_serve_step(cfg)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    with profile(activities=acts) as prof:
        logits, cache = pre(model, {"tokens": prompt})
        torch.cuda.synchronize()
    tok = logits[:, -1].argmax(-1)[:, None]
    rows = _kernel_rows(prof)
    total = sum(r[1] for r in rows)
    ssd = sum(r[1] for r in rows if "ssd_scan_kernel" in r[0])
    top = rows[:8]
    out["prefill"] = dict(device_ms=total / 1e3, ssd_scan_ms=ssd / 1e3,
                          kernels=sum(r[2] for r in rows), top=top)
    steps = 5
    with profile(activities=acts) as prof:
        for _ in range(steps):
            logits, cache = srv(model, cache, {"tokens": tok})
        torch.cuda.synchronize()
    rows = _kernel_rows(prof)
    total_d = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    out["decode"] = dict(device_ms_per_step=total_d / 1e3 / steps,
                         kernels_per_step=launches / steps,
                         top=rows[:5])
    if total <= 0 or total_d <= 0:
        out["note"] = "the profiler recorded no device time: not measured"
        print(f"[S5] serve profile: {out['note']}", flush=True)
    else:
        pre_wall = min(serve["prefill_s"])
        dec_wall = serve["decode_s"] / (SERVE_TOKENS - 1)
        out["prefill"]["idle_share"] = 1.0 - total / 1e6 / pre_wall
        out["decode"]["idle_share"] = (1.0 - total_d / 1e6 / steps
                                       / dec_wall)
        print(f"[S5] serve profile: prefill device time {total / 1e3:.2f} ms "
              f"(ssd_scan {ssd / 1e3:.2f} ms = {ssd / total:.1%}), idle "
              f"share against {pre_wall:.4f} s unprofiled "
              f"{out['prefill']['idle_share']:.1%}; decode device time "
              f"{total_d / 1e3 / steps:.2f} ms/step, "
              f"{launches / steps:.0f} kernels/step, idle share against "
              f"{dec_wall * 1e3:.2f} ms/step unprofiled "
              f"{out['decode']['idle_share']:.1%}", flush=True)
        for name, us, n in top:
            print(f"    prefill {us / 1e3:8.3f} ms  {n:5d} x  {name[:70]}",
                  flush=True)
        for name, us, n in out["decode"]["top"]:
            print(f"    decode  {us / 1e3 / steps:8.3f} ms/step  "
                  f"{n / steps:5.0f} x  {name[:60]}", flush=True)
    REPORT["serve_profile"] = out
    return out


def ssd_work(b, s, h, p, n, chunk, x_bytes, with_init):
    """Bytes the scan must move (each input read once, each output written
    once) and its float operations: C B^T once per (batch, chunk) on the
    i >= j half (bf16 operands), and per head the masked scores times
    dt x, C state^T and (dt x decay)^T B (float32 operands)."""
    nc = s // chunk
    tri = chunk * (chunk + 1) // 2
    ops_bf16 = 2 * b * nc * tri * n
    ops_f32 = 2 * b * h * nc * (tri * p + 2 * chunk * p * n)
    nbytes = (x_bytes * (2 * b * s * h * p + 2 * b * s * n)
              + 4 * (b * s * h + h) + 4 * b * h * p * n * (2 if with_init
                                                           else 1))
    return nbytes, ops_bf16, ops_f32


def phase_ssd_measure() -> dict:
    """The kernel and its plain version timed at the serving shape."""
    import torch

    from repro_torch.kernels import ssd_scan

    sh = SERVE_SHAPE
    x, dt, A, B, C, init = ssd_inputs(dtype=torch.bfloat16, seed=200,
                                      with_init=True, **sh)

    def kern():
        return ssd_scan.ssd_scan(x, dt, A, B, C, chunk=sh["chunk"],
                                 initial_state=init)

    def plain():
        return ssd_scan.ssd_scan_plain(x, dt, A, B, C, chunk=sh["chunk"],
                                       initial_state=init)

    ms = cuda_ms(kern, reps=20)
    plain_ms = cuda_ms(plain, reps=3)
    nbytes, ops_bf16, ops_f32 = ssd_work(x_bytes=2, with_init=True, **sh)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops_bf16 / BF16_TC_OPS_PER_S, ops_f32 / FP32_OPS_PER_S) * 1e3
    out = dict(shape=sh, ms=ms, plain_ms=plain_ms, bytes=nbytes,
               ops_bf16=ops_bf16, ops_f32=ops_f32, bound_bytes_ms=t_bytes,
               bound_ops_ms=t_ops,
               bound_all_bf16_tc_ms=(ops_bf16 + ops_f32) / BF16_TC_OPS_PER_S
               * 1e3)
    REPORT["ssd_measure"] = out
    print(f"[S6] ssd_scan at {sh}: kernel {ms:.4f} ms, plain {plain_ms:.3f} "
          f"ms; bound max({t_bytes:.4f} ms bytes ({nbytes:,} B), "
          f"{t_ops:.4f} ms operations ({ops_f32:,} f32 + {ops_bf16:,} bf16 "
          f"flop)); all operations on bf16 tensor cores would take "
          f"{out['bound_all_bf16_tc_ms']:.4f} ms", flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # float32 products in full float32 on the card (the references' setting)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    quick = "--quick" in sys.argv[1:]
    phase_env()
    phase_build()
    from repro_torch.kernels import sim_step, ssd_scan

    worst = phase_kernel_vs_plain(256 if quick else 4096, 2 if quick else 4,
                                  64 if quick else 128)
    phase_across_devices()
    ssd_worst = phase_ssd_kernel_vs_plain()
    phase_serve_card_vs_cpu()
    if quick:
        _dump()
        print(json.dumps({"quick": True}))
        return 0
    sim_step.LAUNCHES = 0          # the engine's main path starts here
    phase_fig4()
    fleet_run = phase_fleet(10_000)
    launches = sim_step.LAUNCHES   # ... and ends here
    REPORT["main_path_launches"] = launches
    print(f"[6] main path (Fig. 4 static + dynamic, fleet grid): "
          f"{launches} sim_step launches", flush=True)
    if launches < 1:
        fail("the main path launched no sim_step kernel")
    cfg, model, prompt = serve_setup()
    ssd_scan.LAUNCHES = 0          # the serving main path starts here
    serve_run = phase_serve(cfg, model, prompt)
    ssd_launches = ssd_scan.LAUNCHES   # ... and ends here
    REPORT["serve_main_path_launches"] = ssd_launches
    print(f"[S3] serving main path (greedy_generate, one prefill of "
          f"{cfg.n_layers} layers): {ssd_launches} ssd_scan launches",
          flush=True)
    if ssd_launches != cfg.n_layers:
        fail(f"the serving main path launched ssd_scan {ssd_launches} "
             f"times, expected {cfg.n_layers} (one per layer)")
    phase_serve_measure(cfg, model, prompt, serve_run)
    logits_vs_plain = phase_serve_vs_plain(cfg, model, prompt, serve_run)
    phase_serve_profile(cfg, model, prompt, REPORT["serve"])
    del model
    # Held against the plain step: each variant the main path ran, at its
    # shapes (the checks fail the run on any mismatch).
    phase_fig4_vs_plain()
    fleet = phase_fleet_measure(fleet_run)
    ssd = phase_ssd_measure()
    bound = max(fleet["bound_bytes_ms"], fleet["bound_ops_ms"])
    ssd_bound = max(ssd["bound_bytes_ms"], ssd["bound_ops_ms"])
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
        "library_ms": None}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:33",
        "launches": ssd_launches, "max_abs_err": ssd_worst,
        "tolerance": {"y_bf16": SSD_Y_TOL, "state": SSD_F32_TOL},
        "logits_vs_plain_path": {
            "bf16_rel_rms": logits_vs_plain["bf16"]["rel_rms"],
            "bf16_max_abs": logits_vs_plain["bf16"]["max_abs"],
            "bf16_max_ratio": logits_vs_plain["bf16"]["max_ratio"],
            "bf16_floor_max_ratio":
                logits_vs_plain["bf16_plain_vs_plain"]["max_ratio"],
            "f32_max_abs": logits_vs_plain["f32"]["max_abs"]},
        "ms": ssd["ms"], "plain_ms": ssd["plain_ms"], "bound_ms": ssd_bound,
        "bound_by": ("bytes" if ssd["bound_bytes_ms"]
                     >= ssd["bound_ops_ms"] else "operations"),
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
