"""A 3-stage volunteer-computing work flow under churn on the port (the
counterpart of ``examples/workflow_dag.py``).

    PYTHONPATH=src python -m repro_torch.launch.workflow_dag \
        [--scenario NAME] [--seeds N] [--device cpu] [--draws philox|numpy]
    PYTHONPATH=src python -m repro_torch.launch.workflow_dag --p2p [--replicas R]
    PYTHONPATH=src python -m repro_torch.launch.workflow_dag --execute \
        --mix fast_core_volunteer_tail --p2p --replicas 3

Builds the paper's deployment shape -- inter-dependent processes on a P2P
volunteer network -- as a preprocess -> train -> evaluate DAG, runs it with
the batched Monte-Carlo engine (every stage one ``run_cells`` batch across
the seeds: the sim-step kernel on the card) under a time-varying churn
scenario, and compares the adaptive checkpoint policy against a fixed
1 h interval on workflow makespan.  Runs on CUDA unless ``--device cpu``
is given (and raises where there is no card).

``--estimator`` picks the adaptive estimator's regime (pooled, isolated,
gossip); ``--p2p`` puts checkpoints and hand-offs on R-way peer replica
sets and compares server I/O against a server-only (R = 0) store; ``--mix``
makes the fleet heterogeneous.  ``--execute`` then runs the DAG for real
through the resumable executor (:mod:`repro_torch.exec`, ``MixTask``
payloads on the device) on ``--exec-seeds`` pinned failure schedules and
prints the sim's predicted waste band beside the measured waste -- the
digital-twin contract.
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Optional

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.p2p import StoreSpec, TransferModel
from repro_torch.sim import (
    PolicyConfig,
    Stage,
    WorkflowSpec,
    available_mixes,
    peer_class_mix,
    scenario,
    simulate_workflow,
)
from repro_torch.sim.workflow import export_failure_schedule, waste_band

V, TD = 20.0, 50.0


def build_workflow() -> WorkflowSpec:
    """``examples/workflow_dag.py``'s DAG."""
    return WorkflowSpec(stages=(
        Stage("preprocess", work=2 * 3600.0, k=8),
        Stage("train", work=10 * 3600.0, k=16, deps=("preprocess",),
              handoff=180.0),
        Stage("evaluate", work=1 * 3600.0, k=4, deps=("train",),
              handoff=60.0),
    ))


def report(name: str, res, show_server: bool = False) -> None:
    print(f"\n== {name} ==")
    print(f"{'stage':12s} {'start_h':>8s} {'finish_h':>9s} {'handoff_s':>10s} "
          f"{'waste_s':>8s} {'failures':>9s} {'ckpts':>6s}")
    for sname, sr in res.stages.items():
        print(f"{sname:12s} {sr.start.mean() / 3600:8.2f} "
              f"{sr.finish.mean() / 3600:9.2f} "
              f"{sr.handoff_time.mean():10.1f} {sr.handoff_waste.mean():8.1f} "
              f"{sr.sim.n_failures.mean():9.1f} "
              f"{sr.sim.n_checkpoints.mean():6.1f}")
    line = (f"makespan {res.mean_makespan / 3600:.2f}h  "
            f"completed={res.all_completed}  "
            f"critical path: {' -> '.join(res.critical_path)}")
    if show_server:
        line += f"  server_IO={res.server_bytes.mean() / 1e9:.2f}GB"
    print(line)


def execute_for_real(spec: WorkflowSpec, scen, policy: PolicyConfig,
                     sim_seeds: int, exec_seeds: int, *, mix=None,
                     store: Optional[StoreSpec] = None, device=None,
                     draws: str = "philox", dim: int = 64) -> dict:
    """Digital-twin run: the sim predicts the DAG's waste, the executor
    measures it on ``MixTask(dim)`` work units on ``device`` replaying the
    same churn schedules.  The schedule seeds execute at once, in threads
    (each run has its own directories, checkpointer and clock, so the
    results do not depend on it; the runs' checkpoint writes, which wait
    on the disk, overlap).  Returns the band, the measured waste per schedule seed and each seed's
    :class:`~repro_torch.exec.ExecReport`."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.exec import ExecutorConfig, MixTask, WorkflowExecutor

    dev = str(resolve_device(device))
    res = simulate_workflow(spec, scen, policy=policy,
                            seeds=range(sim_seeds), V=V, T_d=TD, mix=mix,
                            store=store, device=dev, draws=draws)
    lo, mean, hi = waste_band(res)
    print(f"\n== digital twin: sim prediction ({sim_seeds} seeds) ==")
    print(f"predicted waste {mean:.0f}s  (3-sigma band [{lo:.0f}, {hi:.0f}]s, "
          f"makespan {res.mean_makespan / 3600:.2f}h)")

    tasks = {s.name: MixTask(dim=dim, salt=i, device=dev)
             for i, s in enumerate(spec.stages)}
    print(f"\n== digital twin: real execution ({exec_seeds} schedule seeds) ==")

    def execute(seed: int):
        sched = export_failure_schedule(spec, scen, seed=seed,
                                        horizon_factor=60.0,
                                        mix=mix, store=store)
        with tempfile.TemporaryDirectory(prefix="wf_exec_") as root:
            cfg = ExecutorConfig(root=root, prior_mu=policy.prior_mu,
                                 V=V, T_d=TD)
            return WorkflowExecutor(spec, tasks, sched, cfg).run()

    with ThreadPoolExecutor(max_workers=max(exec_seeds, 1)) as pool:
        runs = list(pool.map(execute, range(exec_seeds)))
    measured, reports = [], []
    for seed, rep in enumerate(runs):
        line = (f"  seed {seed}: measured waste {rep.total_waste:8.1f}s  "
                f"supersteps {rep.executed_supersteps:5d}  "
                f"completed={rep.completed}  "
                f"({rep.steps_per_second:.0f} steps/s real)")
        if store is not None:
            line += f"  server_IO={rep.server_bytes / 1e9:.2f}GB"
        print(line)
        measured.append(rep.total_waste)
        reports.append(rep)
    m = float(np.mean(measured))
    inside = lo <= m <= hi
    print(f"\npredicted {mean:.0f}s vs measured {m:.0f}s "
          f"-> {'INSIDE' if inside else 'OUTSIDE'} the sim's 3-sigma band "
          f"[{lo:.0f}, {hi:.0f}]s")
    return dict(band=(lo, mean, hi), measured=measured, inside=inside,
                reports=reports, sim=res)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="diurnal",
                    help="registry scenario name (constant, doubling, diurnal, "
                         "flash_crowd, weibull)")
    ap.add_argument("--mtbf", type=float, default=7200.0)
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--draws", default="philox", choices=("philox", "numpy"),
                    help="engine draw source (numpy: the reference's "
                         "numpy-backend streams)")
    ap.add_argument("--estimator", default="pooled",
                    choices=("pooled", "isolated", "gossip"),
                    help="adaptive-estimator regime (paper Sec 3.1.4)")
    ap.add_argument("--gossip-period", type=float, default=600.0,
                    help="seconds between gossip exchanges (--estimator gossip)")
    ap.add_argument("--gossip-fanout", type=int, default=3,
                    help="ring neighbours pulled per gossip round")
    ap.add_argument("--p2p", action="store_true",
                    help="store checkpoints on the P2P overlay and compare "
                         "against the server-only baseline")
    ap.add_argument("--replicas", type=int, default=3,
                    help="replication factor R for --p2p")
    ap.add_argument("--img-mb", type=float, default=200.0,
                    help="checkpoint image size for --p2p (MB)")
    ap.add_argument("--mix", default=None, metavar="NAME",
                    help="peer-class mix applied workflow-wide "
                         f"(one of: {', '.join(available_mixes())})")
    ap.add_argument("--execute", action="store_true",
                    help="also RUN the DAG through the workflow executor "
                         "and print predicted vs measured waste")
    ap.add_argument("--exec-seeds", type=int, default=4,
                    help="pinned schedule seeds to execute (--execute)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = str(resolve_device(args.device))
    scen_kw = {"mtbf0" if args.scenario == "doubling" else
               "scale" if args.scenario == "weibull" else "mtbf": args.mtbf}
    scen = scenario(args.scenario, **scen_kw)
    mix = peer_class_mix(args.mix) if args.mix else None
    spec = build_workflow()
    print(f"workflow: {len(spec)} stages under scenario {scen.name!r}, "
          f"estimator regime {args.estimator!r}, device {dev}"
          + (f", peer-class mix {mix.name!r}" if mix else ""))
    adaptive_pol = PolicyConfig(kind="adaptive", prior_mu=1.0 / args.mtbf,
                                prior_v=V, regime=args.estimator,
                                gossip_period=args.gossip_period,
                                gossip_fanout=args.gossip_fanout)
    kw = dict(seeds=range(args.seeds), V=V, T_d=TD, device=dev,
              draws=args.draws, mix=mix)

    exec_store = None
    if args.p2p:
        transfer = TransferModel(img_bytes=args.img_mb * 1e6)
        exec_store = StoreSpec(R=args.replicas, transfer=transfer)
        p2p = simulate_workflow(
            spec, scen, policy=adaptive_pol, store=exec_store, **kw)
        report(f"P2P store (R={args.replicas})", p2p, show_server=True)

        server_only = simulate_workflow(
            spec, scen, policy=adaptive_pol,
            store=StoreSpec(R=0, transfer=transfer), **kw)
        report("server-only store (R=0)", server_only, show_server=True)

        saved = 1.0 - (p2p.server_bytes.mean()
                       / max(server_only.server_bytes.mean(), 1.0))
        pct = 100.0 * p2p.mean_makespan / server_only.mean_makespan
        print(f"\nP2P offload: {100 * saved:.1f}% of server I/O eliminated; "
              f"makespan {pct:.1f}% of the server-only baseline")
    else:
        adaptive = simulate_workflow(spec, scen, policy=adaptive_pol, **kw)
        report("adaptive checkpointing", adaptive)

        fixed = simulate_workflow(
            spec, scen, policy=PolicyConfig(kind="fixed", fixed_T=3600.0),
            **kw)
        report("fixed 1h checkpointing", fixed)

        rel = 100.0 * fixed.mean_makespan / adaptive.mean_makespan
        print(f"\nworkflow relative runtime (Eq. 11 on makespan): {rel:.1f}% "
              f"({'adaptive wins' if rel > 100 else 'fixed wins'})")

    if args.execute:
        # The executed run matches the predicted one: same mix, same store.
        execute_for_real(spec, scen, adaptive_pol,
                         sim_seeds=max(args.seeds, 8),
                         exec_seeds=args.exec_seeds, mix=mix,
                         store=exec_store, device=dev, draws=args.draws)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
