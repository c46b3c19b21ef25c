"""The resumable workflow executor: run a DAG for real, twin to the sim
(the port of ``repro/exec/executor.py``).

:class:`WorkflowExecutor` takes the SAME
:class:`~repro_torch.sim.workflow.Stage` DAG the simulator runs, binds each
stage to a real :class:`~repro_torch.exec.tasks.StageTask` (whose payloads
live on the task's device), and executes stages in topological order under
a pinned :class:`~repro_torch.runtime.failures.WorkflowSchedule` —
the serialized churn realization the sim predicts against.  A schedule
built with a ``mix``/``store`` carries each stage's class map and replica-
holder realization, and the stages then run heterogeneous (supersteps at
class speed, hazard-weighted estimator exposure) with endogenous restore
and hand-off latency read off the pinned holders — one cycle-accounting
core shared with the sim's closed-form law.  Every stage persists through
its own :class:`~repro_torch.ckpt.async_ckpt.AsyncCheckpointer` over per-stage
primary + neighbour directories (HRW placement, corrupt-primary fallback)
and keeps there its own newest ``KEEP_IMAGES`` images (the reference keeps
every image; a restore reads the newest surviving one, so the run is the
same, while the disk and each rollback's directory scan stay small), and
the resume protocol is just "reopen the executor with
``resume=True``": each stage restores from the newest surviving replica, a
stage whose committed step already covers its supersteps is skipped, and
execution continues from exactly the last durable superstep.

Typical crash-and-resume round trip::

    ex = WorkflowExecutor(spec, tasks, schedule, cfg)
    try:
        ex.run(kill=KillSpec("train", after_supersteps=25))
    except ExecutorKilled:
        pass                       # the 'process' died mid-superstep
    report = WorkflowExecutor(spec, tasks, schedule, cfg).run(resume=True)
"""
from __future__ import annotations

import time
from typing import Any, Dict, Mapping, Optional

from repro_torch.ckpt.async_ckpt import AsyncCheckpointer
from repro_torch.exec.state import (
    ExecReport,
    ExecutorConfig,
    KillSpec,
    stage_paths,
)
from repro_torch.exec.superstep import run_stage
from repro_torch.exec.tasks import StageTask
from repro_torch.runtime.failures import WorkflowSchedule
from repro_torch.sim.workflow import WorkflowSpec

# Each stage's own images kept in each directory: the newest, and one
# behind it should every copy of the newest be torn.
KEEP_IMAGES = 2


class WorkflowExecutor:
    """Execute a workflow DAG as real superstep-checkpointed work units.

    One instance models one *incarnation* of the executor process: ``run``
    walks the DAG once, and an injected :class:`KillSpec` terminates the
    incarnation by raising :class:`~repro_torch.exec.state.ExecutorKilled`.  A
    fresh instance over the same ``cfg.root`` with ``resume=True`` picks
    up from the durable state — the paper's recover-from-P2P-storage path.
    """

    def __init__(
        self,
        spec: WorkflowSpec,
        tasks: Mapping[str, StageTask],
        schedule: WorkflowSchedule,
        cfg: ExecutorConfig,
    ):
        missing_tasks = {s.name for s in spec.stages} - set(tasks)
        if missing_tasks:
            raise ValueError(f"no task bound for stages {sorted(missing_tasks)}")
        missing_sched = {s.name for s in spec.stages} - set(schedule.stages)
        if missing_sched:
            raise ValueError(f"no schedule for stages {sorted(missing_sched)}")
        for s in spec.stages:
            if schedule.stages[s.name].k != s.k:
                raise ValueError(
                    f"stage {s.name!r}: schedule was built for "
                    f"k={schedule.stages[s.name].k}, spec has k={s.k}")
        self.spec = spec
        self.tasks = dict(tasks)
        self.schedule = schedule
        self.cfg = cfg

    # ------------------------------------------------------------------ #
    def run(self, *, resume: bool = False,
            kill: Optional[KillSpec] = None) -> ExecReport:
        """Execute (or resume) the whole DAG.  Raises ExecutorKilled when
        ``kill`` fires; everything committed before the kill is durable."""
        cfg = self.cfg
        t_real0 = time.monotonic()
        report = ExecReport()
        payloads: Dict[str, Any] = {}
        finish: Dict[str, float] = {}
        ok: Dict[str, bool] = {}

        for stage in self.spec.topo_order():
            ready = max((finish[d] for d in stage.deps), default=0.0)
            if not all(ok[d] for d in stage.deps):
                # Censored dependency: this stage can never fetch its
                # inputs — mark unfinished, same containment rule as the sim.
                finish[stage.name] = ready
                ok[stage.name] = False
                continue
            paths = stage_paths(cfg.root, stage.name, cfg.n_replica_dirs)
            ckpt = AsyncCheckpointer(
                root=paths.primary, replicas=paths.replicas,
                n_shards=cfg.n_shards,
                replication_factor=cfg.replication_factor, keep=KEEP_IMAGES)
            try:
                srep, payload = run_stage(
                    stage, self.tasks[stage.name],
                    {d: payloads[d] for d in stage.deps},
                    self.schedule.stages[stage.name], ckpt, cfg,
                    resume=resume,
                    kill=kill if kill is not None and kill.stage == stage.name
                    else None,
                    real_t0=t_real0)
            finally:
                ckpt.close()
            elapsed = srep.finish  # stage-relative; rebase onto DAG clock
            srep.ready = ready
            srep.finish = ready + elapsed
            report.stages[stage.name] = srep
            finish[stage.name] = srep.finish
            ok[stage.name] = srep.completed
            if payload is not None:
                payloads[stage.name] = payload
            if resume and report.resume_latency_s is None \
                    and srep.first_step_real_s is not None:
                report.resume_latency_s = srep.first_step_real_s

        report.completed = bool(ok) and all(ok.values())
        report.makespan = max(finish.values(), default=0.0)
        report.real_seconds = time.monotonic() - t_real0
        return report

    # ------------------------------------------------------------------ #
    def output(self, stage: str, like: Any) -> Optional[Any]:
        """The committed output payload of ``stage`` (None if not durable)."""
        paths = stage_paths(self.cfg.root, stage, self.cfg.n_replica_dirs)
        ckpt = AsyncCheckpointer(
            root=paths.primary, replicas=paths.replicas,
            n_shards=self.cfg.n_shards,
            replication_factor=self.cfg.replication_factor)
        try:
            got = ckpt.restore_latest(like)
        finally:
            ckpt.close()
        return None if got is None else got[1]
