"""The checkpointable superstep loop of one stage, the digital twin's
executor side (the port of ``repro/exec/superstep.py``).

This loop is the executor-side image of
:func:`repro_torch.sim.job.simulate_job` — same cycle semantics, same
waste accounting — with the simulated state replaced by a real
:class:`~repro_torch.exec.tasks.StageTask` payload (tensors on the task's
device) and the simulated storage by a real
:class:`~repro_torch.ckpt.async_ckpt.AsyncCheckpointer`, whose ``save``
copies every leaf to host memory before it returns, so the next superstep
can never change an image in flight.  Control flow runs on the virtual
clock of the replayed schedule, never on payload values, so supersteps,
failures, checkpoints, restores and censoring are the same on every
device:

* time advances on the injector's virtual clock; a stage's fault-free work
  is quantized into supersteps of ``cfg.seconds_per_superstep`` WORK units,
  each costing ``work / speed`` virtual seconds at the schedule's recorded
  class speed (``interval * speed`` work committed per cadence, exactly the
  engine's heterogeneous cycle law; speed is 1.0 for class-free schedules);
* before computing, each dependency's output is fetched under churn.
  Without a pinned store the edge costs ``stage.handoff`` flat virtual
  seconds; with one, the fetch reads the schedule's holder realization at
  the attempt's virtual time — striped over the surviving holders' class
  uplinks, server fallback (billed as server I/O per attempt) when all
  replicas are down — exactly the sim's `_handoff_times` law;
* a checkpoint is taken when the time since the last commit reaches the
  controller's live interval: ``V`` churn-exposed virtual seconds plus a
  real save (step number == superstep) replicated via HRW placement;
* a job failure rolls back: everything since the last commit is recompute
  waste, then restore time is paid (retried under churn).  With a pinned
  store the restore latency is *endogenous* — derived from the holders
  alive at that virtual instant in the schedule's realization, the same
  data the sim's closed-form survivor law models — otherwise the exogenous
  ``T_d`` applies as before.  The payload is reloaded from the newest
  *surviving* replica — a corrupt primary falls through to the neighbours;
* the final payload is persisted at step ``n_supersteps`` with no virtual
  cost (the sim's final cycle has no V either — the output transfer is
  billed on the consuming edge), marking the stage complete for the
  resume protocol.

Censoring mirrors the sim too: a stage that exceeds ``max_wall_factor``
times its fault-free wall time (hand-off and compute horizons separately)
is reported incomplete rather than spun on; a retry loop that instead
outlives the schedule's recorded horizon
(:class:`~repro_torch.runtime.failures.ScheduleExhausted`) is reported
censored the same way, flagged on the report, rather than crashing the
executor.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.ckpt.async_ckpt import AsyncCheckpointer
from repro_torch.core.adaptive import AdaptiveCheckpointController
from repro_torch.exec.state import (
    ExecutorConfig,
    ExecutorKilled,
    KillSpec,
    StageExecReport,
)
from repro_torch.exec.tasks import StageTask
from repro_torch.runtime.failures import (
    FailureInjector,
    ScheduleExhausted,
    SimulatedFailure,
    StageSchedule,
)
from repro_torch.sim.workflow import Stage


def run_stage(
    stage: Stage,
    task: StageTask,
    dep_payloads: Dict[str, Any],
    schedule: StageSchedule,
    ckpt: AsyncCheckpointer,
    cfg: ExecutorConfig,
    *,
    resume: bool = False,
    kill: Optional[KillSpec] = None,
    real_t0: Optional[float] = None,
) -> Tuple[StageExecReport, Optional[Any]]:
    """Run (or resume) one stage to completion under the pinned schedule.

    Returns ``(report, payload)``; ``payload`` is None when the stage was
    censored.  ``report.finish`` holds the stage-relative elapsed virtual
    time (the caller rebases it onto the workflow clock).  An injected
    :class:`KillSpec` raises :class:`ExecutorKilled` mid-superstep.
    """
    speed = schedule.job_speed()
    n_super = max(int(round(stage.work / cfg.seconds_per_superstep)), 1)
    sps = stage.work / n_super  # exact: n_super supersteps == stage.work
    stage_wall = stage.work / speed
    V = stage.V if stage.V is not None else cfg.V
    T_d = stage.T_d if stage.T_d is not None else cfg.T_d
    endo = schedule.store is not None
    if endo:
        transfer = schedule.store.transfer
        img = transfer.img_bytes
        holders = schedule.holder_view()
        uplinks = schedule.holder_uplinks()
    inj = FailureInjector.from_schedule(schedule,
                                        seconds_per_step=sps / speed)
    ctl = AdaptiveCheckpointController(
        k=schedule.job_hazard_sum(), prior_mu=cfg.prior_mu, prior_v=V,
        mu_window=cfg.mu_window, min_interval=cfg.min_interval,
        max_interval=cfg.max_interval)
    rep = StageExecReport(name=stage.name, n_supersteps=n_super)

    def interval() -> float:
        if cfg.policy == "fixed":
            return cfg.fixed_interval
        return ctl.checkpoint_interval()

    def feed() -> None:
        # Watched-neighbourhood deaths -> the live estimator, the same
        # observation stream the sim's AdaptivePolicy consumes (the job's
        # own failure event is part of it: slot < k implies slot < watch).
        for lifetime in inj.drain_observations():
            ctl.observe_failure(lifetime)

    def censored() -> Tuple[StageExecReport, None]:
        rep.completed = False
        rep.final_interval = interval()
        rep.finish = inj.virtual_time
        return rep, None

    def fetch_cost() -> Tuple[float, bool]:
        # Endogenous transfer time at the current virtual instant: stripe
        # over the uplinks of the holders alive NOW in the pinned
        # realization; (server_seconds, True) when all replicas are down.
        alive: List[int] = holders.alive_slots(inj.virtual_time)
        td = transfer.restore_seconds_from([uplinks[i] for i in alive])
        return td, not alive

    def save(step: int, payload: Any) -> None:
        t0 = time.monotonic()
        ckpt.save(step, payload)
        ckpt.wait()
        rep.write_real_s += time.monotonic() - t0

    like = task.init(dep_payloads)
    got = ckpt.restore_latest(like) if resume else None
    if got is not None and got[0] >= n_super:
        # A previous incarnation already committed the stage output.
        rep.start_superstep = rep.committed_superstep = n_super
        rep.completed = rep.resumed = True
        return rep, got[1]

    try:
        # -------------------------------------------------------------- #
        # Hand-off: fetch each dependency's output under churn.  Skipped #
        # on a mid-stage resume — the restored payload folds the deps in.#
        # -------------------------------------------------------------- #
        if got is None:
            edge_budget = schedule.store.td_server if endo else stage.handoff
            total_handoff = edge_budget * len(stage.deps)
            handoff_censor = cfg.max_wall_factor * max(total_handoff,
                                                       stage_wall)
            for _dep in stage.deps:
                while True:
                    if inj.virtual_time > handoff_censor:
                        return censored()
                    cost, from_server = fetch_cost() if endo \
                        else (stage.handoff, False)
                    if cost <= 0.0:
                        break
                    attempt_start = inj.virtual_time
                    try:
                        inj.advance_exposed(cost)
                        feed()
                        if from_server:
                            rep.server_bytes += img
                        break
                    except SimulatedFailure as f:
                        lost = f.at_virtual_time - attempt_start
                        rep.handoff_waste += lost
                        if from_server:
                            # The interrupted fetch still moved elapsed /
                            # total of the image through the shared pipe.
                            rep.server_bytes += img * min(lost / cost, 1.0)
                        feed()
            rep.handoff_time = inj.virtual_time
            superstep = 0
            payload = like
        else:
            superstep, payload = got
            rep.resumed = True
        rep.start_superstep = rep.committed_superstep = superstep

        # -------------------------------------------------------------- #
        # Superstep loop: compute, checkpoint at the live cadence, roll   #
        # back to the newest surviving replica on failure.                #
        # -------------------------------------------------------------- #
        v0 = inj.virtual_time
        stage_censor = cfg.max_wall_factor * stage_wall
        last_commit_v = inj.virtual_time
        while superstep < n_super:
            if inj.virtual_time - v0 > stage_censor:
                return censored()
            try:
                inj.advance_step()
                payload = task.step(payload, superstep)
                superstep += 1
                rep.executed_supersteps += 1
                if rep.first_step_real_s is None and real_t0 is not None:
                    rep.first_step_real_s = time.monotonic() - real_t0
                if kill is not None and \
                        rep.executed_supersteps >= kill.after_supersteps:
                    raise ExecutorKilled(stage.name, superstep)
                feed()
                if cfg.policy != "fixed":
                    # Fold hazard-weighted failure-free exposure; pure
                    # wasted work on the fixed-interval path, so skipped.
                    ctl.tick(inj.virtual_time,
                             exposure_peers=schedule.watch_hazard_sum())
                if superstep < n_super and \
                        inj.virtual_time - last_commit_v >= interval():
                    inj.advance_exposed(V)  # checkpoint stall, churn-exposed
                    save(superstep, payload)
                    rep.committed_superstep = superstep
                    rep.n_checkpoints += 1
                    rep.checkpoint_time += V
                    if endo and schedule.store.R == 0:
                        # Server-only mode uploads every image to the
                        # work-pool server; with peer replicas the image
                        # goes to holders and costs the server nothing.
                        rep.server_bytes += img
                    ctl.observe_checkpoint_overhead(V)
                    feed()
                    last_commit_v = inj.virtual_time
            except SimulatedFailure as f:
                # Everything since the last commit — uncommitted
                # supersteps, the partial one, any in-flight checkpoint —
                # is waste.
                rep.n_failures += 1
                rep.recompute_waste += f.at_virtual_time - last_commit_v
                feed()
                while True:  # restore, retried under churn (sim's loop)
                    if inj.virtual_time - v0 > stage_censor:
                        return censored()
                    attempt_start = inj.virtual_time
                    td, from_server = fetch_cost() if endo else (T_d, False)
                    try:
                        inj.advance_exposed(td)
                        feed()
                        rep.restore_time += td
                        if from_server:
                            rep.server_bytes += img
                            rep.n_server_restores += 1
                        break
                    except SimulatedFailure:
                        lost = inj.virtual_time - attempt_start
                        rep.restore_time += lost
                        if from_server and td > 0.0:
                            rep.server_bytes += img * min(lost / td, 1.0)
                        feed()
                ctl.observe_restore(td)
                rep.n_restores += 1
                t_read = time.monotonic()
                restored = ckpt.restore_latest(like)
                rep.restore_real_s += time.monotonic() - t_read
                if restored is not None:
                    superstep, payload = restored
                else:  # nothing durable yet: roll back to stage start
                    superstep, payload = 0, task.init(dep_payloads)
                rep.committed_superstep = superstep
                last_commit_v = inj.virtual_time
    except ScheduleExhausted:
        # A censoring-bound run (livelocked hand-off or restore-retry
        # loop) ran off the recorded horizon before hitting its wall
        # budget: beyond it the schedule carries no information, so the
        # stage is reported censored — never a crash.
        rep.schedule_exhausted = True
        return censored()

    # Persist the stage output (the image dependents fetch; also the resume
    # marker: committed step == n_super means complete).  No virtual cost —
    # the sim's final cycle omits V and bills the transfer on the edge.
    save(n_super, payload)
    rep.committed_superstep = n_super
    rep.completed = True
    rep.final_interval = interval()
    rep.finish = inj.virtual_time
    return rep, payload
