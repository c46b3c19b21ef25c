"""Executor state: stage layout on disk, reports, kill/resume protocol
(the port of ``repro/exec/state.py``).

The resume protocol is entirely derivable from the checkpoint stores — no
separate progress database:

* each stage owns a primary directory plus ``n_replica_dirs`` neighbour
  directories (:func:`stage_paths`), all under one executor root, so an
  :class:`~repro_torch.ckpt.async_ckpt.AsyncCheckpointer` per stage gives R-way
  HRW placement with corrupt-primary fallback;
* the checkpoint *step number is the superstep*: a committed image at step
  s means supersteps [0, s) are durable;
* a stage whose newest committed step >= its superstep count is complete —
  its payload is the stage output that dependents fetch.

:class:`ExecutorKilled` models a hard process death injected mid-superstep
(the crash-and-resume e2e): the in-flight superstep and everything after
the last committed checkpoint is lost, exactly like a real kill -9.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


class ExecutorKilled(Exception):
    """An injected hard kill — the simulated process dies mid-superstep."""

    def __init__(self, stage: str, superstep: int):
        super().__init__(f"stage {stage!r} killed at superstep {superstep}")
        self.stage = stage
        self.superstep = superstep


@dataclass(frozen=True)
class KillSpec:
    """Kill the process after ``after_supersteps`` supersteps have executed
    in ``stage`` during this incarnation (before anything else commits)."""

    stage: str
    after_supersteps: int

    def __post_init__(self) -> None:
        if self.after_supersteps <= 0:
            raise ValueError("after_supersteps must be positive")


@dataclass(frozen=True)
class ExecutorConfig:
    """Knobs of one executor deployment (shared by every stage).

    Virtual-time parameters (``V``, ``T_d``, priors, clamps) deliberately
    mirror :func:`repro_torch.sim.workflow.simulate_workflow` /
    :class:`repro_torch.core.adaptive.AdaptiveCheckpointController` defaults —
    digital-twin parity requires executor and sim to agree on them.
    ``seconds_per_superstep`` quantizes a stage's fault-free work into
    checkpointable steps; smaller steps track the twin's continuous cycle
    boundaries more closely at more per-step overhead.
    """

    root: str
    n_replica_dirs: int = 3
    replication_factor: Optional[int] = 2
    n_shards: int = 2
    seconds_per_superstep: float = 15.0
    V: float = 20.0
    T_d: float = 50.0
    policy: str = "adaptive"          # "adaptive" | "fixed"
    fixed_interval: float = 600.0
    prior_mu: float = 1.0 / (4 * 3600.0)
    mu_window: int = 32
    min_interval: float = 1.0
    max_interval: float = 24 * 3600.0
    max_wall_factor: float = 50.0

    def __post_init__(self) -> None:
        if self.policy not in ("adaptive", "fixed"):
            raise ValueError(f"unknown executor policy {self.policy!r}")
        if self.seconds_per_superstep <= 0:
            raise ValueError("seconds_per_superstep must be positive")
        if self.n_replica_dirs < 0 or self.n_shards <= 0:
            raise ValueError("need n_replica_dirs >= 0 and n_shards > 0")
        if self.replication_factor is not None and \
                self.replication_factor > self.n_replica_dirs:
            raise ValueError("replication_factor exceeds n_replica_dirs")


@dataclass(frozen=True)
class StagePaths:
    primary: str
    replicas: Tuple[str, ...]


def stage_paths(root: str, stage: str, n_replica_dirs: int) -> StagePaths:
    """Per-stage primary + neighbour replica directories.

    Each stage gets its own subtree of every directory so HRW placement is
    stage-local and one stage's gc can never evict another's images.
    """
    primary = os.path.join(root, "primary", stage)
    replicas = tuple(os.path.join(root, f"replica_{i}", stage)
                     for i in range(n_replica_dirs))
    return StagePaths(primary=primary, replicas=replicas)


@dataclass
class StageExecReport:
    """Measured (not simulated) accounting of one stage incarnation.

    Times are virtual seconds on the injector's clock — the same units the
    digital twin predicts — except ``first_step_real_s`` (resume-latency
    telemetry), ``write_real_s`` (the real seconds the stage's saves took,
    snapshot to committed replicas) and ``restore_real_s`` (the real
    seconds its rollbacks spent finding and reading the newest image),
    which are wall time.
    """

    name: str
    n_supersteps: int
    start_superstep: int = 0
    executed_supersteps: int = 0
    committed_superstep: int = 0
    ready: float = 0.0             # max dep finish (virtual, workflow clock)
    finish: float = 0.0            # ready + this incarnation's elapsed
    handoff_time: float = 0.0      # dep fetches incl. churn retries
    handoff_waste: float = 0.0     # fetch time lost to churn retries
    recompute_waste: float = 0.0   # rolled-back cycle time (paper's waste)
    checkpoint_time: float = 0.0
    restore_time: float = 0.0
    n_failures: int = 0
    n_checkpoints: int = 0
    n_restores: int = 0
    n_server_restores: int = 0     # endogenous restores that fell back to
                                   # the server (all replicas down)
    server_bytes: float = 0.0      # server I/O billed per attempt, the
                                   # engine's accounting (0 without store)
    final_interval: float = 0.0    # controller cadence at stage end
    completed: bool = False
    resumed: bool = False          # started from a prior incarnation's image
    schedule_exhausted: bool = False  # censored by running off the recorded
                                      # horizon, not by the wall budget
    first_step_real_s: Optional[float] = None
    write_real_s: float = 0.0
    restore_real_s: float = 0.0

    @property
    def waste(self) -> float:
        """Total measured waste: recompute + hand-off retries (the quantity
        the sim's :func:`repro_torch.sim.workflow.predicted_waste` predicts)."""
        return self.recompute_waste + self.handoff_waste

    @property
    def elapsed_virtual(self) -> float:
        return self.finish - self.ready


@dataclass
class ExecReport:
    """Whole-DAG execution report (one incarnation of the executor)."""

    stages: Dict[str, StageExecReport] = field(default_factory=dict)
    completed: bool = False
    makespan: float = 0.0          # virtual seconds, max stage finish
    real_seconds: float = 0.0      # wall time of this incarnation
    resume_latency_s: Optional[float] = None  # start -> first resumed step

    @property
    def total_waste(self) -> float:
        return sum(s.waste for s in self.stages.values())

    @property
    def server_bytes(self) -> float:
        """Aggregate work-pool server I/O across every stage (restores and
        hand-off fetches that fell back to the contended server path)."""
        return sum(s.server_bytes for s in self.stages.values())

    @property
    def executed_supersteps(self) -> int:
        return sum(s.executed_supersteps for s in self.stages.values())

    @property
    def n_checkpoints(self) -> int:
        return sum(s.n_checkpoints for s in self.stages.values())

    @property
    def n_restores(self) -> int:
        return sum(s.n_restores for s in self.stages.values())

    @property
    def write_real_s(self) -> float:
        """Real seconds spent saving checkpoints and stage outputs."""
        return sum(s.write_real_s for s in self.stages.values())

    @property
    def restore_real_s(self) -> float:
        """Real seconds rollbacks spent reading the newest image."""
        return sum(s.restore_real_s for s in self.stages.values())

    @property
    def steps_per_second(self) -> float:
        """Real (wall-clock) executor superstep throughput."""
        if self.real_seconds <= 0:
            return 0.0
        return self.executed_supersteps / self.real_seconds
