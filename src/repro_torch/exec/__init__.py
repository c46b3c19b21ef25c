"""Resumable workflow executor — the sim's real-execution twin (the port
of ``repro.exec``).

``repro_torch.sim.workflow`` predicts a DAG's behaviour under churn;
``repro_torch.exec`` runs the same DAG as real work units (torch tensors on
the task's device) with superstep checkpointing, P2P-style replication,
and deterministic failure injection replayed from the sim's exported
schedules.
"""
from repro_torch.exec.executor import WorkflowExecutor
from repro_torch.exec.state import (
    ExecReport,
    ExecutorConfig,
    ExecutorKilled,
    KillSpec,
    StageExecReport,
    StagePaths,
    stage_paths,
)
from repro_torch.exec.superstep import run_stage
from repro_torch.exec.tasks import (
    MixTask,
    PowerIterTask,
    StageTask,
    from_reference_payload,
)

__all__ = [
    "ExecReport",
    "ExecutorConfig",
    "ExecutorKilled",
    "KillSpec",
    "MixTask",
    "PowerIterTask",
    "StageExecReport",
    "StagePaths",
    "StageTask",
    "WorkflowExecutor",
    "from_reference_payload",
    "run_stage",
    "stage_paths",
]
