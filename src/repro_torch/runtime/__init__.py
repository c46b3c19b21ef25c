"""Runtime of the port: the fault-tolerant trainer, the failure injector
(live and schedule-replay modes) and the serialized failure schedules."""
from repro_torch.runtime.failures import (
    FailureEvent,
    FailureInjector,
    ScheduleExhausted,
    SimulatedFailure,
    StageSchedule,
    StragglerMonitor,
    WorkflowSchedule,
    build_stage_schedule,
)
from repro_torch.runtime.trainer import (
    CheckpointPolicyConfig,
    FaultTolerantTrainer,
    TrainerReport,
)

__all__ = [
    "CheckpointPolicyConfig", "FailureEvent", "FailureInjector",
    "FaultTolerantTrainer", "ScheduleExhausted", "SimulatedFailure",
    "StageSchedule", "StragglerMonitor", "TrainerReport",
    "WorkflowSchedule", "build_stage_schedule",
]
