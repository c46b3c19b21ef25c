"""Runtime of the port: the fault-tolerant trainer and its failure
injector (the replay mode waits for ROADMAP Queue 1 item 7)."""
from repro_torch.runtime.failures import (
    FailureInjector,
    SimulatedFailure,
    StragglerMonitor,
)
from repro_torch.runtime.trainer import (
    CheckpointPolicyConfig,
    FaultTolerantTrainer,
    TrainerReport,
)

__all__ = [
    "CheckpointPolicyConfig", "FailureInjector", "FaultTolerantTrainer",
    "SimulatedFailure", "StragglerMonitor", "TrainerReport",
]
