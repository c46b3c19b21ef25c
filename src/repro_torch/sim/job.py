"""Per-cell simulation result (copy of ``repro.sim.job.SimResult``).

The per-event heap simulator (``simulate_job``) and the churn network it
walks are not ported yet; the batched engine returns its cells in this
shape.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SimResult:
    wall_time: float        # total wall-clock time to completion
    work_required: float    # fault-free runtime of the job
    n_checkpoints: int
    n_failures: int
    wasted_work: float      # wall time lost to failed cycles (rollback)
    checkpoint_time: float  # seconds spent checkpointing
    restore_time: float     # seconds spent downloading images
    completed: bool = True  # False => censored at wall_time (job livelocked)
    server_bytes: float = 0.0     # I/O imposed on the work-pool server
    n_server_restores: int = 0    # restores served by the server fallback
    n_peer_restores: int = 0      # restores served from peer replicas

    @property
    def overhead(self) -> float:
        return self.wall_time - self.work_required

    @property
    def utilization(self) -> float:
        return self.work_required / self.wall_time
