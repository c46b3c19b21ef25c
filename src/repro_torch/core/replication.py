"""Replication + checkpointing combined (paper Sec 4.3, future work; the
port of ``repro/core/replication.py``).

The paper's discussion: combine process replication with checkpointing so a
rollback is needed only when *all* replicas of a process fail, raising the
effective job MTBF.  We implement the analytical model and expose it to the
runtime so the controller can evaluate "R-way replicated" operating points
(a beyond-paper feature; on GPU fleets this corresponds to hot-spare nodes
or redundant optimizer-state shards).

Model: each logical process has R replicas, each failing at rate mu.  The
*process* is lost when its last live replica dies before a replacement
arrives.  With a replacement (re-spawn) time of ``t_repair`` seconds, a
process loss requires >= R-1 additional failures of the same replica group
within the repair window — for exponential failures the effective process
failure rate is approximately

    mu_eff ~= mu * (mu * t_repair)^(R-1) * binom(R, 1)   (R >= 1 small-rate)

which for R=1 degrades to mu and for R=2 gives the classic 2 mu^2 t_repair.
The job-level rate is then k * mu_eff, fed into the same utilization model.

The same R-of-N survival law now has an exact, *simulated* counterpart in
the P2P checkpoint store: :func:`repro_torch.p2p.overlay.stationary_loss_rate`
is the closed-form steady-state all-replicas-dead transition rate of the
alternating-renewal holder process, and
:class:`repro_torch.p2p.overlay.ReplicaSetProcess` simulates it per event.
``effective_failure_rate`` is the small-rate (mu * t_repair << 1) limit of
both; ``tests/test_torch_policy.py`` holds them to the reference's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.utilization import UtilizationReport


def effective_failure_rate(mu: float, R: int, t_repair: float,
                           exact: bool = False) -> float:
    """Effective per-process failure rate under R-way replication.

    ``exact=True`` returns the stationary all-replicas-dead transition
    rate of the alternating-renewal holder process instead of the cascade
    approximation — the law the P2P checkpoint store simulates.  The two
    agree to leading order in mu * t_repair.
    """
    if R < 1:
        raise ValueError("replication factor must be >= 1")
    if exact:
        from repro_torch.p2p.overlay import stationary_loss_rate

        return stationary_loss_rate(mu, R, t_repair)
    if R == 1:
        return mu
    # Probability all R-1 surviving replicas also die within the repair
    # window, times the rate of first failures across the group (R * mu).
    p_cascade = (1.0 - math.exp(-mu * t_repair)) ** (R - 1)
    return R * mu * p_cascade


@dataclass(frozen=True)
class ReplicationPlan:
    R: int
    t_repair: float
    mu_eff: float
    overhead_factor: float  # compute overhead of running R replicas
    report: UtilizationReport

    @property
    def effective_throughput(self) -> float:
        """Utilization discounted by the replica compute overhead."""
        return self.report.U_star / self.overhead_factor


def plan_replication(mu: float, k: int, V: float, T_d: float,
                     R: int, t_repair: float) -> ReplicationPlan:
    """Evaluate an R-way replication operating point."""
    mu_eff = effective_failure_rate(mu, R, t_repair)
    report = UtilizationReport.evaluate(mu_eff, k, V, T_d)
    return ReplicationPlan(R=R, t_repair=t_repair, mu_eff=mu_eff,
                           overhead_factor=float(R), report=report)


def best_replication(mu: float, k: int, V: float, T_d: float,
                     t_repair: float, r_max: int = 4) -> ReplicationPlan:
    """Pick the R maximizing utilization *per unit of compute*.

    Replication burns R x the resources, so the objective is
    U*(mu_eff) / R; for the paper's typical numbers (hour-scale MTBF,
    tens-of-seconds overheads) R=1 wins — replication only pays when k*mu
    is so large that U(R=1) collapses toward 0, exactly the regime Sec 4.3
    motivates.
    """
    plans = [plan_replication(mu, k, V, T_d, R, t_repair) for R in range(1, r_max + 1)]
    return max(plans, key=lambda p: p.effective_throughput)
