"""Churn simulation on torch (port of ``repro.sim``).

* :mod:`repro_torch.sim.scenarios` -- registry of named churn environments.
* :mod:`repro_torch.sim.network` / :mod:`repro_torch.sim.job` -- the
  per-event reference simulator (the parity oracle; numpy host code).
* :mod:`repro_torch.sim.engine` -- the batched cycle-level Monte-Carlo
  engine, stepped by the CUDA kernel of :mod:`repro_torch.kernels.sim_step`
  (or, for per-peer-form batches, by its plain torch step).
* :mod:`repro_torch.sim.draws` -- the Philox and numpy-parity draw sources.
* :mod:`repro_torch.sim.workflow` -- inter-dependent DAG stages (the
  paper's work flows) and the digital-twin bridge (pinned failure
  schedules, predicted waste).
* :mod:`repro_torch.sim.experiments` -- the Fig. 4/5 grids on either
  engine, and the server-offload, gossip-fidelity, heterogeneity and
  correlated-churn sweeps.
"""
from repro_torch.sim.engine import (
    BatchResult,
    CellSpec,
    PolicyConfig,
    batch_step,
    run_cells,
)
from repro_torch.sim.experiments import (
    Comparison,
    GossipFidelityCell,
    GridEntry,
    HeterogeneityCell,
    OffloadCell,
    ShockCell,
    compare,
    compare_grid,
    correlated_churn_sweep,
    fig4_dynamic,
    fig4_static,
    fig5_td_sweep,
    fig5_v_sweep,
    gossip_csv,
    gossip_fidelity_sweep,
    hetero_csv,
    heterogeneity_sweep,
    offload_csv,
    scenario_sweep,
    server_offload_sweep,
    shock_csv,
    summarize,
)
from repro_torch.sim.job import (
    AdaptivePolicy,
    FixedIntervalPolicy,
    GossipAdaptivePolicy,
    OraclePolicy,
    SimResult,
    simulate_job,
)
from repro_torch.sim.network import (
    ChurnNetwork,
    DeathEvent,
    constant_mtbf,
    doubling_mtbf,
)
from repro_torch.sim.scenarios import (
    SHOCK_STREAM,
    PeerClass,
    PeerClassMix,
    Scenario,
    ShockClock,
    ShockSpec,
    available_mixes,
    available_scenarios,
    peer_class_mix,
    register_mix,
    register_scenario,
    resolve_shock,
    scenario,
)
from repro_torch.sim.workflow import (
    Stage,
    StageResult,
    WorkflowResult,
    WorkflowSpec,
    export_failure_schedule,
    predicted_waste,
    simulate_workflow,
    waste_band,
)

__all__ = [
    "AdaptivePolicy",
    "BatchResult",
    "CellSpec",
    "ChurnNetwork",
    "Comparison",
    "DeathEvent",
    "FixedIntervalPolicy",
    "GossipAdaptivePolicy",
    "GossipFidelityCell",
    "GridEntry",
    "HeterogeneityCell",
    "OffloadCell",
    "OraclePolicy",
    "PeerClass",
    "PeerClassMix",
    "PolicyConfig",
    "SHOCK_STREAM",
    "Scenario",
    "ShockCell",
    "ShockClock",
    "ShockSpec",
    "SimResult",
    "Stage",
    "StageResult",
    "WorkflowResult",
    "WorkflowSpec",
    "available_mixes",
    "available_scenarios",
    "batch_step",
    "compare",
    "compare_grid",
    "constant_mtbf",
    "correlated_churn_sweep",
    "doubling_mtbf",
    "export_failure_schedule",
    "fig4_dynamic",
    "fig4_static",
    "fig5_td_sweep",
    "fig5_v_sweep",
    "gossip_csv",
    "gossip_fidelity_sweep",
    "hetero_csv",
    "heterogeneity_sweep",
    "offload_csv",
    "peer_class_mix",
    "predicted_waste",
    "register_mix",
    "register_scenario",
    "resolve_shock",
    "run_cells",
    "scenario",
    "scenario_sweep",
    "server_offload_sweep",
    "shock_csv",
    "simulate_job",
    "simulate_workflow",
    "summarize",
    "waste_band",
]
