"""Batched churn simulation on torch (port of ``repro.sim``'s engine path).

* :mod:`repro_torch.sim.scenarios` -- registry of named churn environments.
* :mod:`repro_torch.sim.engine` -- the batched cycle-level Monte-Carlo
  engine, stepped by the CUDA kernel of :mod:`repro_torch.kernels.sim_step`.
* :mod:`repro_torch.sim.draws` -- the Philox and numpy-parity draw sources.
* :mod:`repro_torch.sim.experiments` -- the Fig. 4/5 grids.
"""
from repro_torch.sim.engine import BatchResult, CellSpec, PolicyConfig, run_cells
from repro_torch.sim.experiments import (
    Comparison,
    GridEntry,
    compare_grid,
    fig4_dynamic,
    fig4_static,
    fig5_td_sweep,
    fig5_v_sweep,
)
from repro_torch.sim.scenarios import (
    PeerClass,
    PeerClassMix,
    Scenario,
    ShockSpec,
    peer_class_mix,
    scenario,
)

__all__ = [
    "BatchResult", "CellSpec", "Comparison", "GridEntry", "PeerClass",
    "PeerClassMix", "PolicyConfig", "Scenario", "ShockSpec", "compare_grid",
    "fig4_dynamic", "fig4_static", "fig5_td_sweep", "fig5_v_sweep",
    "peer_class_mix", "run_cells", "scenario",
]
