"""Paper Sec 4 experiments on the torch engine: adaptive vs fixed intervals.

Ports the Fig. 4/5 grids of ``repro.sim.experiments`` onto
:func:`repro_torch.sim.engine.run_cells` (the batched engine only; the
per-event reference engine is not ported).  Every (entry x policy x seed)
cell of a grid runs in one batch.  The relative-runtime metric (Eq. 11):

    RelativeRuntime = runtime(fixed T) / runtime(adaptive) * 100%

Values > 100% mean the adaptive scheme is faster.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

from repro_torch.sim.engine import CellSpec, PolicyConfig, run_cells
from repro_torch.sim.job import SimResult
from repro_torch.sim.scenarios import Scenario, scenario

# Paper Sec 4.2 defaults.
PAPER_V = 20.0
PAPER_TD = 50.0
PAPER_MTBFS = (4000.0, 7200.0, 14400.0)          # high / normal / low churn
PAPER_FIXED_INTERVALS = (60.0, 300.0, 900.0, 1800.0, 3600.0, 7200.0)
DEFAULT_K = 16            # job MTBF lands in the paper's '5-10 minutes' band
DEFAULT_WORK = 24 * 3600.0  # 'a typical job of a few hours .. up to days'
DEFAULT_SLOTS = 128       # network population (>= watch neighbourhood)


@dataclass(frozen=True)
class Comparison:
    """One (network condition, fixed T) cell of a paper figure."""

    mtbf0: float
    fixed_T: float
    adaptive_wall: float
    fixed_wall: float
    oracle_wall: float
    adaptive: SimResult
    fixed: SimResult

    @property
    def relative_runtime(self) -> float:
        """Eq. 11, in percent; >100 means adaptive wins."""
        return 100.0 * self.fixed_wall / self.adaptive_wall

    @property
    def oracle_gap(self) -> float:
        """adaptive / oracle runtime: how much estimation error costs (>=~1)."""
        return self.adaptive_wall / self.oracle_wall


@dataclass(frozen=True)
class GridEntry:
    """One comparison point of a figure grid (scenario + fixed T + costs)."""

    scenario: Scenario
    mtbf0: float
    fixed_T: float
    V: float = PAPER_V
    T_d: float = PAPER_TD


def grid_cells(entries: Sequence[GridEntry], *, k: int = DEFAULT_K,
               work: float = DEFAULT_WORK,
               seeds: Sequence[int] = tuple(range(8)),
               n_slots: int = DEFAULT_SLOTS,
               max_wall_factor: float = 50.0) -> List[CellSpec]:
    """The cells of a grid, ordered (entry, policy adaptive/fixed/oracle,
    seed) as ``repro.sim.experiments.compare_grid`` orders them."""
    cells = []
    for e in entries:
        policies = (
            PolicyConfig(kind="adaptive", prior_mu=1.0 / e.mtbf0, prior_v=e.V),
            PolicyConfig(kind="fixed", fixed_T=e.fixed_T),
            PolicyConfig(kind="oracle"),
        )
        for pol in policies:
            for s in seeds:
                cells.append(CellSpec(
                    scenario=e.scenario, policy=pol, seed=s, k=k, work=work,
                    V=e.V, T_d=e.T_d, n_slots=n_slots,
                    max_wall_time=max_wall_factor * work))
    return cells


def compare_grid(
    entries: Sequence[GridEntry],
    *,
    k: int = DEFAULT_K,
    work: float = DEFAULT_WORK,
    seeds: Sequence[int] = tuple(range(8)),
    n_slots: int = DEFAULT_SLOTS,
    max_wall_factor: float = 50.0,
    **run_kw,
) -> List[Comparison]:
    """Run a whole figure grid of comparisons in one :func:`run_cells`
    batch; ``run_kw`` (device, draws, step, chunk, ...) goes to it."""
    entries = list(entries)
    seeds = list(seeds)
    S = len(seeds)
    cells = grid_cells(entries, k=k, work=work, seeds=seeds, n_slots=n_slots,
                       max_wall_factor=max_wall_factor)
    res = run_cells(cells, **run_kw)
    walls = res.wall_time.reshape(len(entries), 3, S).mean(axis=2)
    out = []
    for i, e in enumerate(entries):
        a_wall, f_wall, o_wall = (float(w) for w in walls[i])
        out.append(Comparison(
            mtbf0=e.mtbf0, fixed_T=e.fixed_T, adaptive_wall=a_wall,
            fixed_wall=f_wall, oracle_wall=o_wall,
            adaptive=res.result((i * 3 + 0) * S + S - 1),
            fixed=res.result((i * 3 + 1) * S + S - 1)))
    return out


def _grid(entries: Sequence[GridEntry], keys: Sequence[float],
          fixed_intervals: Sequence[float],
          kw: dict) -> Dict[float, List[Comparison]]:
    """Run one batched grid and regroup as {key: [Comparison per T]}."""
    comps = iter(compare_grid(entries, **kw))
    return {key: [next(comps) for _ in fixed_intervals] for key in keys}


def fig4_static(
    mtbfs: Sequence[float] = PAPER_MTBFS,
    fixed_intervals: Sequence[float] = PAPER_FIXED_INTERVALS,
    **kw,
) -> Dict[float, List[Comparison]]:
    """Fig. 4 left: constant departure rates (MTBF = 4000/7200/14400 s)."""
    return _grid(fig4_static_entries(mtbfs, fixed_intervals), mtbfs,
                 fixed_intervals, kw)


def fig4_static_entries(
    mtbfs: Sequence[float] = PAPER_MTBFS,
    fixed_intervals: Sequence[float] = PAPER_FIXED_INTERVALS,
) -> List[GridEntry]:
    """The grid entries of :func:`fig4_static`, in its order."""
    return [GridEntry(scenario("constant", mtbf=m), mtbf0=m, fixed_T=T)
            for m in mtbfs for T in fixed_intervals]


def fig4_dynamic(
    mtbfs: Sequence[float] = PAPER_MTBFS,
    fixed_intervals: Sequence[float] = PAPER_FIXED_INTERVALS,
    double_after: float = 20 * 3600.0,
    **kw,
) -> Dict[float, List[Comparison]]:
    """Fig. 4 right: departure rate doubles over 20 hours."""
    return _grid(fig4_dynamic_entries(mtbfs, fixed_intervals, double_after),
                 mtbfs, fixed_intervals, kw)


def fig4_dynamic_entries(
    mtbfs: Sequence[float] = PAPER_MTBFS,
    fixed_intervals: Sequence[float] = PAPER_FIXED_INTERVALS,
    double_after: float = 20 * 3600.0,
) -> List[GridEntry]:
    """The grid entries of :func:`fig4_dynamic`, in its order."""
    return [GridEntry(scenario("doubling", mtbf0=m, double_after=double_after),
                      mtbf0=m, fixed_T=T)
            for m in mtbfs for T in fixed_intervals]


def fig5_v_sweep(
    overheads: Sequence[float] = (5.0, 10.0, 20.0, 40.0, 80.0),
    fixed_intervals: Sequence[float] = PAPER_FIXED_INTERVALS,
    mtbf: float = 7200.0,
    **kw,
) -> Dict[float, List[Comparison]]:
    """Fig. 5 left: vary checkpoint overhead V at fixed T_d=50s, MTBF=7200s."""
    entries = [GridEntry(scenario("constant", mtbf=mtbf), mtbf0=mtbf,
                         fixed_T=T, V=v)
               for v in overheads for T in fixed_intervals]
    return _grid(entries, overheads, fixed_intervals, kw)


def fig5_td_sweep(
    downloads: Sequence[float] = (10.0, 25.0, 50.0, 100.0, 200.0),
    fixed_intervals: Sequence[float] = PAPER_FIXED_INTERVALS,
    mtbf: float = 7200.0,
    **kw,
) -> Dict[float, List[Comparison]]:
    """Fig. 5 right: vary image download overhead T_d at fixed V=20s."""
    entries = [GridEntry(scenario("constant", mtbf=mtbf), mtbf0=mtbf,
                         fixed_T=T, T_d=td)
               for td in downloads for T in fixed_intervals]
    return _grid(entries, downloads, fixed_intervals, kw)
