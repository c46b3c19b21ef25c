"""Paper Sec 4 experiments on the torch engine: adaptive vs fixed intervals.

Ports ``repro.sim.experiments``: the four evaluations of Figs. 4-5, the
scenario sweep, and the server-offload, gossip-fidelity, heterogeneity and
correlated-churn sweeps, with the relative-runtime metric (Eq. 11):

    RelativeRuntime = runtime(fixed T) / runtime(adaptive) * 100%

Values > 100% mean the adaptive scheme is faster.  Each configuration is
averaged over several seeds.

Two execution engines are available:

* ``engine="batched"`` (default) -- :func:`repro_torch.sim.engine.run_cells`;
  every (policy x seed) cell of a comparison or sweep runs in one batch.
  Where the reference takes ``backend=``, these functions take ``**run_kw``
  (``device``, ``draws``, ``step``, ``chunk``, ...), handed to
  :func:`run_cells`.
* ``engine="reference"`` -- the per-event heap simulator
  (:func:`repro_torch.sim.job.simulate_job`), kept as the parity oracle.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.adaptive import AdaptiveCheckpointController
from repro_torch.p2p.store import StoreSpec
from repro_torch.p2p.transfer import TransferModel
from repro_torch.sim.engine import CellSpec, PolicyConfig, batch_step, run_cells
from repro_torch.sim.job import (
    AdaptivePolicy,
    FixedIntervalPolicy,
    OraclePolicy,
    SimResult,
    simulate_job,
)
from repro_torch.sim.network import ChurnNetwork, MtbfFn
from repro_torch.sim.scenarios import (
    PeerClassMix,
    Scenario,
    ShockSpec,
    peer_class_mix,
    scenario,
)

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


def _mean_wall_reference(
    policy_factory: Callable[[], object],
    *,
    mtbf_fn: MtbfFn,
    lifetime_sampler: Optional[Callable] = None,
    k: int,
    work: float,
    V: float,
    T_d: float,
    seeds: Sequence[int],
    n_slots: int,
    max_wall_factor: float = 50.0,
) -> tuple[float, SimResult]:
    walls = []
    last = None
    for seed in seeds:
        rng = np.random.default_rng(seed)
        net = ChurnNetwork(n_slots, mtbf_fn, rng, lifetime_sampler=lifetime_sampler)
        res = simulate_job(
            network=net, policy=policy_factory(), k=k, work_required=work,
            V=V, T_d=T_d, max_wall_time=max_wall_factor * work,
        )
        # Censored (livelocked) runs contribute their lower-bound wall time.
        walls.append(res.wall_time)
        last = res
    return float(np.mean(walls)), last


def _resolve_scenario(mtbf_fn: Optional[MtbfFn], scen: Optional[Scenario],
                      mtbf0: float) -> tuple[Optional[Scenario], Optional[MtbfFn]]:
    """Accept either a structured Scenario or a legacy ``mtbf_fn`` callable
    (recovering the scenario from the tag that constant_mtbf/doubling_mtbf
    attach).  Untagged callables only run on the reference engine."""
    if scen is None and mtbf_fn is not None:
        scen = getattr(mtbf_fn, "scenario", None)
    if scen is not None and mtbf_fn is None:
        mtbf_fn = scen.mtbf_fn
    if scen is None and mtbf_fn is None:
        scen = scenario("constant", mtbf=mtbf0)
        mtbf_fn = scen.mtbf_fn
    return scen, mtbf_fn


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
    engine: str = "batched",
    max_wall_factor: float = 50.0,
    **run_kw,
) -> List[Comparison]:
    """Run a whole figure grid of comparisons.

    On the batched engine every (entry x policy x seed) cell goes into ONE
    :func:`run_cells` batch; ``run_kw`` (device, draws, step, chunk, ...)
    goes to it.  ``engine="reference"`` runs each cell through the
    per-event heap simulator instead.
    """
    entries = list(entries)
    seeds = list(seeds)
    S = len(seeds)
    if engine == "reference":
        return [
            _compare_reference(e, k=k, work=work, seeds=seeds, n_slots=n_slots,
                               max_wall_factor=max_wall_factor)
            for e in entries
        ]
    if engine != "batched":
        raise ValueError(f"unknown engine {engine!r}")
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


def _compare_reference(e: GridEntry, *, k: int, work: float,
                       seeds: Sequence[int], n_slots: int,
                       max_wall_factor: float,
                       mtbf_fn: Optional[MtbfFn] = None) -> Comparison:
    """Per-event heap comparison.  ``mtbf_fn`` overrides the scenario's rate
    function for legacy untagged callables (then ``e.scenario`` may be None)."""
    prior_mu = 1.0 / e.mtbf0
    sampler = None
    if mtbf_fn is None:
        mtbf_fn = e.scenario.mtbf_fn
        sampler = e.scenario.sample_lifetime

    def adaptive_factory():
        return AdaptivePolicy(AdaptiveCheckpointController(
            k=k, prior_mu=prior_mu, prior_v=e.V, mu_window=32))

    def fixed_factory():
        return FixedIntervalPolicy(T=e.fixed_T)

    def oracle_factory():
        return OraclePolicy(k=k, V=e.V, T_d=e.T_d, mtbf_fn=mtbf_fn)

    kw = dict(mtbf_fn=mtbf_fn, lifetime_sampler=sampler, k=k, work=work,
              V=e.V, T_d=e.T_d, seeds=seeds,
              n_slots=n_slots, max_wall_factor=max_wall_factor)
    a_wall, a_res = _mean_wall_reference(adaptive_factory, **kw)
    f_wall, f_res = _mean_wall_reference(fixed_factory, **kw)
    o_wall, _ = _mean_wall_reference(oracle_factory, **kw)
    return Comparison(mtbf0=e.mtbf0, fixed_T=e.fixed_T, adaptive_wall=a_wall,
                      fixed_wall=f_wall, oracle_wall=o_wall,
                      adaptive=a_res, fixed=f_res)


def compare(
    *,
    mtbf_fn: Optional[MtbfFn] = None,
    scenario: Optional[Scenario] = None,
    mtbf0: float,
    fixed_T: float,
    k: int = DEFAULT_K,
    work: float = DEFAULT_WORK,
    V: float = PAPER_V,
    T_d: float = PAPER_TD,
    seeds: Sequence[int] = tuple(range(8)),
    n_slots: int = DEFAULT_SLOTS,
    engine: str = "batched",
    max_wall_factor: float = 50.0,
    **run_kw,
) -> Comparison:
    """Run adaptive vs fixed(T) vs oracle under identical conditions
    (``run_kw`` goes to :func:`run_cells` on the batched engine)."""
    scen, mtbf_fn = _resolve_scenario(mtbf_fn, scenario, mtbf0)
    entry = GridEntry(scenario=scen, mtbf0=mtbf0, fixed_T=fixed_T, V=V, T_d=T_d)
    if scen is None:
        # Untagged bare callable: the vectorized kernel cannot trace it.
        return _compare_reference(entry, k=k, work=work, seeds=list(seeds),
                                  n_slots=n_slots, max_wall_factor=max_wall_factor,
                                  mtbf_fn=mtbf_fn)
    return compare_grid([entry], k=k, work=work, seeds=seeds, n_slots=n_slots,
                        engine=engine, max_wall_factor=max_wall_factor,
                        **run_kw)[0]


# --------------------------------------------------------------------------- #
# The four paper experiments.                                                  #
# --------------------------------------------------------------------------- #

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


def scenario_sweep(
    scenarios: Sequence[Scenario],
    fixed_T: float = 1800.0,
    mtbf0: float = 7200.0,
    **kw,
) -> Dict[str, Comparison]:
    """Beyond-paper: Eq. 11 across arbitrary registry scenarios, one batch.

    Keys are scenario names; duplicates (several parameterizations of one
    kind) are disambiguated with a ``#i`` suffix rather than silently
    overwriting each other.
    """
    entries = [GridEntry(s, mtbf0=mtbf0, fixed_T=fixed_T) for s in scenarios]
    comps = compare_grid(entries, **kw)
    names = [s.name for s in scenarios]
    out = {}
    for i, (name, c) in enumerate(zip(names, comps)):
        key = name if names.count(name) == 1 else f"{name}#{i}"
        out[key] = c
    return out


# --------------------------------------------------------------------------- #
# Server-offload experiment (the abstract's P2P storage claim).                #
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class OffloadCell:
    """One (scenario x replication mode) cell of the server-offload sweep."""

    scenario: str
    R: int                      # 0 = server-only baseline
    mean_wall: float            # mean completion wall time (s)
    mean_server_bytes: float    # mean server I/O per job (bytes)
    mean_server_restores: float
    mean_peer_restores: float
    completed_frac: float

    def csv_row(self) -> str:
        return (f"{self.scenario},{self.R},{self.mean_wall:.1f},"
                f"{self.mean_server_bytes:.0f},{self.mean_server_restores:.2f},"
                f"{self.mean_peer_restores:.2f},{self.completed_frac:.3f}")


OFFLOAD_CSV_HEADER = ("scenario,R,mean_wall_s,server_bytes,server_restores,"
                      "peer_restores,completed_frac")


def server_offload_sweep(
    scenarios: Optional[Sequence[Scenario]] = None,
    R_values: Sequence[int] = (0, 3),
    *,
    transfer: Optional[TransferModel] = None,
    t_repair: float = 600.0,
    k: int = DEFAULT_K,
    work: float = DEFAULT_WORK,
    seeds: Sequence[int] = tuple(range(8)),
    n_slots: int = DEFAULT_SLOTS,
    mtbf0: float = 7200.0,
    max_wall_factor: float = 50.0,
    **run_kw,
) -> List[OffloadCell]:
    """Server-only vs P2P-offloaded checkpoint storage, one engine batch.

    This is the figure the abstract promises: the same jobs under the same
    churn, storing checkpoints either on the work-pool server (R=0 — every
    checkpoint upload and every restore hits the shared server pipe) or on
    R peer replicas (restores stripe across surviving holders; the server
    only serves the rare all-replicas-lost fallback).  Reports completion
    time AND the aggregate server I/O each mode imposes, per scenario.
    """
    if scenarios is None:
        scenarios = [scenario("constant", mtbf=mtbf0),
                     scenario("diurnal", mtbf=mtbf0),
                     scenario("flash_crowd", mtbf=mtbf0)]
    transfer = transfer or TransferModel()
    grid = [(scen, R) for scen in scenarios for R in R_values]
    S = len(list(seeds))
    cells = []
    for scen, R in grid:
        st = StoreSpec(R=R, t_repair=t_repair, transfer=transfer)
        pol = PolicyConfig(kind="adaptive", prior_mu=1.0 / mtbf0, prior_v=PAPER_V)
        for s in seeds:
            cells.append(CellSpec(
                scenario=scen, policy=pol, seed=s, k=k, work=work,
                V=PAPER_V, T_d=st.td_server, n_slots=n_slots,
                max_wall_time=max_wall_factor * work, store=st))
    res = run_cells(cells, **run_kw)
    out = []
    for i, (scen, R) in enumerate(grid):
        sl = slice(i * S, (i + 1) * S)
        out.append(OffloadCell(
            scenario=scen.name, R=R,
            mean_wall=float(res.wall_time[sl].mean()),
            mean_server_bytes=float(res.server_bytes[sl].mean()),
            mean_server_restores=float(res.n_server_restores[sl].mean()),
            mean_peer_restores=float(res.n_peer_restores[sl].mean()),
            completed_frac=float(res.completed[sl].mean())))
    return out


def offload_csv(cells: Sequence[OffloadCell]) -> List[str]:
    """CSV rows (header first) — one row per (scenario, R) cell."""
    return [OFFLOAD_CSV_HEADER] + [c.csv_row() for c in cells]


# --------------------------------------------------------------------------- #
# Gossip-fidelity experiment (the paper's decentralization claim, Sec 3.1.4).  #
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class GossipFidelityCell:
    """One (scenario x estimator regime) cell of the gossip-fidelity sweep."""

    scenario: str
    regime: str                 # "pooled" | "isolated" | "gossip"
    period: float               # gossip period (0 for pooled/isolated)
    fanout: int                 # gossip fanout (0 for pooled/isolated)
    weight: float
    mean_wall: float            # mean completion wall time (s)
    inflation_pct: float        # 100 * (mean_wall / pooled_mean_wall - 1)
    completed_frac: float

    def csv_row(self) -> str:
        return (f"{self.scenario},{self.regime},{self.period:.0f},"
                f"{self.fanout},{self.weight:.2f},{self.mean_wall:.1f},"
                f"{self.inflation_pct:.2f},{self.completed_frac:.3f}")


GOSSIP_CSV_HEADER = ("scenario,regime,period_s,fanout,weight,mean_wall_s,"
                     "inflation_pct,completed_frac")


def gossip_fidelity_sweep(
    scenarios: Optional[Sequence[Scenario]] = None,
    periods: Sequence[float] = (300.0, 3600.0),
    fanouts: Sequence[int] = (1, 3),
    weight: float = 0.5,
    *,
    k: int = DEFAULT_K,
    work: float = 12 * 3600.0,
    seeds: Sequence[int] = tuple(range(16)),
    n_slots: int = DEFAULT_SLOTS,
    mtbf0: float = 4000.0,
    prior_mtbf_factor: float = 8.0,
    max_wall_factor: float = 50.0,
    **run_kw,
) -> List[GossipFidelityCell]:
    """The estimator-fidelity axis of the paper's decentralization claim
    (Sec 3.1.4), one engine batch: the same jobs under the same churn with
    the adaptive estimator pooled (centralized upper bound), isolated (each
    peer learns alone), and gossiping at every (period x fanout) point.
    Reports each regime's mean runtime and its inflation over pooled — how
    much of the centralized benefit the epidemic exchange recovers.

    ``prior_mtbf_factor`` starts the prior at ``prior_mtbf_factor * mtbf0``
    (deliberately too optimistic): estimator fidelity only matters when
    there is something to learn, and an isolated peer sees 1/k of the
    observation stream, so it pays for the bad prior k times longer.  All
    regimes share seeds — common random numbers pair the comparison.

    At k <= 32 the isolated and gossip cells need the per-peer estimator
    form, which the CUDA kernel does not take: unless ``run_kw`` names a
    ``step``, the batch runs the step :func:`batch_step` allows (the
    plain torch step, ``"scan"``, for such a batch).
    """
    if scenarios is None:
        scenarios = [scenario("constant", mtbf=mtbf0),
                     scenario("diurnal", mtbf=mtbf0),
                     scenario("flash_crowd", mtbf=mtbf0)]
    prior_mu = 1.0 / (prior_mtbf_factor * mtbf0)
    base = dict(kind="adaptive", prior_mu=prior_mu, prior_v=PAPER_V)
    regimes: List[tuple] = [
        ("pooled", 0.0, 0, PolicyConfig(regime="pooled", **base)),
        ("isolated", 0.0, 0, PolicyConfig(regime="isolated", **base)),
    ]
    for per in periods:
        for fan in fanouts:
            regimes.append(("gossip", float(per), int(fan), PolicyConfig(
                regime="gossip", gossip_period=float(per),
                gossip_fanout=int(fan), gossip_weight=weight, **base)))
    seeds = list(seeds)
    S = len(seeds)
    grid = [(scen, reg) for scen in scenarios for reg in regimes]
    cells = [CellSpec(scenario=scen, policy=pol, seed=s, k=k, work=work,
                      V=PAPER_V, T_d=PAPER_TD, n_slots=n_slots,
                      max_wall_time=max_wall_factor * work)
             for scen, (_, _, _, pol) in grid for s in seeds]
    run_kw.setdefault("step", batch_step(cells))
    res = run_cells(cells, **run_kw)
    out: List[GossipFidelityCell] = []
    pooled_wall: Dict[str, float] = {}
    for i, (scen, (name, per, fan, _)) in enumerate(grid):
        wall = float(res.wall_time[i * S:(i + 1) * S].mean())
        if name == "pooled":
            pooled_wall[scen.name] = wall
        out.append(GossipFidelityCell(
            scenario=scen.name, regime=name, period=per, fanout=fan,
            weight=weight if name == "gossip" else 0.0, mean_wall=wall,
            inflation_pct=100.0 * (wall / pooled_wall[scen.name] - 1.0),
            completed_frac=float(res.completed[i * S:(i + 1) * S].mean())))
    return out


def gossip_csv(cells: Sequence[GossipFidelityCell]) -> List[str]:
    """CSV rows (header first) — one row per (scenario, regime) cell."""
    return [GOSSIP_CSV_HEADER] + [c.csv_row() for c in cells]


# --------------------------------------------------------------------------- #
# Heterogeneity experiment (skewed fleets, DESIGN.md Sec 7).                   #
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class HeterogeneityCell:
    """One (scenario x peer-class mix) cell of the heterogeneity sweep."""

    scenario: str
    mix: str                    # mix name ("homogeneous", "boinc", ...)
    mean_speed: float           # job compute speed of the mix
    adaptive_wall: float        # mean completion wall time (s)
    fixed_wall: float
    oracle_wall: float
    relative_runtime: float     # Eq. 11: 100 * fixed / adaptive (%)
    oracle_gap: float           # adaptive / oracle (>= ~1)
    completed_frac: float       # adaptive cells that completed

    def csv_row(self) -> str:
        return (f"{self.scenario},{self.mix},{self.mean_speed:.3f},"
                f"{self.adaptive_wall:.1f},{self.fixed_wall:.1f},"
                f"{self.oracle_wall:.1f},{self.relative_runtime:.2f},"
                f"{self.oracle_gap:.4f},{self.completed_frac:.3f}")


HETERO_CSV_HEADER = ("scenario,mix,mean_speed,adaptive_wall_s,fixed_wall_s,"
                     "oracle_wall_s,rel_runtime_pct,oracle_gap,completed_frac")


def default_mixes() -> List[PeerClassMix]:
    """The sweep's canonical skew axis: homogeneous baseline, the BOINC
    fleet, a fast-core deployment, and a heavily volatile two-class skew."""
    return [peer_class_mix("homogeneous"),
            peer_class_mix("boinc"),
            peer_class_mix("fast_core_volunteer_tail"),
            peer_class_mix("two_class", frac_volatile=0.5, hazard_ratio=6.0,
                           speed_ratio=1.5)]


def heterogeneity_sweep(
    scenarios: Optional[Sequence[Scenario]] = None,
    mixes: Optional[Sequence[PeerClassMix]] = None,
    fixed_T: float = 300.0,
    *,
    k: int = DEFAULT_K,
    work: float = DEFAULT_WORK,
    seeds: Sequence[int] = tuple(range(8)),
    n_slots: int = DEFAULT_SLOTS,
    mtbf0: float = 7200.0,
    max_wall_factor: float = 50.0,
    **run_kw,
) -> List[HeterogeneityCell]:
    """Adaptive vs fixed vs oracle across fleet compositions, one batch.

    The experiment the peer-class system exists for: the same scenarios
    under increasingly skewed mixes, asking where adaptation pays most.
    The adaptive prior is the *per-peer base rate* ``1/mtbf0`` — correct
    for the homogeneous fleet, increasingly wrong as the mix skews the
    watch-pool mean hazard away from 1.0 — while the oracle knows the
    class-weighted truth, so the oracle gap isolates what estimation (and
    the class-blind estimator's job-vs-watch-pool bias) costs on real
    fleets.  All policies share seeds (common random numbers).
    """
    if scenarios is None:
        scenarios = [scenario("constant", mtbf=mtbf0),
                     scenario("diurnal", mtbf=mtbf0),
                     scenario("flash_crowd", mtbf=mtbf0)]
    if mixes is None:
        mixes = default_mixes()
    names = [m.name or f"mix#{i}" for i, m in enumerate(mixes)]
    seeds = list(seeds)
    S = len(seeds)
    grid = [(scen, m) for scen in scenarios for m in mixes]
    cells = []
    for scen, m in grid:
        policies = (
            PolicyConfig(kind="adaptive", prior_mu=1.0 / mtbf0, prior_v=PAPER_V),
            PolicyConfig(kind="fixed", fixed_T=fixed_T),
            PolicyConfig(kind="oracle"),
        )
        for pol in policies:
            for s in seeds:
                cells.append(CellSpec(
                    scenario=scen, policy=pol, seed=s, k=k, work=work,
                    V=PAPER_V, T_d=PAPER_TD, n_slots=n_slots,
                    max_wall_time=max_wall_factor * work / m.mean_speed(k),
                    mix=m))
    res = run_cells(cells, **run_kw)
    walls = res.wall_time.reshape(len(grid), 3, S)
    compl = res.completed.reshape(len(grid), 3, S)
    out = []
    for i, (scen, m) in enumerate(grid):
        a, fx, o = (float(w) for w in walls[i].mean(axis=1))
        out.append(HeterogeneityCell(
            scenario=scen.name, mix=names[i % len(mixes)],
            mean_speed=m.mean_speed(k),
            adaptive_wall=a, fixed_wall=fx, oracle_wall=o,
            relative_runtime=100.0 * fx / a, oracle_gap=a / o,
            completed_frac=float(compl[i, 0].mean())))
    return out


def hetero_csv(cells: Sequence[HeterogeneityCell]) -> List[str]:
    """CSV rows (header first) — one row per (scenario, mix) cell."""
    return [HETERO_CSV_HEADER] + [c.csv_row() for c in cells]


# --------------------------------------------------------------------------- #
# Correlated-churn experiment (shock robustness, DESIGN.md Sec 8).             #
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class ShockCell:
    """One (scenario x shock intensity) cell of the correlated-churn sweep."""

    scenario: str
    shocks_per_hour: float      # epoch rate (0 = the unshocked baseline)
    kill_frac: float
    scope: str
    adaptive_wall: float        # mean completion wall time (s)
    fixed_wall: float
    oracle_wall: float
    relative_runtime: float     # Eq. 11: 100 * fixed / adaptive (%)
    oracle_gap: float           # adaptive / oracle (>= ~1)
    mean_failures: float        # adaptive cells' mean failure count
    completed_frac: float       # adaptive cells that completed

    def csv_row(self) -> str:
        return (f"{self.scenario},{self.shocks_per_hour:.3f},"
                f"{self.kill_frac:.2f},{self.scope},"
                f"{self.adaptive_wall:.1f},{self.fixed_wall:.1f},"
                f"{self.oracle_wall:.1f},{self.relative_runtime:.2f},"
                f"{self.oracle_gap:.4f},{self.mean_failures:.2f},"
                f"{self.completed_frac:.3f}")


SHOCK_CSV_HEADER = ("scenario,shocks_per_hour,kill_frac,scope,"
                    "adaptive_wall_s,fixed_wall_s,oracle_wall_s,"
                    "rel_runtime_pct,oracle_gap,mean_failures,completed_frac")


def correlated_churn_sweep(
    scenarios: Optional[Sequence[Scenario]] = None,
    shock_rates_per_hour: Sequence[float] = (0.0, 0.5, 1.0, 2.0),
    kill_frac: float = 0.35,
    scope: str = "all",
    fixed_T: float = 900.0,
    *,
    mix: Optional[PeerClassMix] = None,
    k: int = DEFAULT_K,
    work: float = DEFAULT_WORK,
    seeds: Sequence[int] = tuple(range(8)),
    n_slots: int = DEFAULT_SLOTS,
    mtbf0: float = 7200.0,
    max_wall_factor: float = 50.0,
    **run_kw,
) -> List[ShockCell]:
    """Adaptive vs fixed vs oracle across correlated-shock intensities.

    The experiment the shock axis exists for (paper Sec 3's robustness
    argument): the same scenarios with Poisson shock epochs of growing
    rate, each killing ``kill_frac`` of the in-scope peers simultaneously.
    ``fixed_T`` is tuned for the UNSHOCKED baseline — the user who picked
    a sensible constant — so the sweep measures how the paper's Eq. 11
    advantage grows as correlated churn pulls the effective failure rate
    away from the rate that constant was tuned for, while the adaptive
    estimator re-converges to the shock-augmented hazard on its own.
    The oracle knows the shock process (engine ``mu_true`` carries
    ``rate*pkill/k``), so the oracle gap still isolates estimation cost.
    All policies and intensities share seeds (common random numbers).
    """
    if scenarios is None:
        scenarios = [scenario("constant", mtbf=mtbf0),
                     scenario("diurnal", mtbf=mtbf0),
                     scenario("flash_crowd", mtbf=mtbf0)]
    seeds = list(seeds)
    S = len(seeds)
    grid = [(scen, r) for scen in scenarios for r in shock_rates_per_hour]
    cells = []
    for scen, rate_h in grid:
        shocked = scen.with_shock(
            ShockSpec(rate=rate_h / 3600.0, kill_frac=kill_frac, scope=scope)
            if rate_h > 0.0 else None)
        policies = (
            PolicyConfig(kind="adaptive", prior_mu=1.0 / mtbf0, prior_v=PAPER_V),
            PolicyConfig(kind="fixed", fixed_T=fixed_T),
            PolicyConfig(kind="oracle"),
        )
        for pol in policies:
            for s in seeds:
                cells.append(CellSpec(
                    scenario=shocked, policy=pol, seed=s, k=k, work=work,
                    V=PAPER_V, T_d=PAPER_TD, n_slots=n_slots,
                    max_wall_time=max_wall_factor * work, mix=mix))
    res = run_cells(cells, **run_kw)
    walls = res.wall_time.reshape(len(grid), 3, S)
    fails = res.n_failures.reshape(len(grid), 3, S)
    compl = res.completed.reshape(len(grid), 3, S)
    out = []
    for i, (scen, rate_h) in enumerate(grid):
        a, fx, o = (float(w) for w in walls[i].mean(axis=1))
        out.append(ShockCell(
            scenario=scen.name, shocks_per_hour=float(rate_h),
            kill_frac=kill_frac if rate_h > 0.0 else 0.0,
            scope=scope if rate_h > 0.0 else "all",
            adaptive_wall=a, fixed_wall=fx, oracle_wall=o,
            relative_runtime=100.0 * fx / a, oracle_gap=a / o,
            mean_failures=float(fails[i, 0].mean()),
            completed_frac=float(compl[i, 0].mean())))
    return out


def shock_csv(cells: Sequence[ShockCell]) -> List[str]:
    """CSV rows (header first) — one row per (scenario, intensity) cell."""
    return [SHOCK_CSV_HEADER] + [c.csv_row() for c in cells]


def summarize(results: Dict[float, List[Comparison]]) -> str:
    lines = ["param      fixed_T    rel_runtime%  adaptive_h  fixed_h  oracle_gap"]
    for key, comps in sorted(results.items()):
        for c in comps:
            lines.append(
                f"{key:>9.0f}  {c.fixed_T:>8.0f}  {c.relative_runtime:>11.1f}"
                f"  {c.adaptive_wall / 3600:>9.2f}  {c.fixed_wall / 3600:>7.2f}"
                f"  {c.oracle_gap:>9.3f}")
    return "\n".join(lines)
