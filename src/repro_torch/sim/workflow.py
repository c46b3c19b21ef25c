"""Work flows of inter-dependent jobs on the churn network (the paper's
target; the port of ``repro/sim/workflow.py``).

The paper's deployment model is not a single monolithic job but a *work
flow*: a DAG of stages where each stage is itself a k-peer checkpointed job
and edges carry checkpoint-image / intermediate-result hand-offs.

Semantics (as the reference):

* A stage becomes *ready* when every dependency has finished; before
  computing it must fetch each dependency's output, paying that edge's
  hand-off cost.  A churn event among the stage's k peers during a fetch
  loses the partial transfer and forces a retry; retry time is accounted
  as the stage's hand-off *waste*.  With a ``StoreSpec`` the edge outputs
  live in the P2P checkpoint store: each fetch reads from the dependency's
  surviving replica set (peer-uplink striping, server fallback when every
  replica is lost), and the stage's own restores become endogenous too.
* The stage then runs as one engine cell per seed, offset to its absolute
  start time so time-varying scenarios stay aligned across the workflow.
  All seeds of a stage are one :func:`repro_torch.sim.engine.run_cells`
  batch: on the card, launches of the sim-step kernel
  (:mod:`repro_torch.kernels.sim_step`); per-peer estimator batches run
  the plain torch step (:func:`repro_torch.sim.engine.batch_step`).
* A stage's committed output survives peer churn, so an upstream death
  never un-finishes a finished stage.  A *censored* (livelocked) stage
  never produces output: every transitive dependent is marked unfinished
  and the workflow is reported incomplete.

The hand-off fetches are host numpy on per-seed streams
(``SeedSequence([seed, _HANDOFF_STREAM])``), the same streams the
reference draws, so with ``draws="numpy"`` a workflow replays the
reference's ``backend="numpy"`` run seed for seed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.p2p.store import StoreSpec
from repro_torch.sim.engine import (
    BatchResult,
    CellSpec,
    PolicyConfig,
    batch_step,
    run_cells,
)
from repro_torch.sim.scenarios import (
    PeerClassMix,
    Scenario,
    ShockSpec,
    resolve_shock,
)

# Tag of the per-seed child stream feeding hand-off fetch randomness;
# distinct from the engine's observation stream so the two never alias.
_HANDOFF_STREAM = 0x686F6666

if TYPE_CHECKING:  # pragma: no cover - annotation only (avoids import cycle)
    from repro_torch.runtime.failures import WorkflowSchedule


@dataclass(frozen=True)
class Stage:
    """One checkpointed job inside the workflow DAG.

    ``mix`` declares the stage's peer-class composition (heterogeneous
    fleets, DESIGN.md Sec 7) — e.g. an evaluate stage pinned to
    ``server_class`` machines while the train stage rides the volunteer
    tail.  ``None`` inherits the workflow-level mix.

    ``shock`` subjects THIS stage (its cycles, restores, and hand-off
    fetches) to a correlated-churn shock process (DESIGN.md Sec 8) —
    modelling e.g. a partition that hits the volunteer-tail train stage
    while the pinned evaluate stage rides it out.  ``None`` inherits
    whatever the workflow's scenario/mix declares.
    """

    name: str
    work: float                      # fault-free compute seconds
    k: int = 16                      # peers running this stage
    deps: Tuple[str, ...] = ()       # names of stages whose output we consume
    handoff: float = 0.0             # seconds to fetch EACH dependency's output
    V: Optional[float] = None        # per-stage checkpoint overhead override
    T_d: Optional[float] = None     # per-stage restore overhead override
    mix: Optional[PeerClassMix] = None  # per-stage fleet composition override
    shock: Optional[ShockSpec] = None  # per-stage correlated-churn override


@dataclass(frozen=True)
class WorkflowSpec:
    """A validated DAG of stages."""

    stages: Tuple[Stage, ...]

    def __post_init__(self) -> None:
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            raise ValueError("stage names must be unique")
        known = set(names)
        for s in self.stages:
            missing = set(s.deps) - known
            if missing:
                raise ValueError(f"stage {s.name!r} depends on unknown {sorted(missing)}")
            if s.work <= 0 or s.k <= 0 or s.handoff < 0:
                raise ValueError(f"stage {s.name!r}: need work>0, k>0, handoff>=0")
        self.topo_order()  # raises on cycles

    def __len__(self) -> int:
        return len(self.stages)

    def topo_order(self) -> Tuple[Stage, ...]:
        """Kahn topological sort; raises ValueError on cycles."""
        by_name = {s.name: s for s in self.stages}
        indeg = {s.name: len(s.deps) for s in self.stages}
        dependents: Dict[str, List[str]] = {s.name: [] for s in self.stages}
        for s in self.stages:
            for d in s.deps:
                dependents[d].append(s.name)
        ready = [n for n, d in indeg.items() if d == 0]
        order: List[Stage] = []
        while ready:
            n = ready.pop()
            order.append(by_name[n])
            for m in dependents[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        if len(order) != len(self.stages):
            cyclic = sorted(n for n, d in indeg.items() if d > 0)
            raise ValueError(f"workflow DAG has a cycle through {cyclic}")
        return tuple(order)


@dataclass(frozen=True)
class StageResult:
    """Per-seed timings of one stage (arrays of shape [n_seeds])."""

    stage: Stage
    ready: np.ndarray      # all deps finished
    start: np.ndarray      # ready + hand-off transfers (incl. churn retries)
    finish: np.ndarray     # start + simulated stage wall time
    handoff_time: np.ndarray
    handoff_waste: np.ndarray  # fetch time lost to churn-interrupted retries
    sim: BatchResult
    completed: np.ndarray  # stage AND all its deps completed
    server_bytes: np.ndarray   # server I/O: stage restores + edge fallbacks

    @property
    def mean_wall(self) -> float:
        return float(np.mean(self.finish - self.start))


@dataclass(frozen=True)
class WorkflowResult:
    stages: Dict[str, StageResult]
    makespan: np.ndarray       # per-seed absolute finish of the last stage
    completed: np.ndarray      # per-seed: every stage completed
    critical_path: Tuple[str, ...]  # chain maximizing mean finish times

    @property
    def mean_makespan(self) -> float:
        return float(np.mean(self.makespan))

    @property
    def all_completed(self) -> bool:
        return bool(self.completed.all())

    @property
    def server_bytes(self) -> np.ndarray:
        """Per-seed aggregate server I/O across every stage."""
        return np.sum(np.stack([sr.server_bytes
                                for sr in self.stages.values()]), axis=0)


def _striped_seconds(m: int, store: StoreSpec) -> float:
    """``repro.p2p.transfer.striped_restore_seconds`` at one surviving
    count ``m`` (host floats): peer-uplink striping ``max(td_up1/m,
    td_cap)`` for m >= 1, the server fallback for m = 0."""
    if m >= 1:
        return float(max(store.td_up1 / float(m), store.td_cap))
    return float(store.td_server)


def _handoff_times(
    rngs: Sequence[np.random.Generator], scen: Scenario, k: int,
    t_start: np.ndarray, n_deps: int, handoff: float, max_time: float,
    store: Optional[StoreSpec] = None,
    mix: Optional[PeerClassMix] = None,
    shock: Optional[ShockSpec] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Churn-exposed edge fetches: pull each of the ``n_deps`` dependency
    outputs in turn, starting at per-seed times ``t_start``.

    ``rngs`` carries ONE generator per seed and each seed's fetches draw
    only from its own stream — a seed's hand-off realization never depends
    on which other seeds share the batch (the same common-random-number
    invariant the engine documents), which a single pooled generator
    violated (retry counts of one seed used to shift every later seed's
    draws).

    Without a store each edge costs ``handoff`` flat seconds; with a
    :class:`StoreSpec` each edge reads the dependency's replica set — the
    fetch duration comes from the surviving-replica count sampled under
    the availability law at the attempt's start (server fallback when all
    replicas are lost).  A churn event among the k consuming peers loses
    the partial transfer and forces a retry of that edge (same model as
    engine restores); retry time is accounted as waste.

    With a ``mix`` (heterogeneous fleet, DESIGN.md Sec 7) the k consuming
    peers fail at the class-weighted rate ``hazard_sum(k) * mu``, and a
    store fetch samples the surviving holders *per class* — exact
    Poisson-binomial, striped over the survivors' class uplinks (the
    engine's mean-field law has the same mean).

    With a ``shock`` (DESIGN.md Sec 8) the fetching peers are additionally
    killed by correlated epochs — the fetch-failure race runs at
    ``hazard_sum(k)*mu + rate*pkill`` — and a store fetch samples the
    dependency's survivors from the shock-mixture law: with probability
    ``q`` (the fetch failure was a shock) each in-scope holder was also
    killed by that epoch, so the draw uses the post-shock availability.
    A shock that empties the surviving set is the normal case at high
    ``kill_frac`` and must flow through the same server-fallback /
    waste / censoring accounting, never an error.

    Returns (elapsed, completed, waste, server_bytes).  Server fallbacks
    are billed per ATTEMPT: a churn-interrupted server fetch still moved
    elapsed/total of the image through the shared pipe.  A fetch whose
    retries exceed ``max_time`` is censored — the stage's churn can
    livelock a hand-off exactly like it livelocks a job, and must be
    reported, not spun on.
    """
    n = len(rngs)
    elapsed = np.zeros(n)
    waste = np.zeros(n)
    srv_bytes = np.zeros(n)
    ok_flags = np.ones(n, dtype=bool)
    if n_deps == 0 or (store is None and handoff <= 0.0):
        return elapsed, ok_flags, waste, srv_bytes
    img = store.transfer.img_bytes if store is not None else 0.0
    # Shock aggregates; all zero (and no extra RNG draws) when unshocked.
    # Computed against the ORIGINAL mix: a class scope must validate and
    # count against the declared classes even when a trivial mix then
    # collapses onto the exact homogeneous path below.
    srate = 0.0
    f_all = 0.0
    if shock is not None:
        n_scope = shock.scope_count(mix, k)  # validates class scopes
        srate = shock.rate * shock.job_kill_prob(n_scope)
        if shock.scope == "all" or (
                mix is not None and len(mix) == 1
                and shock.scope == mix.classes[0].name):
            f_all = shock.kill_frac  # scope covers the whole holder fleet
    # A trivial mix collapses onto the exact homogeneous path ONLY when
    # the shock (if any) covers the whole fleet: a class scope on a
    # trivial multi-class mix (partition groups of identical machines)
    # still needs the per-class holders path to kill just its group.
    if mix is not None and mix.is_trivial and (
            shock is None or shock.scope == "all" or len(mix) == 1):
        mix = None  # exact homogeneous path (identical RNG call sequence)
    khaz = mix.hazard_sum(k) if mix is not None else float(k)
    holders = None
    if mix is not None and store is not None and store.R > 0:
        # Per-class holder counts under the mix's deterministic assignment.
        counts: dict = {}
        for ci in mix.assign(store.R):
            counts[ci] = counts.get(ci, 0) + 1
        holders = [(cnt, mix.classes[ci].hazard_mult,
                    mix.classes[ci].uplink_mult,
                    shock.kill_frac if shock is not None
                    and shock.scope in ("all", mix.classes[ci].name) else 0.0)
                   for ci, cnt in sorted(counts.items())]
    for i, rng in enumerate(rngs):
        t = t0 = float(t_start[i])
        for _dep in range(n_deps):
            while ok_flags[i]:
                mu = 1.0 / scen.mtbf(t)
                # Did a shock trigger the failure that led to THIS attempt?
                # (First attempts start from a completed upstream stage, but
                # drawing per attempt keeps the law identical to the
                # engine's restore mixture; no draw when unshocked.)
                post = srate > 0.0 and \
                    rng.random() < srate / (khaz * mu + srate)
                if store is None:
                    total = handoff
                    from_server = False
                elif holders is not None:
                    ups: list = []
                    for cnt, h_c, u_c, f_c in holders:
                        # Holder hazard + thinned shock-kill rate (exactly
                        # +0.0 when unshocked — identical availability).
                        hold = shock.rate * f_c if shock is not None else 0.0
                        A_c = 1.0 / (1.0 + (mu * h_c + hold) * store.t_repair)
                        if post:
                            A_c *= (1.0 - f_c)
                        ups += [u_c] * int(rng.binomial(cnt, A_c))
                    total = store.transfer.restore_seconds_from(ups)
                    from_server = not ups
                else:
                    hold = shock.rate * f_all if shock is not None else 0.0
                    A = 1.0 / (1.0 + (mu + hold) * store.t_repair)
                    if post:
                        A *= (1.0 - f_all)
                    A = min(max(A, 0.0), 1.0)
                    m = int(rng.binomial(store.R, A)) if store.R > 0 else 0
                    total = _striped_seconds(m, store)
                    from_server = m == 0
                t_fail = -math.log1p(-rng.uniform()) / (khaz * mu + srate)
                if t_fail >= total:
                    t += total
                    if from_server:
                        srv_bytes[i] += img
                    break
                t += t_fail
                waste[i] += t_fail
                if from_server and total > 0.0:
                    srv_bytes[i] += img * min(t_fail / total, 1.0)
                if t - t0 > max_time:
                    ok_flags[i] = False  # censored: stop fetching this seed
        elapsed[i] = t - t0
    return elapsed, ok_flags, waste, srv_bytes


def simulate_workflow(
    spec: WorkflowSpec,
    scen: Scenario,
    *,
    policy: PolicyConfig = PolicyConfig(kind="adaptive"),
    seeds: Sequence[int] = (0, 1, 2, 3),
    V: float = 20.0,
    T_d: float = 50.0,
    n_slots: int = 128,
    max_wall_factor: float = 50.0,
    device=None,
    draws: str = "philox",
    store: Optional[StoreSpec] = None,
    mix: Optional[PeerClassMix] = None,
) -> WorkflowResult:
    """Run the whole DAG under churn, batched across seeds per stage.

    ``device``: ``None`` runs the stages on CUDA (and raises without a
    card); ``"cpu"`` runs the plain torch step on the CPU.  ``draws``:
    ``"philox"`` (the device stream, drawn inside the kernel on the card)
    or ``"numpy"`` (replays the reference numpy backend's streams, cell
    for cell); see :func:`repro_torch.sim.engine.run_cells`.

    ``store`` switches the workflow onto the P2P checkpoint store: every
    stage's restores become endogenous (replica-availability law instead
    of the flat ``T_d``) and hand-off edges fetch the dependency's image
    from its replica set instead of paying ``Stage.handoff`` flat seconds.

    ``mix`` sets the workflow-wide peer-class composition; a stage's own
    :attr:`Stage.mix` overrides it, so a DAG can model a "fast core +
    volunteer tail" deployment — e.g. preprocess/evaluate on
    ``server_class`` machines, train on the volunteer mix.  Stage failure
    rates, compute speeds, estimator streams, endogenous restores, and
    hand-off fetches all become class-aware (DESIGN.md Sec 7).

    Correlated shocks (DESIGN.md Sec 8) ride the same resolution: a shock
    declared on the scenario or mix hits every stage, and a stage's own
    :attr:`Stage.shock` overrides it for that stage alone — its cycles,
    restores, AND its hand-off fetches (a shock emptying a dependency's
    surviving replica set routes the fetch to the server fallback and the
    retry time to ``handoff_waste``, never an error).

    Seed isolation: every seed gets its own hand-off random stream (a
    child of that seed alone), and engine cells already derive per-cell
    streams from their own seeds — so a seed's whole workflow realization
    is invariant to batch composition (``seeds=(0,)`` reproduces exactly
    inside ``seeds=(0, 1)``), preserving common-random-number comparisons
    across policies and stores.
    """
    seeds = list(seeds)
    n = len(seeds)
    order = spec.topo_order()
    rngs = [np.random.default_rng(np.random.SeedSequence(
        [int(s), _HANDOFF_STREAM])) for s in seeds]
    finish: Dict[str, np.ndarray] = {}
    completed: Dict[str, np.ndarray] = {}
    results: Dict[str, StageResult] = {}

    for idx, stage in enumerate(order):
        ready = np.zeros(n)
        deps_ok = np.ones(n, dtype=bool)
        for d in stage.deps:
            ready = np.maximum(ready, finish[d])
            deps_ok &= completed[d]
        stage_mix = stage.mix if stage.mix is not None else mix
        # The stage's effective shock: its own override, else whatever the
        # scenario/mix declares (the same resolution CellSpec applies).
        stage_shock = (stage.shock if stage.shock is not None
                       else resolve_shock(scen, stage_mix))
        # Fault-free stage runtime in wall seconds (speed == 1.0 exactly
        # for homogeneous stages) — scales both censor horizons.
        speed = (stage_mix.mean_speed(stage.k)
                 if stage_mix is not None else 1.0)
        stage_wall = stage.work / speed
        edge_cost = (stage.handoff if store is None
                     else store.td_server)  # censor horizon scale per edge
        total_handoff = edge_cost * len(stage.deps)
        handoff, handoff_ok, handoff_waste, edge_srv_bytes = _handoff_times(
            rngs, scen, stage.k, ready, len(stage.deps), stage.handoff,
            max_time=max_wall_factor * max(total_handoff, stage_wall),
            store=store, mix=stage_mix, shock=stage_shock)
        deps_ok &= handoff_ok
        start = ready + handoff
        v = stage.V if stage.V is not None else V
        td = stage.T_d if stage.T_d is not None else T_d
        cells = [
            CellSpec(scenario=scen, policy=policy, seed=1000 * idx + s,
                     k=stage.k, work=stage.work, V=v, T_d=td, n_slots=n_slots,
                     max_wall_time=max_wall_factor * stage_wall,
                     t0=float(start[i]), store=store, mix=stage_mix,
                     shock=stage.shock)
            for i, s in enumerate(seeds)
        ]
        sim = run_cells(cells, device=device, draws=draws,
                        step=batch_step(cells))
        fin = start + sim.wall_time
        ok = deps_ok & sim.completed
        finish[stage.name] = fin
        completed[stage.name] = ok
        results[stage.name] = StageResult(stage=stage, ready=ready, start=start,
                                          finish=fin, handoff_time=handoff,
                                          handoff_waste=handoff_waste,
                                          sim=sim, completed=ok,
                                          server_bytes=(sim.server_bytes
                                                        + edge_srv_bytes))

    makespan = np.max(np.stack([finish[s.name] for s in spec.stages]), axis=0)
    all_ok = np.all(np.stack([completed[s.name] for s in spec.stages]), axis=0)

    # Critical path: walk back from the stage with the largest mean finish
    # through the dependency that gated each start.
    by_name = {s.name: s for s in spec.stages}
    cur = max(results, key=lambda nme: float(np.mean(results[nme].finish)))
    path = [cur]
    while by_name[cur].deps:
        cur = max(by_name[cur].deps, key=lambda d: float(np.mean(results[d].finish)))
        path.append(cur)
    return WorkflowResult(stages=results, makespan=makespan, completed=all_ok,
                          critical_path=tuple(reversed(path)))


# --------------------------------------------------------------------------- #
# Digital-twin bridge (DESIGN.md Sec 10): pinned schedules + predicted waste.  #
# --------------------------------------------------------------------------- #

def export_failure_schedule(
    spec: WorkflowSpec,
    scen: Scenario,
    *,
    seed: int = 0,
    n_slots: int = 128,
    horizon_factor: float = 120.0,
    mix: Optional[PeerClassMix] = None,
    store: Optional[StoreSpec] = None,
) -> "WorkflowSchedule":
    """Materialize one seed's churn realization for every stage of the DAG.

    The serialized, seed-pinned schedule (death events + exact ShockClock
    epochs, stage-relative times) is what the real executor
    (:mod:`repro_torch.exec`) replays while this module's sim predicts the same
    workflow's waste — the digital-twin contract.  Each stage draws from
    its own ``(seed, SCHEDULE_STREAM, stage_index)`` child stream, so the
    realization of one stage never depends on the DAG shape upstream.

    Pass the same ``mix``/``store`` given to :func:`simulate_workflow` and
    the schedules additionally pin each stage's class map and replica-
    holder realization — the executor then runs supersteps at class speed
    and derives restore/fetch latency endogenously from the pinned holders
    (DESIGN.md Sec 10), the same laws the sim's cells apply in closed form.

    ``horizon_factor`` scales each stage's horizon off its fault-free wall
    time + hand-off budget (the store's server-path fetch time bounds an
    endogenous edge); the default comfortably covers the executor's
    ``max_wall_factor=50`` censor horizons (hand-off + compute), so a
    well-formed run exhausts its censor budget before its schedule.
    """
    from repro_torch.runtime.failures import WorkflowSchedule, build_stage_schedule

    stages = {}
    for idx, stage in enumerate(spec.topo_order()):
        stage_mix = stage.mix if stage.mix is not None else mix
        stage_shock = (stage.shock if stage.shock is not None
                       else resolve_shock(scen, stage_mix))
        speed = (stage_mix.mean_speed(stage.k)
                 if stage_mix is not None else 1.0)
        stage_wall = stage.work / speed
        edge_cost = stage.handoff if store is None else store.td_server
        total_handoff = edge_cost * len(stage.deps)
        horizon = horizon_factor * (stage_wall
                                    + max(total_handoff, stage_wall) + 1.0)
        stages[stage.name] = build_stage_schedule(
            scen, k=stage.k, seed=seed, horizon=horizon, n_slots=n_slots,
            mix=stage_mix, shock=stage_shock, stage_index=idx, store=store)
    return WorkflowSchedule(stages=stages, seed=int(seed), scenario=scen.name)


def predicted_waste(result: WorkflowResult) -> np.ndarray:
    """Per-seed total waste the sim predicts for its real-executor twin:
    recompute lost to rolled-back cycles plus churn-interrupted hand-off
    retries, summed over every stage (shape [n_seeds])."""
    total: Optional[np.ndarray] = None
    for sr in result.stages.values():
        w = np.asarray(sr.sim.wasted_work, dtype=float) \
            + np.asarray(sr.handoff_waste, dtype=float)
        total = w if total is None else total + w
    if total is None:
        raise ValueError("workflow result has no stages")
    return total


def waste_band(result: WorkflowResult,
               n_sigma: float = 3.0) -> Tuple[float, float, float]:
    """(lo, mean, hi): the sim's ``n_sigma`` predicted-waste band.

    The band is over the per-seed realization distribution (sample sd, not
    the standard error), floored at 0 — an executor measurement landing
    inside it is consistent with the twin's prediction.
    """
    w = predicted_waste(result)
    mean = float(np.mean(w))
    sd = float(np.std(w, ddof=1)) if w.size > 1 else 0.0
    return max(mean - n_sigma * sd, 0.0), mean, mean + n_sigma * sd
