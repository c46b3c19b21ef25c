"""Failure injection, serialized schedules and straggler detection for the
real runtimes (the port of ``repro/runtime/failures.py``; host numpy).

Train steps and executor supersteps take milliseconds to seconds while
realistic node MTBFs are hours, so the injector runs on a *virtual clock*:
every step advances virtual time by ``seconds_per_step`` (the modeled
production step time).  Churn comes from
:class:`repro_torch.sim.network.ChurnNetwork`, the same process as the
paper-reproduction simulator: the runtime occupies slots [0, k) and a death
among them is a job failure, giving the paper's k*mu statistics (Eq. 7).
Correlated shocks (a ``ShockSpec``) ride along.

**Serialized schedules**: the whole churn realization of a stage -- every
death event plus the shock epochs that produced the bursts -- is
materialized up to a horizon into a :class:`StageSchedule`
(JSON-round-trippable, seed-pinned) and replayed bit-exactly by a
:class:`FailureInjector` in *replay* mode.  One schedule feeds both the
digital twin (:func:`repro_torch.sim.workflow.simulate_workflow`) and the
real executor (:mod:`repro_torch.exec`): the sim predicts the waste of a
churn realization, the executor measures it.  A schedule is the
interchange format with the JAX package: :meth:`WorkflowSchedule.to_json`
gives the reference's string for the same DAG and seed, and a schedule the
reference wrote loads and replays here.

A schedule may also pin the per-slot *class map* of a ``PeerClassMix`` and
the *replica-holder realization* of a ``StoreSpec`` (one
:class:`~repro_torch.p2p.overlay.HolderTrack` per holder slot, drawn on a
child stream of its own and shock-correlated through the same pinned
:class:`~repro_torch.sim.scenarios.ShockClock` as the job events): the
executor then runs supersteps at the recorded class speed and derives
every restore and hand-off fetch time from the holders alive at that
virtual instant.

Detection is immediate: the detected event carries the failed node's
observed lifetime, which the MLE estimator consumes.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.p2p.overlay import HolderTrack, ReplicaSetProcess, ScheduleExhausted
from repro_torch.p2p.store import StoreSpec
from repro_torch.p2p.transfer import TransferModel
from repro_torch.sim.network import ChurnNetwork, MtbfFn, constant_mtbf
from repro_torch.sim.scenarios import (
    PeerClass,
    PeerClassMix,
    Scenario,
    ShockClock,
    ShockSpec,
    resolve_shock,
)

# Seed-stream tag for serialized failure schedules ("exec"); distinct from
# the sim's hand-off ("hoff"), shock ("shck"), and engine observation
# streams so a schedule never aliases the draws of the twin that predicts it.
SCHEDULE_STREAM = 0x65786563

__all__ = ["FailureEvent", "FailureInjector", "SCHEDULE_STREAM",
           "ScheduleExhausted", "SimulatedFailure", "StageSchedule",
           "StragglerMonitor", "WorkflowSchedule", "build_stage_schedule"]


class SimulatedFailure(Exception):
    """Raised by the injector when a job node dies mid-step."""

    def __init__(self, lifetime: float, slot: int, at_virtual_time: float):
        super().__init__(f"node slot {slot} failed (lifetime {lifetime:.1f}s)")
        self.lifetime = lifetime
        self.slot = slot
        self.at_virtual_time = at_virtual_time


@dataclass(frozen=True)
class FailureEvent:
    """One death in a serialized schedule (stage-relative wall time)."""

    time: float
    slot: int
    lifetime: float


@dataclass(frozen=True)
class StageSchedule:
    """A pinned churn realization for one stage, replayable bit-exactly.

    ``events`` is the complete time-ordered death stream of the stage's
    peer population over [0, horizon] — job-slot deaths (slot < k), watch
    neighbours (slot < watch), and background slots alike, shock-epoch
    bursts included as simultaneous-timestamp runs.  ``shock_epochs``
    records the exact :class:`ShockClock` schedule that produced those
    bursts so the serialized form is self-describing.

    A *heterogeneous* schedule additionally records ``classes`` (the mix's
    canonical class table) and ``slot_class`` (class index per population
    slot, the mix's deterministic prefix-proportional assignment) — the
    executor derives job speed, hazard-weighted estimator exposure, and
    holder uplinks from these, never from a live mix object.

    An *endogenous-restore* schedule carries ``store`` (replication factor
    + transfer capacities) plus the pinned ``holders`` realization: one
    :class:`~repro_torch.p2p.overlay.HolderTrack` per holder slot, drawn on a dedicated
    stream and shock-correlated with the job events through the shared
    pinned clock.  ``holder_class`` maps holder slots onto ``classes`` for
    uplink striping.  With ``store=None`` the executor pays its exogenous
    ``T_d`` exactly as before.
    """

    k: int
    watch: int
    n_slots: int
    seed: int
    horizon: float
    events: Tuple[FailureEvent, ...]
    shock_epochs: Tuple[float, ...] = ()
    shock_rate: float = 0.0
    classes: Tuple[PeerClass, ...] = ()
    slot_class: Tuple[int, ...] = ()
    store: Optional[StoreSpec] = None
    holders: Tuple[HolderTrack, ...] = ()
    holder_class: Tuple[int, ...] = ()

    def __post_init__(self) -> None:
        if self.k <= 0 or not 0 < self.watch <= self.n_slots:
            raise ValueError("need k > 0 and 0 < watch <= n_slots")
        if self.horizon <= 0:
            raise ValueError("horizon must be positive")
        times = [e.time for e in self.events]
        if any(b < a for a, b in zip(times, times[1:])):
            raise ValueError("schedule events must be time-ordered")
        if self.classes:
            if len(self.slot_class) != self.n_slots:
                raise ValueError("need one class index per population slot")
            if self.slot_class and not (
                    0 <= min(self.slot_class)
                    and max(self.slot_class) < len(self.classes)):
                raise ValueError("slot_class index out of range")
        elif self.slot_class:
            raise ValueError("slot_class without a class table")
        if self.holders and self.store is None:
            raise ValueError("holder realizations need their store params")
        if self.store is not None and len(self.holders) != self.store.R:
            raise ValueError(
                f"need one holder track per replica slot: "
                f"{len(self.holders)} != R={self.store.R}")
        if self.holder_class:
            if not self.classes or len(self.holder_class) != len(self.holders):
                raise ValueError("holder_class needs classes and one index "
                                 "per holder slot")
            if not (0 <= min(self.holder_class)
                    and max(self.holder_class) < len(self.classes)):
                raise ValueError("holder_class index out of range")

    def job_failures(self) -> Tuple[FailureEvent, ...]:
        """The events that kill the job itself (slot < k)."""
        return tuple(e for e in self.events if e.slot < self.k)

    # ------------------------------------------------------------------ #
    # Class-map views (all exactly the homogeneous constants when the     #
    # schedule carries no class table — the bit-identity contract).       #
    # ------------------------------------------------------------------ #
    def hazard_mult(self, slot: int) -> float:
        """Hazard multiplier of one population slot (1.0 homogeneous)."""
        if not self.classes:
            return 1.0
        return self.classes[self.slot_class[slot]].hazard_mult

    def job_speed(self) -> float:
        """Aggregate compute speed of the k job slots — the mean class
        speed, matching :meth:`PeerClassMix.mean_speed` on the same
        prefix.  Exactly 1.0 for a homogeneous schedule."""
        if not self.classes:
            return 1.0
        return math.fsum(self.classes[self.slot_class[i]].speed
                         for i in range(self.k)) / self.k

    def job_hazard_sum(self) -> float:
        """Sum of hazard multipliers over the k job slots — the controller
        solves Eq. 11 with this as its hazard-weighted ``k`` (exactly
        ``float(k)`` homogeneous: fsum of ones)."""
        if not self.classes:
            return float(self.k)
        return math.fsum(self.classes[self.slot_class[i]].hazard_mult
                         for i in range(self.k))

    def watch_hazard_sum(self) -> float:
        """Hazard-weighted estimator exposure of the watch neighbourhood
        (exactly ``float(watch)`` homogeneous)."""
        if not self.classes:
            return float(self.watch)
        return math.fsum(self.classes[self.slot_class[i]].hazard_mult
                         for i in range(self.watch))

    def holder_uplinks(self) -> Tuple[float, ...]:
        """Uplink multiplier per holder slot (1.0s without a class map)."""
        if not self.holder_class:
            return (1.0,) * len(self.holders)
        return tuple(self.classes[j].uplink_mult for j in self.holder_class)

    def holder_view(self) -> ReplicaSetProcess:
        """A fresh replay view over the pinned holder realization.

        Stateful (its cursors advance monotonically): make one per stage
        incarnation and query it at non-decreasing virtual times."""
        if self.store is None:
            raise ValueError("schedule carries no holder realization")
        return ReplicaSetProcess.from_lifetimes(self.holders,
                                                horizon=self.horizon)

    # ------------------------------------------------------------------ #
    # JSON round trip.                                                   #
    # ------------------------------------------------------------------ #
    def to_dict(self) -> dict:
        d = {
            "k": self.k, "watch": self.watch, "n_slots": self.n_slots,
            "seed": self.seed, "horizon": self.horizon,
            "shock_rate": self.shock_rate,
            "shock_epochs": list(self.shock_epochs),
            "events": [[e.time, e.slot, e.lifetime] for e in self.events],
        }
        # Optional sections only when present, so homogeneous/exogenous
        # schedules serialize byte-identically to the form without them.
        if self.classes:
            d["classes"] = [[c.name, c.hazard_mult, c.speed, c.uplink_mult]
                            for c in self.classes]
            d["slot_class"] = list(self.slot_class)
        if self.store is not None:
            tr = self.store.transfer
            d["store"] = {
                "R": self.store.R, "t_repair": self.store.t_repair,
                "img_bytes": tr.img_bytes, "peer_uplink": tr.peer_uplink,
                "peer_downlink": tr.peer_downlink,
                "server_capacity": tr.server_capacity,
                "server_load": tr.server_load,
            }
            d["holders"] = [[int(h.init_up), list(h.toggles)]
                            for h in self.holders]
            if self.holder_class:
                d["holder_class"] = list(self.holder_class)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "StageSchedule":
        store = None
        if "store" in d:
            sd = d["store"]
            store = StoreSpec(
                R=int(sd["R"]), t_repair=float(sd["t_repair"]),
                transfer=TransferModel(
                    img_bytes=float(sd["img_bytes"]),
                    peer_uplink=float(sd["peer_uplink"]),
                    peer_downlink=float(sd["peer_downlink"]),
                    server_capacity=float(sd["server_capacity"]),
                    server_load=float(sd["server_load"])))
        return cls(
            k=int(d["k"]), watch=int(d["watch"]), n_slots=int(d["n_slots"]),
            seed=int(d["seed"]), horizon=float(d["horizon"]),
            shock_rate=float(d.get("shock_rate", 0.0)),
            shock_epochs=tuple(float(e) for e in d.get("shock_epochs", ())),
            events=tuple(FailureEvent(float(t), int(s), float(life))
                         for t, s, life in d["events"]),
            classes=tuple(PeerClass(name=str(nm), hazard_mult=float(h),
                                    speed=float(sp), uplink_mult=float(u))
                          for nm, h, sp, u in d.get("classes", ())),
            slot_class=tuple(int(i) for i in d.get("slot_class", ())),
            store=store,
            holders=tuple(HolderTrack(init_up=bool(up),
                                      toggles=tuple(float(t) for t in ts))
                          for up, ts in d.get("holders", ())),
            holder_class=tuple(int(i) for i in d.get("holder_class", ())),
        )


@dataclass(frozen=True)
class WorkflowSchedule:
    """Per-stage pinned schedules for a whole DAG (one seed, serializable)."""

    stages: Dict[str, StageSchedule]
    seed: int
    scenario: str = ""

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed, "scenario": self.scenario,
            "stages": {name: s.to_dict() for name, s in self.stages.items()},
        })

    @classmethod
    def from_json(cls, s: str) -> "WorkflowSchedule":
        d = json.loads(s)
        return cls(stages={name: StageSchedule.from_dict(sd)
                           for name, sd in d["stages"].items()},
                   seed=int(d["seed"]), scenario=d.get("scenario", ""))


def build_stage_schedule(
    scen: Scenario,
    *,
    k: int,
    seed: int,
    horizon: float,
    n_slots: int = 128,
    watch: Optional[int] = None,
    mix: Optional[PeerClassMix] = None,
    shock: Optional[ShockSpec] = None,
    stage_index: int = 0,
    store: Optional[StoreSpec] = None,
) -> StageSchedule:
    """Materialize one stage's churn realization up to ``horizon``.

    The event stream comes from a :class:`ChurnNetwork` seeded on the
    dedicated ``SCHEDULE_STREAM`` child of ``(seed, stage_index)``; when a
    shock applies, its epochs are drawn first, recorded, and fed back
    through :meth:`ShockClock.pinned` so the serialized epochs are exactly
    the ones the event stream consumed.

    With a ``mix`` the schedule records the class table and per-slot
    assignment alongside the events; with a ``store`` it additionally pins
    the replica-holder realization — an alternating-renewal
    :class:`~repro_torch.p2p.ReplicaSetProcess` drawn on its own child stream
    (``entropy + [2]``, so attaching a store never perturbs the event or
    epoch draws) and driven by the SAME pinned clock as the job network,
    which is what correlates replica wipeouts with the job failures that
    trigger restores.
    """
    if horizon <= 0:
        raise ValueError("horizon must be positive")
    watch = min(4 * k, n_slots) if watch is None else min(watch, n_slots)
    if shock is None:
        shock = resolve_shock(scen, mix)
    entropy = [int(seed), SCHEDULE_STREAM, int(stage_index)]
    epochs: Tuple[float, ...] = ()
    rate = 0.0
    clock = None
    if shock is not None:
        rate = shock.rate
        gen = ShockClock(shock.rate, np.random.default_rng(
            np.random.SeedSequence(entropy + [1])))
        epochs = tuple(gen.epochs_until(horizon))
        clock = ShockClock.pinned(shock.rate, epochs)
    rng = np.random.default_rng(np.random.SeedSequence(entropy))
    net = ChurnNetwork.from_scenario(scen, n_slots, rng, mix=mix,
                                     shock=shock, shock_clock=clock)
    events = tuple(FailureEvent(float(ev.time), int(ev.slot), float(ev.lifetime))
                   for ev in net.deaths_until(horizon))
    classes: Tuple[PeerClass, ...] = ()
    slot_class: Tuple[int, ...] = ()
    if mix is not None:
        classes = mix.classes
        slot_class = mix.assign(n_slots)
    holders: Tuple[HolderTrack, ...] = ()
    holder_class: Tuple[int, ...] = ()
    if store is not None and store.R > 0:
        h_rng = np.random.default_rng(np.random.SeedSequence(entropy + [2]))
        # Same holder heterogeneity/scoping rules as the heap oracle's
        # P2PCheckpointStore: hazard mults only for a non-trivial mix,
        # shock scope restricted to the shock's class subset.
        mults = (mix.hazard_mults(store.R)
                 if mix is not None and not mix.is_trivial else None)
        mask = shock.scope_mask(mix, store.R) if shock is not None else None
        proc = ReplicaSetProcess(store.R, scen.mtbf_fn, store.t_repair, h_rng,
                                 slot_mults=mults, shock=shock,
                                 shock_clock=clock, scope_mask=mask)
        holders = proc.lifetimes_until(horizon)
        if mix is not None:
            holder_class = mix.assign(store.R)
    return StageSchedule(k=k, watch=watch, n_slots=n_slots, seed=int(seed),
                         horizon=float(horizon), events=events,
                         shock_epochs=epochs, shock_rate=rate,
                         classes=classes, slot_class=slot_class,
                         store=store, holders=holders,
                         holder_class=holder_class)


@dataclass
class FailureInjector:
    """Virtual-clock churn injector: live ChurnNetwork or schedule replay.

    Three construction modes:

    * legacy live — ``mtbf_fn`` (+ optional ``shock``/``shock_clock``):
      exponential churn from a private network, as the trainer uses it.
    * scenario live — ``scenario=`` (+ ``mix``/``shock``): the full
      registry semantics (Weibull lifetimes, class hazards, shared shock
      clocks), matching :meth:`ChurnNetwork.from_scenario`.
    * replay — ``schedule=`` (or :meth:`from_schedule`): no RNG at all;
      the pinned event stream of a :class:`StageSchedule` is replayed
      bit-exactly, raising :class:`ScheduleExhausted` past its horizon.
    """

    k: int
    mtbf_fn: MtbfFn = field(default_factory=lambda: constant_mtbf(4 * 3600.0))
    seconds_per_step: float = 10.0
    n_slots: Optional[int] = None
    seed: int = 0
    scenario: Optional[Scenario] = None
    mix: Optional[PeerClassMix] = None
    shock: Optional[ShockSpec] = None
    shock_clock: Optional[ShockClock] = None
    schedule: Optional[StageSchedule] = None
    virtual_time: float = field(default=0.0, init=False)
    observed_lifetimes: List[float] = field(default_factory=list, init=False)

    def __post_init__(self):
        if self.schedule is not None:
            if self.k != self.schedule.k:
                raise ValueError(
                    f"injector k={self.k} != schedule k={self.schedule.k}")
            self._net = None
            self._cursor = 0
            self._watch = self.schedule.watch
            # Heterogeneous replay: emit observations in baseline-hazard-
            # equivalent seconds (lifetime * class hazard mult), so a
            # class-blind MLE over them estimates the BASE mu; paired with
            # the schedule's hazard-weighted k/exposure aggregates this
            # reproduces the engine's cadence law.  All mults are 1.0 for
            # a class-free schedule — observations bit-identical.
            self._obs_mult = (
                tuple(self.schedule.hazard_mult(s)
                      for s in range(self.schedule.n_slots))
                if self.schedule.classes else None)
            return
        self._obs_mult = None
        slots = self.n_slots or max(4 * self.k, 16)
        rng = np.random.default_rng(self.seed)
        if self.scenario is not None:
            self._net = ChurnNetwork.from_scenario(
                self.scenario, slots, rng, mix=self.mix, shock=self.shock,
                shock_clock=self.shock_clock)
        else:
            self._net = ChurnNetwork(slots, self.mtbf_fn, rng,
                                     shock=self.shock,
                                     shock_clock=self.shock_clock)
        self._watch = min(4 * self.k, slots)

    @classmethod
    def from_schedule(cls, schedule: StageSchedule,
                      seconds_per_step: float = 10.0) -> "FailureInjector":
        """A replay injector for a pinned schedule."""
        return cls(k=schedule.k, seconds_per_step=seconds_per_step,
                   n_slots=schedule.n_slots, seed=schedule.seed,
                   schedule=schedule)

    # ------------------------------------------------------------------ #
    def _deaths_until(self, t_end: float) -> Iterator:
        if self._net is not None:
            yield from self._net.deaths_until(t_end)
            return
        if t_end > self.schedule.horizon:
            raise ScheduleExhausted(
                f"replay advanced to t={t_end:.1f}s past the schedule "
                f"horizon {self.schedule.horizon:.1f}s")
        events = self.schedule.events
        while self._cursor < len(events) and events[self._cursor].time <= t_end:
            ev = events[self._cursor]
            self._cursor += 1
            yield ev

    def _advance(self, seconds: float, exposed: bool) -> None:
        t_end = self.virtual_time + seconds
        for ev in self._deaths_until(t_end):
            if ev.slot < self._watch:
                life = ev.lifetime
                if self._obs_mult is not None:
                    life *= self._obs_mult[ev.slot]
                self.observed_lifetimes.append(life)
            if exposed and ev.slot < self.k:
                self.virtual_time = ev.time
                raise SimulatedFailure(ev.lifetime, ev.slot, ev.time)
        self.virtual_time = t_end

    def advance_step(self, real_step_seconds: Optional[float] = None) -> None:
        """Advance one training step of virtual time.

        Non-job (neighbour) deaths are recorded as observations; a death in
        a job slot raises :class:`SimulatedFailure` at its virtual time.
        """
        self._advance(self.seconds_per_step, exposed=True)

    def advance_exposed(self, seconds: float) -> None:
        """Advance arbitrary churn-exposed virtual time (hand-off fetches,
        checkpoint stalls): a job-slot death interrupts it exactly like a
        step, raising :class:`SimulatedFailure`."""
        self._advance(seconds, exposed=True)

    def advance_seconds(self, seconds: float) -> None:
        """Advance arbitrary *unexposed* virtual time (restore downtime in
        the trainer's own retry loop): deaths are observed, never raised."""
        self._advance(seconds, exposed=False)

    def drain_observations(self) -> List[float]:
        out, self.observed_lifetimes = self.observed_lifetimes, []
        return out


@dataclass
class StragglerMonitor:
    """Deadline-based straggler detection.

    Hosts whose step times repeatedly exceed ``deadline_factor`` x the EMA
    across the fleet are flagged; the runtime treats a flagged host as a
    churn event (exclusion IS a departure from the job's point of view, so
    its 'lifetime' feeds the failure-rate estimator).
    """

    deadline_factor: float = 3.0
    patience: int = 3
    alpha: float = 0.1
    _ema: float = field(default=0.0, init=False)
    _w: float = field(default=0.0, init=False)
    _strikes: dict = field(default_factory=dict, init=False)
    flagged: set = field(default_factory=set, init=False)

    @property
    def ema(self) -> float:
        return self._ema / self._w if self._w else 0.0

    def observe(self, host: int, step_seconds: float) -> bool:
        """Record a host's step time; True if the host just got flagged."""
        if self._w == 0.0:
            self._ema, self._w = step_seconds * self.alpha, self.alpha
        if step_seconds > self.deadline_factor * self.ema and self.ema > 0:
            self._strikes[host] = self._strikes.get(host, 0) + 1
        else:
            self._strikes[host] = 0
            self._ema = (1 - self.alpha) * self._ema + self.alpha * step_seconds
            self._w = (1 - self.alpha) * self._w + self.alpha
        if self._strikes.get(host, 0) >= self.patience and host not in self.flagged:
            self.flagged.add(host)
            return True
        return False
