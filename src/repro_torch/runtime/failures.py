"""Failure injection and straggler detection for the real training loop (a
numpy copy of the live modes of ``repro/runtime/failures.py``).

Train steps take milliseconds to seconds while realistic node MTBFs are
hours, so the injector runs on a *virtual clock*: every step advances
virtual time by ``seconds_per_step`` (the modeled production step time).
Churn comes from :class:`repro_torch.sim.network.ChurnNetwork`, the same
process as the paper-reproduction simulator: the runtime occupies slots
[0, k) and a death among them is a job failure, giving the paper's k*mu
statistics (Eq. 7).  Correlated shocks (a ``ShockSpec``) ride along.

Two live modes, as the reference: legacy (``mtbf_fn`` + optional shock)
and scenario (``scenario=`` + ``mix``/``shock``).  The replay mode
(``schedule=``, ``StageSchedule``, ``WorkflowSchedule``,
``build_stage_schedule``) belongs to the digital twin, ROADMAP Queue 1
item 7, and raises ``NotImplementedError``.

Detection is immediate: the detected event carries the failed node's
observed lifetime, which the MLE estimator consumes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np

from repro_torch.sim.network import ChurnNetwork, MtbfFn, constant_mtbf
from repro_torch.sim.scenarios import PeerClassMix, Scenario, ShockClock, ShockSpec

_REPLAY = ("the replay mode of FailureInjector (schedule=, StageSchedule, "
           "WorkflowSchedule, build_stage_schedule) belongs to the digital "
           "twin and is not ported yet (ROADMAP Queue 1 item 7)")


class SimulatedFailure(Exception):
    """Raised by the injector when a job node dies mid-step."""

    def __init__(self, lifetime: float, slot: int, at_virtual_time: float):
        super().__init__(f"node slot {slot} failed (lifetime {lifetime:.1f}s)")
        self.lifetime = lifetime
        self.slot = slot
        self.at_virtual_time = at_virtual_time


@dataclass
class FailureInjector:
    """Virtual-clock churn injector over a live ChurnNetwork.

    * legacy live -- ``mtbf_fn`` (+ optional ``shock``/``shock_clock``):
      exponential churn from a private network, as the trainer uses it.
    * scenario live -- ``scenario=`` (+ ``mix``/``shock``): the full
      registry semantics (Weibull lifetimes, class hazards, shared shock
      clocks), matching :meth:`ChurnNetwork.from_scenario`.
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
    schedule: Optional[Any] = None
    virtual_time: float = field(default=0.0, init=False)
    observed_lifetimes: List[float] = field(default_factory=list, init=False)

    def __post_init__(self):
        if self.schedule is not None:
            raise NotImplementedError(_REPLAY)
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
    def from_schedule(cls, schedule, seconds_per_step: float = 10.0):
        raise NotImplementedError(_REPLAY)

    # ------------------------------------------------------------------ #
    def _advance(self, seconds: float, exposed: bool) -> None:
        t_end = self.virtual_time + seconds
        for ev in self._net.deaths_until(t_end):
            if ev.slot < self._watch:
                self.observed_lifetimes.append(ev.lifetime)
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
