"""Discrete-event P2P churn network (paper Sec 4.1 simulator): a numpy
copy of ``repro/sim/network.py`` on the port's scenario registry, so the
port imports no JAX.  Its streams are the reference's, bit for bit.

Simulates a population of peers whose session lifetimes are exponential
with a (possibly time-varying) rate mu(t).  Dead peers are immediately
replaced by fresh sessions, matching steady-state churn in Gnutella/Overnet
style networks (Sec 2).  Events are delivered in time order from a heap.

The paper's Fig. 4 (right) uses a failure rate that doubles over 20 hours;
``doubling_mtbf`` builds that schedule.

**Correlated churn shocks** (DESIGN.md Sec 8): a :class:`ShockSpec` adds
mass-kill events on top of the independent per-slot lifetimes — Poisson
shock epochs from a (shareable) :class:`ShockClock`, each killing every
in-scope slot independently with probability ``kill_frac`` at the same
instant.  Killed slots emit ordinary :class:`DeathEvent`\\ s (their session
ends early) and respawn immediately, so consumers see one time-ordered
stream in which shock epochs appear as bursts of simultaneous deaths.
With ``shock=None`` the RNG call sequence and the event stream are
unchanged bit-for-bit.
"""
from __future__ import annotations

import heapq
import math
from collections import deque
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from repro_torch.sim.scenarios import (
    PeerClassMix,
    Scenario,
    ShockClock,
    ShockSpec,
    resolve_shock,
    scenario,
)

MtbfFn = Callable[[float], float]  # wall time (s) -> current MTBF (s)


def constant_mtbf(mtbf: float) -> MtbfFn:
    """Constant-rate ``MtbfFn``, tagged with its registry :class:`Scenario`
    (the tag rides on the callable's ``.scenario`` attribute)."""
    return scenario("constant", mtbf=mtbf).mtbf_fn


def doubling_mtbf(mtbf0: float, double_after: float = 20 * 3600.0,
                  mtbf_floor: float = 300.0) -> MtbfFn:
    """Failure rate doubles every ``double_after`` seconds (Fig. 4 right).

    ``mtbf_floor`` bounds the decay: the paper's trace data (Sec 2) never
    shows session times below minutes, and an unbounded doubling schedule
    makes censored (livelocked) fixed-interval runs generate exponentially
    many churn events.  Tagged with its :class:`Scenario` like
    :func:`constant_mtbf`.
    """
    return scenario("doubling", mtbf0=mtbf0, double_after=double_after,
                    mtbf_floor=mtbf_floor).mtbf_fn


@dataclass(frozen=True)
class DeathEvent:
    time: float        # wall-clock time of the departure
    slot: int          # which peer slot died (slots are stable; peers rotate)
    lifetime: float    # observed session length of the departed peer


class ChurnNetwork:
    """A fixed set of peer *slots*; each slot is occupied by a succession of
    peer sessions with Exp(mu) lifetimes.  A job that uses slots [0, k)
    fails whenever any of those slots churns (the replacement peer has no
    job state — the paper's failure model).
    """

    def __init__(self, n_slots: int, mtbf_fn: MtbfFn, rng: np.random.Generator,
                 lifetime_sampler: Optional[Callable[[np.random.Generator, float], float]] = None,
                 slot_mults: Optional[Sequence[float]] = None,
                 shock: Optional[ShockSpec] = None,
                 shock_clock: Optional[ShockClock] = None,
                 shock_rng: Optional[np.random.Generator] = None,
                 scope_mask: Optional[Sequence[bool]] = None):
        """``lifetime_sampler(rng, birth)`` overrides the default
        Exp(mtbf_fn(birth)) session lengths — e.g. heavy-tailed Weibull
        lifetimes from the scenario registry.

        ``slot_mults`` gives each slot a hazard multiplier (heterogeneous
        fleets, DESIGN.md Sec 7): slot ``i``'s sampled lifetimes are divided
        by ``slot_mults[i]``, which for exponential (and Weibull) lifetimes
        is exactly a hazard scaling.  ``None`` keeps the homogeneous fleet,
        bit-for-bit (the RNG call sequence is unchanged).

        ``shock`` enables correlated mass-kill epochs (DESIGN.md Sec 8).
        ``shock_clock`` supplies the (shareable) epoch schedule — pass the
        SAME clock to the job network and its replica-holder processes so
        job failures and replica losses stay correlated; when omitted, a
        private clock is derived from ``rng``.  ``shock_rng`` drives the
        per-slot kill Bernoullis (derived from ``rng`` when omitted);
        ``scope_mask`` restricts kills to a slot subset (defaults to all
        slots; class scopes are resolved by :meth:`from_scenario`).
        """
        if n_slots <= 0:
            raise ValueError("need at least one peer slot")
        if slot_mults is not None:
            slot_mults = tuple(float(m) for m in slot_mults)
            if len(slot_mults) != n_slots:
                raise ValueError(
                    f"need one hazard multiplier per slot: {len(slot_mults)} "
                    f"!= {n_slots}")
            if min(slot_mults) <= 0:
                raise ValueError("slot hazard multipliers must be positive")
        self.n_slots = n_slots
        self.mtbf_fn = mtbf_fn
        self.rng = rng
        self.lifetime_sampler = lifetime_sampler
        self.slot_mults = slot_mults
        self.shock = shock
        self._shock_i = 0              # cursor into the shared epoch schedule
        self._pending: deque = deque()  # shock deaths awaiting delivery
        # Lazy deletion: a shock preempts a slot's scheduled natural death,
        # so heap entries carry a per-slot version and stale ones are
        # skipped on pop.  With shock=None nothing is ever invalidated.
        self._ver = [0] * n_slots
        self._birth = [0.0] * n_slots
        if shock is not None:
            if scope_mask is None:
                scope_mask = (True,) * n_slots
            scope_mask = tuple(bool(b) for b in scope_mask)
            if len(scope_mask) != n_slots:
                raise ValueError("need one scope flag per slot")
            self._scope_slots = tuple(i for i in range(n_slots)
                                      if scope_mask[i])
            # Dedicated streams: SPAWNED from the main rng's seed sequence
            # (not drawn from its stream), so attaching a shock — even a
            # rate-0 one — leaves every lifetime draw bit-identical.
            kids = rng.spawn(2)
            self._clock = shock_clock if shock_clock is not None else \
                ShockClock(shock.rate, kids[0])
            self._shock_rng = shock_rng if shock_rng is not None else kids[1]
        self._heap: list[tuple[float, int, float, int]] = []
        for slot in range(n_slots):
            self._spawn(slot, birth=0.0)

    @classmethod
    def from_scenario(cls, scen: Scenario, n_slots: int,
                      rng: np.random.Generator,
                      mix: Optional[PeerClassMix] = None,
                      shock: Optional[ShockSpec] = None,
                      shock_clock: Optional[ShockClock] = None) -> "ChurnNetwork":
        """Build a network whose churn follows a registry scenario, including
        its lifetime distribution (Weibull scenarios sample true heavy
        tails here; the batched engine approximates them by renewal rate).
        ``mix`` assigns per-slot hazard multipliers from a
        :class:`PeerClassMix` (its deterministic prefix-proportional slot
        assignment, the same one the batched engine packs).  The effective
        shock is ``shock`` when given, else whichever of scenario/mix
        declares one (:func:`repro_torch.sim.scenarios.resolve_shock`); class
        scopes resolve to slot masks through the mix's assignment."""
        mults = mix.hazard_mults(n_slots) if mix is not None else None
        if shock is None:
            shock = resolve_shock(scen, mix)
        mask = shock.scope_mask(mix, n_slots) if shock is not None else None
        return cls(n_slots, scen.mtbf_fn, rng,
                   lifetime_sampler=scen.sample_lifetime, slot_mults=mults,
                   shock=shock, shock_clock=shock_clock, scope_mask=mask)

    def _spawn(self, slot: int, birth: float) -> None:
        if self.lifetime_sampler is not None:
            lifetime = float(self.lifetime_sampler(self.rng, birth))
            if lifetime <= 0:
                raise ValueError(f"sampled lifetime must be positive, got {lifetime}")
        else:
            mtbf = self.mtbf_fn(birth)
            if mtbf <= 0:
                raise ValueError(f"MTBF must be positive, got {mtbf} at t={birth}")
            lifetime = self.rng.exponential(mtbf)
        if self.slot_mults is not None:
            # Hazard scaling: dividing an Exp (or Weibull) lifetime by h
            # multiplies its hazard by h; /1.0 is exact for baseline slots.
            lifetime = lifetime / self.slot_mults[slot]
        self._birth[slot] = birth
        heapq.heappush(self._heap,
                       (birth + lifetime, slot, birth, self._ver[slot]))

    # ------------------------------------------------------------------ #
    # Time-ordered event merge: natural deaths, shock epochs, pending.    #
    # ------------------------------------------------------------------ #
    def _natural_peek(self) -> float:
        h = self._heap
        while h and h[0][3] != self._ver[h[0][1]]:
            heapq.heappop(h)  # stale: slot was shock-killed meanwhile
        return h[0][0] if h else math.inf

    def _next_shock_time(self) -> float:
        return (self._clock.epoch(self._shock_i)
                if self.shock is not None else math.inf)

    def _process_shock(self, te: float) -> None:
        """One epoch: kill each in-scope slot independently w.p. kill_frac,
        queueing their (simultaneous) deaths; killed slots respawn at te."""
        self._shock_i += 1
        f = self.shock.kill_frac
        for slot in self._scope_slots:
            if self._shock_rng.random() < f:
                self._pending.append(DeathEvent(
                    time=te, slot=slot, lifetime=te - self._birth[slot]))
                self._ver[slot] += 1  # cancel the scheduled natural death
                self._spawn(slot, birth=te)

    def next_death(self) -> DeathEvent:
        """Pop the next death event; the slot is immediately re-occupied."""
        t = self.peek_next_death_time()
        if self._pending and self._pending[0].time <= t:
            return self._pending.popleft()
        death_time, slot, birth, _ = heapq.heappop(self._heap)
        self._spawn(slot, birth=death_time)
        return DeathEvent(time=death_time, slot=slot, lifetime=death_time - birth)

    def deaths_until(self, t_end: float) -> Iterator[DeathEvent]:
        """Yield death events with time <= t_end, in order (shock-epoch
        deaths arrive as same-timestamp bursts)."""
        while self.peek_next_death_time() <= t_end:
            yield self.next_death()

    def peek_next_death_time(self) -> float:
        """Wall time of the next delivered death.  Shock epochs scheduled
        before the next natural death are processed (their kill Bernoullis
        drawn) here — deterministic, since the dedicated shock streams are
        consumed in epoch order regardless of who asks first."""
        while True:
            if self._pending:
                return self._pending[0].time
            t_nat = self._natural_peek()
            t_shk = self._next_shock_time()
            if t_shk < t_nat:
                self._process_shock(t_shk)
                continue
            return t_nat
