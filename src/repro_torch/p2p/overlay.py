"""P2P storage overlay: holder membership under churn and replica placement.

The paper's architecture off-loads checkpoint storage from the work-pool
server onto the peers themselves (Sec 1-2): each job's checkpoint image is
replicated to R *holder* peers picked from the overlay.  Holders churn like
every other volunteer, so the overlay continuously re-replicates: when a
holder departs, a replacement is recruited and the image re-copied from a
surviving replica (or the server's master copy when none survives).

This module models that membership process and the placement rule:

* :func:`availability` — stationary probability that one holder slot is
  serving.  A slot alternates ALIVE (Exp lifetime, hazard mu) and REPAIRING
  (mean ``t_repair`` to recruit + re-copy); by alternating-renewal theory
  the up-fraction is E[up] / (E[up] + E[down]) = 1 / (1 + mu * t_repair),
  independent of the repair-time distribution.
* :class:`ReplicaSetProcess` — the exact event-driven R-slot process, used
  as the parity oracle for the batched engine's closed-form replica-
  survival law (each slot i.i.d. Bernoulli(availability) at any instant —
  exact in steady state because exponential phases are memoryless and the
  process is started stationary).
* :func:`rendezvous_placement` — highest-random-weight (HRW) placement of
  an item on R of N nodes.  Deterministic given (key, membership), so every
  peer computes the same holder set with no coordination — the same
  "no additional message" property the paper's estimator piggybacking has —
  and membership changes only remap the items whose holders departed.
* :func:`stationary_loss_rate` — the exact steady-state rate at which the
  replica SET transitions to all-dead, cross-checked in the tests against
  the small-rate approximation ``repro.core.replication.
  effective_failure_rate`` and against :class:`ReplicaSetProcess`.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, List, Optional, Sequence, Tuple

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - annotation only (avoids an import
    # cycle: repro.sim.engine imports repro.p2p.store -> this module at
    # package-init time, before repro.sim.scenarios finishes loading)
    from repro_torch.sim.scenarios import ShockClock, ShockSpec

MtbfFn = Callable[[float], float]  # wall time (s) -> current MTBF (s)


class ScheduleExhausted(RuntimeError):
    """A replayed holder schedule was advanced past its recorded horizon."""


def availability(mu: float, t_repair: float) -> float:
    """Stationary up-probability of one holder slot: 1 / (1 + mu*t_repair)."""
    if mu < 0 or t_repair < 0:
        raise ValueError("mu and t_repair must be non-negative")
    return 1.0 / (1.0 + mu * t_repair)


def shock_availability(mu: float, t_repair: float, shock_rate: float = 0.0,
                       kill_frac: float = 0.0) -> float:
    """Stationary holder availability under correlated shocks.

    Shock epochs (Poisson, ``shock_rate``) kill an up holder with
    probability ``kill_frac``; thinning makes the holder's shock-death
    process Poisson with rate ``shock_rate * kill_frac``, and the
    superposition with the background Exp(mu) hazard is still memoryless —
    so alternating-renewal applies *exactly* with the effective hazard:

        A = 1 / (1 + (mu + shock_rate*kill_frac) * t_repair)

    The MARGINAL is unchanged from an i.i.d. fleet with that rate; what
    shocks change is the joint law — see :func:`shock_survivor_pmf`.
    """
    if shock_rate < 0 or not 0.0 <= kill_frac <= 1.0:
        raise ValueError("shock_rate must be >= 0 and kill_frac in [0, 1]")
    return availability(mu + shock_rate * kill_frac, t_repair)


def shock_survivor_pmf(R: int, mu: float, t_repair: float, shock_rate: float,
                       kill_frac: float, job_fail_rate: float,
                       job_kill_prob: float) -> np.ndarray:
    """Exact survivor-count law seen by a restore attempt under shocks.

    Without shocks every restore finds m ~ Binomial(R, A) survivors (each
    holder's stationary Bernoulli is independent of the job's failure
    instant).  With shocks the restore *instant is not exchangeable*: a
    job failure was caused by a shock with probability

        q = shock_rate * job_kill_prob
            / (job_fail_rate + shock_rate * job_kill_prob)

    (the exponential race between the background job-failure process at
    ``job_fail_rate`` and the thinned shock-kill process), and conditional
    on a shock-caused failure each in-scope holder was additionally killed
    by THAT shock with probability ``kill_frac`` — so survivors drop to
    Binomial(R, A*(1-kill_frac)).  The attempt-time law is the mixture

        P(m) = q * Binom(R, A*(1-f))(m) + (1-q) * Binom(R, A)(m)

    with A = :func:`shock_availability`.  This is the closed form the
    batched engine samples branchlessly; independence (q = 0) strictly
    stochastically dominates it, which is exactly how an i.i.d. law
    undercounts replica loss under correlated churn.
    """
    if R < 0:
        raise ValueError("replication factor must be >= 0")
    if job_fail_rate < 0 or not 0.0 <= job_kill_prob <= 1.0:
        raise ValueError("job_fail_rate >= 0 and job_kill_prob in [0, 1]")
    A = shock_availability(mu, t_repair, shock_rate, kill_frac)
    s_kill = shock_rate * job_kill_prob
    denom = job_fail_rate + s_kill
    q = s_kill / denom if denom > 0 else 0.0
    A_post = A * (1.0 - kill_frac)

    def binom(p: float) -> np.ndarray:
        return np.array([math.comb(R, m) * p ** m * (1.0 - p) ** (R - m)
                         for m in range(R + 1)])

    return q * binom(A_post) + (1.0 - q) * binom(A)


def stationary_loss_rate(mu: float, R: int, t_repair: float) -> float:
    """Exact steady-state rate of replica-set loss (all R holders dead).

    The set enters the all-dead state when exactly one holder is alive and
    it dies: rate = P(exactly 1 alive) * mu = R * A * (1-A)^(R-1) * mu with
    A = availability(mu, t_repair).  For mu*t_repair << 1 this reduces to
    R * mu * (mu*t_repair)^(R-1), the small-rate cascade approximation of
    :func:`repro.core.replication.effective_failure_rate`.
    """
    if R < 1:
        raise ValueError("replication factor must be >= 1")
    A = availability(mu, t_repair)
    return R * A * (1.0 - A) ** (R - 1) * mu


@dataclass(frozen=True)
class HolderTrack:
    """One holder slot's pinned up/down realization (DESIGN.md Sec 10).

    ``toggles`` are the ascending wall times at which the slot flips state,
    starting from ``init_up``: an even number of toggles before t leaves the
    slot in its initial state at t.  A tuple of tracks IS the replica-set
    realization — serialized into :class:`repro.runtime.failures.
    StageSchedule` so the sim's prediction and the executor's measurement
    answer "who is alive at t?" from the same data.
    """

    init_up: bool
    toggles: Tuple[float, ...] = ()

    def __post_init__(self) -> None:
        ts = self.toggles
        if any(b < a for a, b in zip(ts, ts[1:])):
            raise ValueError("holder toggles must be time-ordered")


class ReplicaSetProcess:
    """Event-driven alternating-renewal process of R holder slots.

    Each slot alternates ALIVE (lifetime ~ Exp with the birth-time hazard
    of ``mtbf_fn``) and REPAIRING (replacement recruitment + re-copy,
    duration ~ Exp(mean ``t_repair``)).  Repair is always possible: a
    replacement copies from a surviving replica, or from the work-pool
    server's master copy when none survives (the paper's server fallback).

    The process is initialized *stationary* at ``t0`` — each slot up with
    probability :func:`availability` and exponential phases are memoryless —
    so the marginal of :meth:`n_alive` at any later time is exactly
    Binomial(R, availability(mu, t_repair)) under constant churn.  This is
    the per-replica parity oracle for the batched engine's closed-form law.
    """

    def __init__(self, R: int, mtbf_fn: MtbfFn, t_repair: float,
                 rng: np.random.Generator, t0: float = 0.0,
                 slot_mults: Optional[Sequence[float]] = None,
                 shock: Optional["ShockSpec"] = None,
                 shock_clock: Optional["ShockClock"] = None,
                 shock_rng: Optional[np.random.Generator] = None,
                 scope_mask: Optional[Sequence[bool]] = None):
        """``slot_mults`` gives holder slot ``i`` a hazard multiplier
        (heterogeneous fleets, DESIGN.md Sec 7): its lifetimes are
        Exp(mtbf/mult) and its stationary availability
        1/(1 + mult*mu*t_repair).  ``None`` keeps the homogeneous process,
        with an unchanged RNG call sequence.

        ``shock`` adds correlated mass-kill epochs (DESIGN.md Sec 8): at
        each epoch of ``shock_clock`` every UP in-scope holder dies
        independently with probability ``kill_frac`` and enters repair.
        Pass the SAME clock as the job's :class:`ChurnNetwork` so holder
        losses coincide with the job failures that trigger restores —
        the correlation the engine's mixture law models.  ``shock_rng``
        (kill Bernoullis) and the clock are derived from ``rng`` when
        omitted; ``scope_mask`` restricts kills to a holder subset.  With
        ``shock=None`` the RNG call sequence is unchanged bit-for-bit.
        """
        if R < 0:
            raise ValueError("replication factor must be >= 0")
        if t_repair <= 0:
            raise ValueError("t_repair must be positive")
        if slot_mults is not None:
            slot_mults = tuple(float(m) for m in slot_mults)
            if len(slot_mults) != R:
                raise ValueError(
                    f"need one hazard multiplier per holder: "
                    f"{len(slot_mults)} != {R}")
            if slot_mults and min(slot_mults) <= 0:
                raise ValueError("holder hazard multipliers must be positive")
        self.R = R
        self.mtbf_fn = mtbf_fn
        self.t_repair = float(t_repair)
        self.rng = rng
        self.slot_mults = slot_mults
        self.t0 = float(t0)
        self.t = float(t0)
        self.n_losses = 0  # transitions into the all-dead state
        self.shock = shock
        self._shock_i = 0
        if shock is not None:
            if scope_mask is None:
                scope_mask = (True,) * R
            scope_mask = tuple(bool(b) for b in scope_mask)
            if len(scope_mask) != R:
                raise ValueError("need one scope flag per holder slot")
            self._scope = scope_mask
            # Spawned (not drawn) from the main rng, so attaching a shock
            # leaves the holder lifetime/repair draws bit-identical.
            kids = rng.spawn(2)
            if shock_clock is None:
                from repro_torch.sim.scenarios import ShockClock  # runtime-safe
                shock_clock = ShockClock(shock.rate, kids[0])
            self._clock = shock_clock
            self._shock_rng = shock_rng if shock_rng is not None else kids[1]
            # Epochs before t0 predate the (stationary) start of this
            # process: skip them so a late-created replica set does not
            # replay history.
            while self._clock.epoch(self._shock_i) <= t0:
                self._shock_i += 1
        mtbf0 = mtbf_fn(t0)
        self._replay = None  # live process; set by from_lifetimes
        self._up = np.zeros(R, dtype=bool)
        self._next = np.full(R, np.inf)
        for i in range(R):
            mult = slot_mults[i] if slot_mults is not None else 1.0
            # Stationary init: the shock adds a thinned-Poisson kill rate
            # (rate * kill_frac for in-scope slots) to the holder's hazard;
            # the superposed up-phase is still exponential, so the
            # alternating-renewal marginal is exact (shock_availability).
            mu_i = mult / mtbf0
            if shock is not None and self._scope[i]:
                A = shock_availability(mu_i, t_repair, shock.rate,
                                       shock.kill_frac)
            else:
                A = availability(mu_i, t_repair)
            self._up[i] = rng.random() < A
            hold = mtbf0 / mult if self._up[i] else t_repair
            self._next[i] = t0 + rng.exponential(hold)
        # Transition log: every state flip of every slot, so the advanced
        # prefix of the process can be serialized (lifetimes_until) and
        # replayed bit-exactly by a from_lifetimes view.  R <= 8, cheap.
        self._init_up = tuple(bool(u) for u in self._up)
        self._toggles: List[List[float]] = [[] for _ in range(R)]

    # ------------------------------------------------------------------ #
    # Pinned-realization (replay) view.                                   #
    # ------------------------------------------------------------------ #
    @classmethod
    def from_lifetimes(cls, tracks: Sequence[HolderTrack], t0: float = 0.0,
                       horizon: float = math.inf) -> "ReplicaSetProcess":
        """A replayable view over pinned holder realizations — no RNG.

        ``tracks`` come from :meth:`lifetimes_until` (directly or via a
        serialized :class:`repro.runtime.failures.StageSchedule`); the view
        answers :meth:`n_alive` / :meth:`alive_slots` by walking the pinned
        toggle lists, so the heap oracle, the engine's closed-form law, and
        the executor all consult the same realization.  Advancing past
        ``horizon`` raises :class:`repro.runtime.failures.ScheduleExhausted`
        — beyond it the tracks carry no information (absence of toggles
        there means "not generated", not "still up").
        """
        self = cls.__new__(cls)
        self.R = len(tracks)
        self.mtbf_fn = None
        self.t_repair = 0.0
        self.rng = None
        self.slot_mults = None
        self.shock = None
        self.t0 = float(t0)
        self.t = float(t0)
        self.n_losses = 0
        self._replay = tuple(tuple(tr.toggles) for tr in tracks)
        self._replay_horizon = float(horizon)
        self._cursor = [0] * self.R
        self._up = np.array([tr.init_up for tr in tracks], dtype=bool)
        self._init_up = tuple(tr.init_up for tr in tracks)
        self._toggles = [list(tr.toggles) for tr in tracks]
        return self

    def lifetimes_until(self, horizon: float) -> Tuple[HolderTrack, ...]:
        """Advance to ``horizon`` and serialize the realization so far."""
        self.advance(horizon)
        return tuple(HolderTrack(init_up=self._init_up[i],
                                 toggles=tuple(self._toggles[i]))
                     for i in range(self.R))

    def _advance_replay(self, t: float) -> None:
        if t > self._replay_horizon:
            raise ScheduleExhausted(
                f"holder replay advanced to t={t:.1f}s past the recorded "
                f"horizon {self._replay_horizon:.1f}s")
        due: List[Tuple[float, int]] = []
        for i in range(self.R):
            toggles = self._replay[i]
            c = self._cursor[i]
            while c < len(toggles) and toggles[c] <= t:
                due.append((toggles[c], i))
                c += 1
            self._cursor[i] = c
        # Time-ordered across slots so the all-dead transition count is
        # exact even when toggles of different slots interleave.
        for _, i in sorted(due):
            was_any = bool(self._up.any())
            self._up[i] = not self._up[i]
            if was_any and not self._up.any():
                self.n_losses += 1
        self.t = max(self.t, float(t))

    def _slot_mtbf(self, i: int, t: float) -> float:
        m = self.mtbf_fn(t)
        return m / self.slot_mults[i] if self.slot_mults is not None else m

    def _next_shock_time(self) -> float:
        return (self._clock.epoch(self._shock_i)
                if self.shock is not None else math.inf)

    def advance(self, t: float) -> None:
        """Process holder deaths/repairs/shock epochs up to ``t``, in order."""
        if self._replay is not None:
            self._advance_replay(t)
            return
        while self.R:
            i = int(np.argmin(self._next))
            te = float(self._next[i])
            ts = self._next_shock_time()
            if min(te, ts) > t:
                break
            if ts <= te:
                # Mass-kill epoch: every UP in-scope holder dies w.p.
                # kill_frac, simultaneously; its pending natural death is
                # superseded by the repair completion.
                self._shock_i += 1
                f = self.shock.kill_frac
                was_up = bool(self._up.any())
                for j in range(self.R):
                    if self._up[j] and self._scope[j] \
                            and self._shock_rng.random() < f:
                        self._up[j] = False
                        self._toggles[j].append(ts)
                        self._next[j] = ts + self.rng.exponential(self.t_repair)
                if was_up and not self._up.any():
                    self.n_losses += 1
                continue
            if self._up[i]:
                self._up[i] = False
                self._toggles[i].append(te)
                self._next[i] = te + self.rng.exponential(self.t_repair)
                if not self._up.any():
                    self.n_losses += 1
            else:
                self._up[i] = True
                self._toggles[i].append(te)
                self._next[i] = te + self.rng.exponential(self._slot_mtbf(i, te))
        self.t = max(self.t, float(t))

    def n_alive(self, t: float) -> int:
        """Surviving replica count at wall time ``t`` (advances the process)."""
        self.advance(t)
        return int(self._up.sum())

    def alive_slots(self, t: float) -> List[int]:
        """Indices of the holders alive at ``t`` (advances the process) —
        class-aware restores stripe over exactly these slots' uplinks."""
        self.advance(t)
        return [i for i in range(self.R) if self._up[i]]

    def loss_rate(self) -> float:
        """Observed all-dead transition rate over the advanced horizon."""
        elapsed = self.t - self.t0
        return self.n_losses / elapsed if elapsed > 0 else 0.0


def rendezvous_placement(key: str, nodes: Sequence[str], R: int,
                         weights: Optional[Sequence[float]] = None) -> List[str]:
    """Pick R of ``nodes`` to hold ``key`` by highest-random-weight hashing.

    Every participant evaluates the same deterministic score
    sha1(key | node), so the holder set needs no coordinator, and removing
    a node only remaps the keys it held (minimal disruption — the property
    that keeps re-replication traffic proportional to churn, not to the
    population).

    ``weights`` enables *weighted* rendezvous hashing (heterogeneous
    fleets): node ``i`` wins proportionally to ``weights[i]`` via the
    standard -w/ln(u) transform of its unit-interval hash — e.g. weight by
    class availability so stable, fat-uplink peers hold more replicas.
    ``None`` keeps the classic unweighted ordering, unchanged.
    """
    if R < 0:
        raise ValueError("replication factor must be >= 0")
    if weights is None:
        scored = sorted(
            nodes,
            key=lambda nd: hashlib.sha1(f"{key}|{nd}".encode()).hexdigest(),
            reverse=True,
        )
        return list(scored[:min(R, len(scored))])
    if len(weights) != len(nodes):
        raise ValueError("need one weight per node")
    if any(w <= 0 for w in weights):
        raise ValueError("placement weights must be positive")

    def score(nd: str, w: float) -> float:
        h = hashlib.sha1(f"{key}|{nd}".encode()).digest()
        # 53 bits of the digest -> u in (0, 1); -w/ln(u) is the classic
        # weighted-rendezvous score (monotone in w, continuous in u).
        u = (int.from_bytes(h[:8], "big") >> 11 | 1) / float(1 << 53)
        return -w / math.log(u)

    scored = sorted(zip(nodes, weights), key=lambda p: score(*p), reverse=True)
    return [nd for nd, _ in scored[:min(R, len(nodes))]]
