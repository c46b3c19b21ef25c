"""Churn scenario registry shared by both simulation engines.

A :class:`Scenario` describes the per-peer failure environment as a
(possibly time-varying) hazard rate plus, where it differs, a session
lifetime sampler.  The same object drives

* the per-event reference simulator (:mod:`repro.sim.network` /
  :mod:`repro.sim.job`) through :attr:`Scenario.mtbf_fn` and
  :meth:`Scenario.sample_lifetime`, and
* the batched Monte-Carlo engine (:mod:`repro.sim.engine`) through the
  vectorized :func:`hazard_kernel`, which is branchless so heterogeneous
  scenarios can share one batched step.

Scenarios are registered by name so experiment grids, benchmarks, and the
CLI can enumerate them:

    >>> from repro_torch.sim.scenarios import scenario, available_scenarios
    >>> s = scenario("diurnal", mtbf=7200.0, amplitude=0.5)
    >>> sorted(available_scenarios())  # doctest: +ELLIPSIS
    ['constant', 'diurnal', 'doubling', 'flash_crowd', 'trace', 'weibull']

The paper evaluates constant and doubling departure rates (Fig. 4); the
diurnal, flash-crowd, Weibull, and trace scenarios extend the evaluation to
the richer churn observed in BOINC/Gnutella-style deployments (Sec 2).

**Heterogeneous fleets** (DESIGN.md Sec 7): a :class:`PeerClassMix` layers
named peer *classes* on top of a scenario — each class scales the
scenario's hazard (``hazard_mult``), the peer's compute throughput
(``speed``), and its replica-serving uplink (``uplink_mult``).  Anderson &
Fedak measure order-of-magnitude spreads across exactly these three axes
in real BOINC fleets, which is why volunteer populations are not a
homogeneous cluster.  Mixes are registered like scenarios
(:func:`peer_class_mix` / :func:`available_mixes`), and classes are
assigned to peer slots by the deterministic prefix-proportional rule
:meth:`PeerClassMix.assign`, so the batched engine and the per-event heap
oracle agree on which slot belongs to which class without exchanging any
state.

**Correlated churn shocks** (DESIGN.md Sec 8): a :class:`ShockSpec` adds a
second, *correlated* failure process on top of the scenario's independent
per-peer hazard — Poisson shock epochs at ``rate`` per second, each killing
every live peer in ``scope`` independently with probability ``kill_frac``
*at the same instant*.  This is the diurnal-wave / LAN-partition /
flash-exit regime measured in real volunteer fleets (Anderson & Fedak) and
the one an i.i.d. availability law cannot express: at a shock epoch the
deaths of different peers are maximally correlated, so a job failure
coincides with replica-holder losses exactly when the replicas are needed.
A shock spec can ride on a :class:`Scenario` (fleet-wide waves) or on a
:class:`PeerClassMix` (``scope`` naming one class models a campus
partition or a volunteer flash exit); :func:`resolve_shock` picks the
effective spec for a simulation cell and rejects ambiguous declarations.
:class:`ShockClock` is the *shared* lazily-extended epoch schedule both
per-event processes (job churn and replica holders) consume, preserving
the job-failure/replica-loss correlation the batched engine's mixture law
models in closed form.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# Stable kind ids — the batched engine selects hazard formulas branchlessly
# with these (see hazard_kernel), so the numbering is part of the contract.
CONSTANT, DOUBLING, DIURNAL, FLASH_CROWD, WEIBULL, TRACE = range(6)

_TWO_PI = 2.0 * math.pi

# Per-seed tag of the dedicated noise stream feeding shock epochs/kills in
# the per-event simulators ("shck"); distinct from the engine's observation
# stream and the workflow's hand-off stream so the three never alias.
SHOCK_STREAM = 0x7368636B


@dataclass(frozen=True)
class ShockSpec:
    """A correlated-churn shock process layered on a scenario or mix.

    Shock epochs arrive as a Poisson process with ``rate`` per second; at
    each epoch every live peer in ``scope`` is killed independently with
    probability ``kill_frac`` — *simultaneously*, which is what makes the
    process correlated (the marginal per-peer kill rate is just
    ``rate * kill_frac``, indistinguishable from background churn; the
    cross-peer simultaneity is the whole point).  ``scope`` is ``"all"``
    (fleet-wide wave) or the name of one :class:`PeerClass` in the cell's
    mix (partition / flash exit of that population).

    ``rate = 0`` is a valid spec and must behave bit-identically to no
    shock at all — the engine's carry is formulated as additive zero terms
    and the per-event simulators draw nothing from the shock streams, so
    this holds exactly (tests/test_shocks.py).
    """

    rate: float
    kill_frac: float
    scope: str = "all"

    def __post_init__(self) -> None:
        if not (self.rate >= 0.0 and math.isfinite(self.rate)):
            raise ValueError("shock rate must be finite and >= 0")
        if not 0.0 < self.kill_frac <= 1.0:
            raise ValueError("kill_frac must be in (0, 1]")
        if not self.scope:
            raise ValueError("scope must be 'all' or a peer-class name")

    # ------------------------------------------------------------------ #
    def scope_mask(self, mix: Optional["PeerClassMix"],
                   n: int) -> Tuple[bool, ...]:
        """Which of ``n`` slots the shock can kill, under the mix's
        deterministic prefix-proportional slot assignment (``None`` mix is
        only valid for ``scope='all'``)."""
        if self.scope == "all":
            return (True,) * n
        if mix is None:
            raise ValueError(
                f"class-scoped shock {self.scope!r} needs a PeerClassMix")
        names = [c.name for c in mix.classes]
        if self.scope not in names:
            raise ValueError(
                f"shock scope {self.scope!r} names no class of the mix "
                f"{sorted(names)}")
        ci = names.index(self.scope)
        return tuple(a == ci for a in mix.assign(n))

    def scope_count(self, mix: Optional["PeerClassMix"], n: int) -> int:
        return sum(self.scope_mask(mix, n))

    def job_kill_prob(self, n_scope: int) -> float:
        """P(a shock epoch kills >= 1 of ``n_scope`` in-scope job peers) —
        each epoch's job-kill events thin the epoch Poisson process, so the
        job-level shock-failure process is Poisson with rate
        ``rate * job_kill_prob``."""
        if n_scope < 0:
            raise ValueError("n_scope must be non-negative")
        return -math.expm1(n_scope * math.log1p(-self.kill_frac)) \
            if self.kill_frac < 1.0 else (0.0 if n_scope == 0 else 1.0)


class ShockClock:
    """Shared, lazily-extended Poisson epoch schedule.

    Every per-event consumer of one simulation's shock process (the
    :class:`~repro.sim.network.ChurnNetwork` job churn AND the
    :class:`~repro.p2p.overlay.ReplicaSetProcess` replica holders) must
    read the SAME epochs — shocks kill job peers and checkpoint holders at
    the same instants, which is precisely the correlation that makes
    restores find depleted replica sets.  Consumers keep their own cursor
    into the schedule (:meth:`epoch` extends it on demand) and draw their
    own per-peer kill Bernoullis; only the epochs are shared.
    """

    def __init__(self, rate: float, rng: np.random.Generator):
        if rate < 0:
            raise ValueError("shock rate must be >= 0")
        self.rate = float(rate)
        self.rng: Optional[np.random.Generator] = rng
        self._epochs: list = []

    @classmethod
    def pinned(cls, rate: float, epochs: Sequence[float]) -> "ShockClock":
        """A clock replaying a pre-materialized epoch schedule, no RNG.

        Serialized failure schedules (:mod:`repro.runtime.failures`) record
        the exact epochs a simulation consumed; a pinned clock feeds them
        back so the executor's injected shocks land at the same instants.
        Asking past the recorded schedule returns inf (no further epochs
        within the schedule's horizon — by construction none exist there).
        """
        if rate < 0:
            raise ValueError("shock rate must be >= 0")
        clock = cls.__new__(cls)
        clock.rate = float(rate)
        clock.rng = None
        clock._epochs = [float(e) for e in epochs]
        return clock

    def epoch(self, i: int) -> float:
        """Wall time of the i-th shock epoch (inf when rate is 0)."""
        if self.rate <= 0.0:
            return math.inf
        while len(self._epochs) <= i:
            if self.rng is None:
                return math.inf  # pinned schedule exhausted
            prev = self._epochs[-1] if self._epochs else 0.0
            self._epochs.append(prev + self.rng.exponential(1.0 / self.rate))
        return self._epochs[i]

    def epochs_until(self, t: float) -> list:
        """Materialize (and return) every epoch <= ``t``, in order."""
        out = []
        i = 0
        while self.epoch(i) <= t:
            out.append(self._epochs[i])
            i += 1
        return out


def resolve_shock(scenario: Optional["Scenario"] = None,
                  mix: Optional["PeerClassMix"] = None) -> Optional[ShockSpec]:
    """The effective shock spec of a (scenario, mix) pair.

    A shock may ride on the scenario (fleet-wide waves) or on the mix
    (class-targeted partitions); declaring one on both is ambiguous — two
    simultaneous epoch processes are not modelled — and raises.
    """
    s = scenario.shock if scenario is not None else None
    m = mix.shock if mix is not None else None
    if s is not None and m is not None:
        raise ValueError(
            "shock declared on both the scenario and the mix; attach it to "
            "exactly one")
    return s if s is not None else m


@dataclass(frozen=True)
class Scenario:
    """A named churn environment.

    ``params`` is a fixed-width tuple so heterogeneous scenarios stack into
    one ``[B, 4]`` array for the batched engine; unused slots hold 1.0 (a
    benign value for every formula) rather than 0 to keep the branchless
    kernel free of spurious divides.  ``trace_t``/``trace_mtbf`` are only
    populated for the trace kind.

    ``shock`` layers a correlated-churn :class:`ShockSpec` on top of the
    independent hazard (DESIGN.md Sec 8); :meth:`with_shock` derives a
    shocked copy so registry factories stay shock-agnostic.
    """

    name: str
    kind: int
    params: Tuple[float, float, float, float]
    trace_t: Tuple[float, ...] = ()
    trace_mtbf: Tuple[float, ...] = ()
    shock: Optional[ShockSpec] = None

    def with_shock(self, shock: Optional[ShockSpec]) -> "Scenario":
        """This scenario with ``shock`` attached (None detaches)."""
        return dataclasses.replace(self, shock=shock)

    # ------------------------------------------------------------------ #
    # Scalar path (reference simulator, oracle policy).                   #
    # ------------------------------------------------------------------ #
    def mtbf(self, t: float) -> float:
        """Per-peer MTBF (1/hazard) at wall time ``t`` — pure-python fast
        path; the per-event simulator calls this once per session spawn."""
        p0, p1, p2, p3 = self.params
        if self.kind == CONSTANT:
            return p0
        if self.kind == DOUBLING:
            return max(p0 * 2.0 ** (-t / p1), p2)
        if self.kind == DIURNAL:
            return p0 / (1.0 + p1 * math.sin(_TWO_PI * (t + p3) / p2))
        if self.kind == FLASH_CROWD:
            return p1 if p2 <= t < p2 + p3 else p0
        if self.kind == WEIBULL:
            return p2  # steady-state effective MTBF = E[lifetime]
        # TRACE: piecewise-constant, holding the last value past the end.
        i = bisect.bisect_right(self.trace_t, t) - 1
        return self.trace_mtbf[max(i, 0)]

    def hazard_scalar(self, t: float) -> float:
        return 1.0 / self.mtbf(t)

    @property
    def mtbf_fn(self) -> Callable[[float], float]:
        """An ``MtbfFn`` for :class:`repro.sim.network.ChurnNetwork`.

        The returned callable is tagged with ``.scenario`` so higher layers
        (``repro.sim.experiments.compare``) can recover the structured
        scenario from legacy ``mtbf_fn=`` arguments and route them onto the
        batched engine.
        """
        mtbf = self.mtbf

        def wrapped(t: float) -> float:
            return mtbf(t)

        wrapped.scenario = self  # type: ignore[attr-defined]
        return wrapped

    def sample_lifetime(self, rng: np.random.Generator, birth: float) -> float:
        """One session lifetime for a peer born at ``birth`` (reference sim).

        Exponential with the birth-time MTBF for every kind except Weibull,
        which draws true heavy-tailed lifetimes (the batched engine models
        Weibull by its steady-state renewal rate instead — DESIGN.md Sec 4).
        """
        if self.kind == WEIBULL:
            scale, shape = self.params[0], self.params[1]
            return float(scale * rng.weibull(shape))
        return float(rng.exponential(self.mtbf(birth)))


# --------------------------------------------------------------------------- #
# Vectorized hazard kernel (batched engine).                                   #
# --------------------------------------------------------------------------- #

def hazard_kernel(t, kind, p, trace_t, trace_mtbf):
    """Branchless per-peer failure rate for a batch of cells (torch).

    Shapes: ``t`` [B] float64, ``kind`` [B] int, ``p`` [B, 4], ``trace_t`` /
    ``trace_mtbf`` [B, L] (dummy length-2 rows for non-trace cells).  Every
    branch is evaluated and selected with ``where``, as in
    ``repro.sim.scenarios.hazard_kernel``; the CUDA sim-step kernel
    evaluates the same operations per cell.
    """
    p0, p1, p2, p3 = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    r_const = 1.0 / p0
    r_doub = 1.0 / torch.maximum(p0 * torch.exp2(-t / p1), p2)
    r_diur = (1.0 + p1 * torch.sin(_TWO_PI * (t + p3) / p2)) / p0
    in_spike = (t >= p2) & (t < p2 + p3)
    r_flash = 1.0 / torch.where(in_spike, p1, p0)
    r_weib = 1.0 / p2
    # Piecewise-constant trace lookup: index = (#breakpoints <= t) - 1.
    idx = (trace_t <= t[..., None]).sum(dim=-1) - 1
    idx = idx.clamp(0, trace_t.shape[-1] - 1)
    r_trace = 1.0 / torch.gather(trace_mtbf, -1, idx[..., None])[..., 0]

    return torch.where(kind == CONSTANT, r_const,
           torch.where(kind == DOUBLING, r_doub,
           torch.where(kind == DIURNAL, r_diur,
           torch.where(kind == FLASH_CROWD, r_flash,
           torch.where(kind == WEIBULL, r_weib, r_trace)))))


# --------------------------------------------------------------------------- #
# Registry.                                                                    #
# --------------------------------------------------------------------------- #

_REGISTRY: Dict[str, Callable[..., Scenario]] = {}


def register_scenario(name: str):
    """Decorator: register a scenario factory under ``name``."""

    def deco(factory: Callable[..., Scenario]):
        if name in _REGISTRY:
            raise ValueError(f"scenario {name!r} already registered")
        _REGISTRY[name] = factory
        return factory

    return deco


def scenario(name: str, **kwargs) -> Scenario:
    """Instantiate a registered scenario by name."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; available: {sorted(_REGISTRY)}") from None
    return factory(**kwargs)


def available_scenarios() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


@register_scenario("constant")
def constant(mtbf: float = 7200.0) -> Scenario:
    """Constant departure rate (paper Fig. 4 left)."""
    if mtbf <= 0:
        raise ValueError("mtbf must be positive")
    return Scenario("constant", CONSTANT, (float(mtbf), 1.0, 1.0, 1.0))


@register_scenario("doubling")
def doubling(mtbf0: float = 7200.0, double_after: float = 20 * 3600.0,
             mtbf_floor: float = 300.0) -> Scenario:
    """Failure rate doubles every ``double_after`` seconds (Fig. 4 right).

    ``mtbf_floor`` bounds the decay — trace data (Sec 2) never shows session
    times below minutes, and an unbounded schedule makes censored runs
    generate exponentially many events.
    """
    if min(mtbf0, double_after, mtbf_floor) <= 0:
        raise ValueError("mtbf0, double_after, mtbf_floor must be positive")
    return Scenario("doubling", DOUBLING,
                    (float(mtbf0), float(double_after), float(mtbf_floor), 1.0))


@register_scenario("diurnal")
def diurnal(mtbf: float = 7200.0, amplitude: float = 0.6,
            period: float = 86400.0, phase: float = 0.0) -> Scenario:
    """Sinusoidal day/night churn: rate(t) = (1 + a sin(2pi (t+phase)/P)) / mtbf.

    Volunteer populations churn hardest when users reclaim their machines
    (evenings); ``amplitude`` in [0, 1) is the relative swing of the rate.
    """
    if not 0.0 <= amplitude < 1.0:
        raise ValueError("amplitude must be in [0, 1)")
    if mtbf <= 0 or period <= 0:
        raise ValueError("mtbf and period must be positive")
    return Scenario("diurnal", DIURNAL,
                    (float(mtbf), float(amplitude), float(period), float(phase)))


@register_scenario("flash_crowd")
def flash_crowd(mtbf: float = 7200.0, spike_mtbf: float = 900.0,
                at: float = 6 * 3600.0, duration: float = 2 * 3600.0) -> Scenario:
    """A correlated departure spike: MTBF drops to ``spike_mtbf`` during
    [at, at + duration) — e.g. a popular event pulling volunteers away."""
    if min(mtbf, spike_mtbf, duration) <= 0 or at < 0:
        raise ValueError("mtbf, spike_mtbf, duration must be positive; at >= 0")
    return Scenario("flash_crowd", FLASH_CROWD,
                    (float(mtbf), float(spike_mtbf), float(at), float(duration)))


@register_scenario("weibull")
def weibull(scale: float = 7200.0, shape: float = 0.6) -> Scenario:
    """Heavy-tailed session lifetimes ~ Weibull(scale, shape).

    ``shape < 1`` gives the decreasing hazard seen in P2P traces (many
    short-lived peers, a long-lived core).  The reference simulator samples
    true Weibull lifetimes; the batched engine uses the steady-state renewal
    rate 1 / E[lifetime] = 1 / (scale * Gamma(1 + 1/shape)).
    """
    if scale <= 0 or shape <= 0:
        raise ValueError("scale and shape must be positive")
    mean = scale * math.gamma(1.0 + 1.0 / shape)
    return Scenario("weibull", WEIBULL, (float(scale), float(shape), float(mean), 1.0))


@register_scenario("trace")
def trace(times: Sequence[float], mtbfs: Sequence[float]) -> Scenario:
    """Trace-driven churn: piecewise-constant MTBF from measured arrays.

    ``times`` must be ascending and start at 0; the last MTBF holds forever.
    """
    times = tuple(float(t) for t in times)
    mtbfs = tuple(float(m) for m in mtbfs)
    if len(times) != len(mtbfs) or not times:
        raise ValueError("times and mtbfs must be equal-length and non-empty")
    if times[0] != 0.0 or any(b <= a for a, b in zip(times, times[1:])):
        raise ValueError("times must be strictly ascending and start at 0")
    if min(mtbfs) <= 0:
        raise ValueError("mtbfs must be positive")
    if len(times) == 1:  # pad so batched interp always has >= 2 points
        times, mtbfs = times + (times[0] + 1.0,), mtbfs * 2
    return Scenario("trace", TRACE, (1.0, 1.0, 1.0, 1.0),
                    trace_t=times, trace_mtbf=mtbfs)


# --------------------------------------------------------------------------- #
# Heterogeneous peer fleets: classes, mixes, and the mix registry.             #
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class PeerClass:
    """One named population of peers inside a :class:`PeerClassMix`.

    ``hazard_mult`` multiplies the scenario's hazard rate for peers of this
    class (2.0 = churns twice as fast); ``speed`` is the compute-speed
    factor (work units per wall second, 1.0 = the homogeneous baseline);
    ``uplink_mult`` multiplies :class:`repro.p2p.TransferModel.peer_uplink`
    when a peer of this class serves a checkpoint replica.
    """

    name: str
    hazard_mult: float = 1.0
    speed: float = 1.0
    uplink_mult: float = 1.0

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("peer class needs a name")
        if min(self.hazard_mult, self.speed, self.uplink_mult) <= 0:
            raise ValueError(
                f"class {self.name!r}: hazard_mult, speed, uplink_mult "
                f"must be positive")

    @property
    def is_baseline(self) -> bool:
        return (self.hazard_mult == 1.0 and self.speed == 1.0
                and self.uplink_mult == 1.0)


@dataclass(frozen=True)
class PeerClassMix:
    """A weighted fleet composition: which classes, in what proportions.

    Canonicalized on construction — classes are sorted by name and weights
    normalized to sum to 1 — so two mixes describing the same population in
    a different order produce *bit-identical* slot assignments and therefore
    bit-identical simulation results (the ordering-invariance contract
    tested in tests/test_heterogeneity.py).

    ``shock`` attaches a class-targeted (or fleet-wide) correlated-churn
    :class:`ShockSpec` to the fleet itself — e.g. a campus partition that
    flash-exits the ``campus`` class (DESIGN.md Sec 8).  A simulation cell
    resolves its effective shock via :func:`resolve_shock`.
    """

    classes: Tuple[PeerClass, ...]
    weights: Tuple[float, ...]
    name: str = ""
    shock: Optional[ShockSpec] = None

    def with_shock(self, shock: Optional[ShockSpec]) -> "PeerClassMix":
        """This mix with ``shock`` attached (None detaches).

        Copies the already-canonical fields directly instead of going
        through ``dataclasses.replace``: re-running ``__post_init__`` would
        re-normalize the weights, and ``w / fsum(w)`` is not bit-stable
        when ``fsum(w)`` is one ulp off 1.0 — which would break the
        bit-identity contracts built on deterministic slot assignment.
        """
        new = object.__new__(PeerClassMix)
        object.__setattr__(new, "classes", self.classes)
        object.__setattr__(new, "weights", self.weights)
        object.__setattr__(new, "name", self.name)
        object.__setattr__(new, "shock", shock)
        return new

    def __post_init__(self) -> None:
        if not self.classes or len(self.classes) != len(self.weights):
            raise ValueError("need equal-length, non-empty classes and weights")
        if min(self.weights) <= 0:
            raise ValueError("mix weights must be positive")
        names = [c.name for c in self.classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate class names in mix: {sorted(names)}")
        order = sorted(range(len(names)), key=lambda i: names[i])
        total = math.fsum(self.weights)
        object.__setattr__(self, "classes",
                           tuple(self.classes[i] for i in order))
        object.__setattr__(self, "weights",
                           tuple(float(self.weights[i]) / total for i in order))

    def __len__(self) -> int:
        return len(self.classes)

    @property
    def is_trivial(self) -> bool:
        """True when every class is the homogeneous baseline (all 1.0) —
        simulators may then take the exact homogeneous fast path."""
        return all(c.is_baseline for c in self.classes)

    # ------------------------------------------------------------------ #
    # Deterministic slot assignment.                                      #
    # ------------------------------------------------------------------ #
    def assign(self, n: int) -> Tuple[int, ...]:
        """Class index per slot for ``n`` slots, prefix-proportional.

        Greedy largest-deficit quota: slot ``i`` goes to the class furthest
        behind its quota ``weight * (i+1)`` (ties to the lower index, i.e.
        name order).  Every *prefix* of the assignment is then as close to
        the mix proportions as integer counts allow — important because the
        k job peers are slots [0, k) of the watch neighbourhood [0, watch)
        of the population [0, n_slots), and each prefix must look like the
        declared mix.  Deterministic, so the batched engine and the
        per-event heap oracle agree on every slot's class with no shared
        state (the same no-coordination property as HRW placement).
        """
        if n < 0:
            raise ValueError("n must be non-negative")
        counts = [0] * len(self.classes)
        out = []
        for i in range(n):
            deficits = [self.weights[c] * (i + 1) - counts[c]
                        for c in range(len(self.classes))]
            j = max(range(len(self.classes)), key=lambda c: (deficits[c], -c))
            counts[j] += 1
            out.append(j)
        return tuple(out)

    def hazard_mults(self, n: int) -> Tuple[float, ...]:
        a = self.assign(n)
        return tuple(self.classes[j].hazard_mult for j in a)

    def speeds(self, n: int) -> Tuple[float, ...]:
        a = self.assign(n)
        return tuple(self.classes[j].speed for j in a)

    def uplink_mults(self, n: int) -> Tuple[float, ...]:
        a = self.assign(n)
        return tuple(self.classes[j].uplink_mult for j in a)

    def hazard_sum(self, n: int) -> float:
        """Sum of hazard multipliers over slots [0, n) — the job- or
        watch-level aggregate failure rate is ``hazard_sum * mu(t)``.
        Exactly ``float(n)`` for a trivial mix (sum of ones), which is what
        keeps the engine's heterogeneous path bit-identical to the
        homogeneous one."""
        return math.fsum(self.hazard_mults(n))

    def mean_speed(self, n: int) -> float:
        """Aggregate compute speed of a job on slots [0, n): the mean class
        speed (perfect load balancing across members — the bag-of-tasks
        semantics of volunteer work units, not lockstep BSP)."""
        if n <= 0:
            raise ValueError("n must be positive")
        return math.fsum(self.speeds(n)) / n


# --------------------------------------------------------------------------- #
# Mix registry (BOINC-flavoured presets).                                      #
# --------------------------------------------------------------------------- #

_MIX_REGISTRY: Dict[str, Callable[..., PeerClassMix]] = {}


def register_mix(name: str):
    """Decorator: register a peer-class-mix factory under ``name``."""

    def deco(factory: Callable[..., PeerClassMix]):
        if name in _MIX_REGISTRY:
            raise ValueError(f"mix {name!r} already registered")
        _MIX_REGISTRY[name] = factory
        return factory

    return deco


def peer_class_mix(name: str, **kwargs) -> PeerClassMix:
    """Instantiate a registered peer-class mix by name."""
    try:
        factory = _MIX_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown mix {name!r}; available: {sorted(_MIX_REGISTRY)}") from None
    return factory(**kwargs)


def available_mixes() -> Tuple[str, ...]:
    return tuple(sorted(_MIX_REGISTRY))


# The three canonical classes, parameterized from the spreads Anderson &
# Fedak report for BOINC hosts: home machines behind DSL churn hardest and
# serve replicas slowest; campus machines are the nominal baseline; lab /
# server-class machines rarely leave, compute fast, and have fat uplinks.
HOME_DSL = PeerClass("home_dsl", hazard_mult=1.6, speed=0.7, uplink_mult=0.2)
CAMPUS = PeerClass("campus", hazard_mult=1.0, speed=1.0, uplink_mult=1.0)
SERVER_CLASS = PeerClass("server_class", hazard_mult=0.15, speed=2.0,
                         uplink_mult=4.0)


@register_mix("homogeneous")
def homogeneous_mix() -> PeerClassMix:
    """The all-baseline single-class mix (bit-identical to no mix at all)."""
    return PeerClassMix((PeerClass("baseline"),), (1.0,), name="homogeneous")


@register_mix("boinc")
def boinc_mix(home: float = 0.7, campus: float = 0.25,
              server: float = 0.05) -> PeerClassMix:
    """A typical public-project fleet: mostly home DSL hosts, a campus
    contingent, a sliver of lab machines."""
    return PeerClassMix((HOME_DSL, CAMPUS, SERVER_CLASS),
                        (home, campus, server), name="boinc")


@register_mix("campus_cluster")
def campus_cluster_mix(campus: float = 0.8,
                       server: float = 0.2) -> PeerClassMix:
    """An institutional deployment: campus desktops plus lab servers."""
    return PeerClassMix((CAMPUS, SERVER_CLASS), (campus, server),
                        name="campus_cluster")


@register_mix("fast_core_volunteer_tail")
def fast_core_volunteer_tail_mix(core: float = 0.25,
                                 tail: float = 0.75) -> PeerClassMix:
    """Rahman et al.'s deployment shape: a small stable fast core carrying
    a large volatile volunteer tail."""
    return PeerClassMix((SERVER_CLASS, HOME_DSL), (core, tail),
                        name="fast_core_volunteer_tail")


@register_mix("two_class")
def two_class_mix(frac_volatile: float = 0.5, hazard_ratio: float = 4.0,
                  speed_ratio: float = 1.0,
                  uplink_ratio: float = 1.0) -> PeerClassMix:
    """Parametric two-class skew for sweeps: a ``frac_volatile`` share of
    peers churning ``hazard_ratio`` times faster (and ``speed_ratio`` /
    ``uplink_ratio`` times slower/thinner) than the stable remainder."""
    if not 0.0 < frac_volatile < 1.0:
        raise ValueError("frac_volatile must be in (0, 1)")
    if min(hazard_ratio, speed_ratio, uplink_ratio) <= 0:
        raise ValueError("ratios must be positive")
    stable = PeerClass("stable")
    volatile = PeerClass("volatile", hazard_mult=float(hazard_ratio),
                         speed=1.0 / float(speed_ratio),
                         uplink_mult=1.0 / float(uplink_ratio))
    # Every parameter that changes the fleet shows up in the name — sweep
    # CSV rows and regression-gate baseline keys are derived from it, so
    # two distinct configurations must never share a key.
    name = f"two_class_v{frac_volatile:g}_h{hazard_ratio:g}"
    if speed_ratio != 1.0:
        name += f"_s{speed_ratio:g}"
    if uplink_ratio != 1.0:
        name += f"_u{uplink_ratio:g}"
    return PeerClassMix((stable, volatile),
                        (1.0 - frac_volatile, frac_volatile), name=name)
