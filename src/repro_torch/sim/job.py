"""Message-passing job simulation with checkpoint/rollback (paper Sec 4.1):
the per-event heap oracle, a numpy copy of ``repro/sim/job.py`` on the
port's own core, network and store modules (no JAX).  On the same seeds it
gives the reference's results bit for bit.

The job occupies slots [0, k) of a :class:`ChurnNetwork`.  It alternates
work cycles and checkpoints; any churn event among its k slots is a job
failure: the job rolls back to the last completed checkpoint and pays the
image-download time T_d before resuming (Fig. 3 timeline).

Policies decide the next checkpoint interval:

* :class:`FixedIntervalPolicy` — the naive baseline of [16].
* :class:`AdaptivePolicy` — the paper's scheme: an
  :class:`AdaptiveCheckpointController` fed by the observation stream of a
  neighbourhood watcher (slots [0, watch) — 'each peer monitors its
  neighbours and the neighbours of its neighbours', Sec 3.1.1), measured
  checkpoint overheads, and measured restore times.  One pooled controller
  = perfect information sharing among the job's peers.
* :class:`GossipAdaptivePolicy` — the decentralization actually claimed by
  the paper (Sec 3.1.4): one controller PER PEER, each fed only its own
  slice of the watch neighbourhood, optionally exchanging estimates by
  gossip.  The per-event parity oracle for the batched engine's estimator
  regimes.
* :class:`OraclePolicy` — beyond-paper upper bound: computes lambda* from
  the *true* mu(t) (no estimation error), safety-clamped exactly like the
  adaptive controller so comparisons measure estimation quality, not
  clipping.
"""
from __future__ import annotations

from dataclasses import InitVar, dataclass, field
from typing import TYPE_CHECKING, List, Optional, Protocol

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - annotation only, avoids import cost
    from repro_torch.p2p.store import P2PCheckpointStore

from repro_torch.core.adaptive import AdaptiveCheckpointController
from repro_torch.core.failure import warn_deprecated_alias
from repro_torch.core.utilization import optimal_interval_scalar
from repro_torch.sim.network import ChurnNetwork, MtbfFn


class CheckpointPolicy(Protocol):
    def tick(self, now: float, exposure_peers: Optional[float] = None) -> None: ...
    def interval(self) -> float: ...
    def on_checkpoint(self, overhead: float) -> None: ...
    def on_restore(self, downtime: float) -> None: ...
    def on_observation(self, lifetime: float) -> None: ...


@dataclass
class FixedIntervalPolicy:
    """The naive baseline: user-chosen constant interval (Sec 1.2.2)."""

    T: float

    def tick(self, now: float,
             exposure_peers: Optional[float] = None) -> None:  # pragma: no cover - noop
        pass

    def interval(self) -> float:
        return self.T

    def on_checkpoint(self, overhead: float) -> None:  # pragma: no cover - noop
        pass

    def on_restore(self, downtime: float) -> None:  # pragma: no cover - noop
        pass

    def on_observation(self, lifetime: float) -> None:  # pragma: no cover - noop
        pass


@dataclass
class AdaptivePolicy:
    """The paper's adaptive scheme driving the simulated job."""

    controller: AdaptiveCheckpointController

    def tick(self, now: float,
             exposure_peers: Optional[float] = None) -> None:  # pragma: no cover - noop
        # Deliberately a no-op: the heap delivers right-censored exposure
        # through its own death stream; the live-tick path is the
        # executor's (repro.policy migration notes).
        pass

    def interval(self) -> float:
        return self.controller.checkpoint_interval()

    def on_checkpoint(self, overhead: float) -> None:
        self.controller.observe_checkpoint_overhead(overhead)

    def on_restore(self, downtime: float) -> None:
        self.controller.observe_restore(downtime)

    def on_observation(self, lifetime: float) -> None:
        self.controller.observe_failure(lifetime)


@dataclass
class GossipAdaptivePolicy:
    """Per-peer estimator regimes for the heap simulator (paper Sec 3.1.4).

    Each of the job's k peers runs its OWN
    :class:`AdaptiveCheckpointController`, fed only by deaths in its share
    of the watch neighbourhood (slot % k — each peer monitors ~watch/k
    slots).  ``regime="isolated"`` never exchanges estimates;
    ``regime="gossip"`` makes every peer pull the mu estimates of
    ``fanout`` ring neighbours every ``period`` seconds — the
    deterministic cyclic schedule offset 1 + (round*fanout + f) mod (k-1),
    identical to the batched engine's circulant mixing — and blend them
    via :meth:`AdaptiveCheckpointController.ingest_gossip` with
    ``weight``.  Only mu is exchanged: checkpoint overheads and restore
    durations are job-level stalls every peer observes identically, so
    blending them could only inject prior-seeded noise.  The job's
    checkpoint decisions are peer 0's (the engine's decision-peer mirror).
    """

    controllers: List[AdaptiveCheckpointController]
    regime: str = "isolated"  # "isolated" | "gossip"
    period: float = 600.0
    fanout: int = 2
    weight: float = 0.5
    _next_gossip: float = field(default=0.0, init=False)
    _round: int = field(default=0, init=False)

    def __post_init__(self) -> None:
        if self.regime not in ("isolated", "gossip"):
            raise ValueError(f"unknown regime {self.regime!r}")
        if not self.controllers:
            raise ValueError("need at least one per-peer controller")
        if self.period <= 0 or self.fanout < 1:
            raise ValueError("period must be positive and fanout >= 1")
        self._next_gossip = self.period

    @classmethod
    def make(cls, k: int, *, regime: str = "isolated", period: float = 600.0,
             fanout: int = 2, weight: float = 0.5,
             **controller_kw) -> "GossipAdaptivePolicy":
        """k per-peer controllers, each sized for the k-peer job."""
        return cls(controllers=[AdaptiveCheckpointController(k=k, **controller_kw)
                                for _ in range(k)],
                   regime=regime, period=period, fanout=fanout, weight=weight)

    def tick(self, now: float, exposure_peers: Optional[float] = None) -> None:
        # At most one exchange round per tick (ticks come once per cycle),
        # then re-arm relative to now — matching the engine, which gossips
        # at most once per attempt step.
        if self.regime == "gossip" and now >= self._next_gossip:
            self._mix()
            self._round += 1
            self._next_gossip = now + self.period

    def _mix(self) -> None:
        k = len(self.controllers)
        if k < 2:
            return
        mus = [c.mu for c in self.controllers]
        for i, c in enumerate(self.controllers):
            picks = [(i + 1 + (self._round * self.fanout + f) % (k - 1)) % k
                     for f in range(self.fanout)]
            # Only mu is exchanged (V/T_d are job-level stalls every peer
            # observes identically, and the engine mixes only mu);
            # non-positive values make ingest_gossip skip the V/T_d blend,
            # which would otherwise materialize prior-seeded estimates.
            c.ingest_gossip(float(np.mean([mus[j] for j in picks])),
                            0.0, 0.0, weight=self.weight)

    def interval(self) -> float:
        return self.controllers[0].checkpoint_interval()

    def on_checkpoint(self, overhead: float) -> None:
        for c in self.controllers:
            c.observe_checkpoint_overhead(overhead)

    def on_restore(self, downtime: float) -> None:
        for c in self.controllers:
            c.observe_restore(downtime)

    def on_observation(self, lifetime: float) -> None:
        # Slotless fallback (legacy callers): feed the decision peer.
        self.controllers[0].observe_failure(lifetime)

    def on_observation_slot(self, slot: int, lifetime: float) -> None:
        """A watched slot died: only its assigned peer observes it."""
        self.controllers[slot % len(self.controllers)].observe_failure(lifetime)


@dataclass
class OraclePolicy:
    """lambda* from the TRUE network parameters (estimation-error-free).

    Clamped to the same ``[min_interval, max_interval]`` band as
    :class:`AdaptiveCheckpointController`, so adaptive-vs-oracle gaps
    measure estimation quality rather than the clipping asymmetry.

    ``shock_rate_per_peer`` folds a correlated-churn shock process into
    the oracle's truth (DESIGN.md Sec 8): the job-killing shock epochs are
    Poisson with rate ``shock.rate * shock.job_kill_prob(n_scope)``, i.e.
    ``shock.rate * shock.job_kill_prob(n_scope) / k`` per peer — the same
    effective rate the batched engine's oracle cells use.  0.0 (the
    default) is the shock-free oracle, unchanged.
    """

    k: int
    V: float
    T_d: float
    mtbf_fn: MtbfFn
    min_interval: float = 1.0
    max_interval: float = 24 * 3600.0
    shock_rate_per_peer: float = 0.0
    _now: float = 0.0
    # Deprecated cell-spelling aliases (repro.policy migration notes).
    min_iv: InitVar[Optional[float]] = None
    max_iv: InitVar[Optional[float]] = None

    def __post_init__(self, min_iv: Optional[float] = None,
                      max_iv: Optional[float] = None) -> None:
        if min_iv is not None:
            warn_deprecated_alias("min_iv", "min_interval")
            self.min_interval = float(min_iv)
        if max_iv is not None:
            warn_deprecated_alias("max_iv", "max_interval")
            self.max_interval = float(max_iv)

    def interval(self) -> float:
        mu = 1.0 / self.mtbf_fn(self._now) + self.shock_rate_per_peer
        iv = optimal_interval_scalar(mu, self.k, self.V, self.T_d)
        return min(max(iv, self.min_interval), self.max_interval)

    def on_checkpoint(self, overhead: float) -> None:
        pass

    def on_restore(self, downtime: float) -> None:
        pass

    def on_observation(self, lifetime: float) -> None:
        pass

    def tick(self, now: float, exposure_peers: Optional[float] = None) -> None:
        self._now = now


@dataclass(frozen=True)
class SimResult:
    wall_time: float        # total wall-clock time to completion
    work_required: float    # fault-free runtime of the job
    n_checkpoints: int
    n_failures: int
    wasted_work: float      # wall time lost to failed cycles (rollback)
    checkpoint_time: float  # seconds spent checkpointing
    restore_time: float     # seconds spent downloading images
    completed: bool = True  # False => censored at wall_time (job livelocked)
    server_bytes: float = 0.0     # I/O imposed on the work-pool server
    n_server_restores: int = 0    # restores served by the server fallback
    n_peer_restores: int = 0      # restores served from peer replicas

    @property
    def overhead(self) -> float:
        return self.wall_time - self.work_required

    @property
    def utilization(self) -> float:
        return self.work_required / self.wall_time


def simulate_job(
    *,
    network: ChurnNetwork,
    policy: CheckpointPolicy,
    k: int,
    work_required: float,
    V: float,
    T_d: float,
    watch: Optional[int] = None,
    max_wall_time: float = float("inf"),
    store: Optional["P2PCheckpointStore"] = None,
    speed: float = 1.0,
) -> SimResult:
    """Run one job to completion under churn.

    ``watch`` is the neighbourhood size whose deaths feed the policy's
    observation stream (defaults to min(4k, n_slots) — k job peers plus
    their neighbours).  Deaths of slots >= watch are invisible to the
    policy but slots < k always cause job failure.

    ``speed`` is the job's aggregate compute speed (work units per wall
    second — e.g. :meth:`repro_torch.sim.scenarios.PeerClassMix.mean_speed`
    over the k job slots).  A policy interval is wall time; the work it commits
    is ``interval * speed``, mirroring the batched engine's speed column.
    The reported ``work_required`` is the fault-free wall runtime
    ``work_required / speed``.

    ``store`` (a :class:`repro_torch.p2p.store.P2PCheckpointStore`) makes
    the restore time *endogenous*: each restore attempt reads the store's
    surviving replica count at that instant — individual holder deaths and
    repairs evolve per event — and pays the resulting transfer time, falling back
    to the work-pool server when every replica is lost.  ``T_d`` is then
    ignored.  This is the per-replica parity oracle for the batched
    engine's closed-form availability law (DESIGN.md Sec 6).
    """
    if k > network.n_slots:
        raise ValueError(f"job needs {k} slots but network has {network.n_slots}")
    if speed <= 0:
        raise ValueError("speed must be positive")
    watch = min(4 * k, network.n_slots) if watch is None else min(watch, network.n_slots)

    t = 0.0                # wall clock
    done = 0.0             # committed (checkpointed) work
    n_ckpt = 0
    n_fail = 0
    wasted = 0.0
    ckpt_time = 0.0
    restore_time = 0.0

    # Policies carrying per-peer estimators (GossipAdaptivePolicy) need to
    # know WHICH watched slot died to route the observation; plain policies
    # keep the lifetime-only protocol method.
    observe_slot = getattr(policy, "on_observation_slot", None)

    def drain_observations(t_end: float) -> Optional[float]:
        """Deliver deaths up to t_end to the policy.

        Returns the time of the first *job* failure (slot < k) in the
        window, or None.  Observation deaths (slot < watch) feed the
        estimator even when they are not job failures.
        """
        nonlocal n_fail
        for ev in network.deaths_until(t_end):
            if ev.slot < watch:
                if observe_slot is not None:
                    observe_slot(ev.slot, ev.lifetime)
                else:
                    policy.on_observation(ev.lifetime)
            if ev.slot < k:
                return ev.time
        return None

    def store_stats() -> dict:
        if store is None:
            return {}
        return dict(server_bytes=store.server_bytes,
                    n_server_restores=store.n_server_restores,
                    n_peer_restores=store.n_peer_restores)

    while done < work_required:
        if t > max_wall_time:
            # Censored: the job is livelocked (the paper's 'keep rolling back
            # to the same saved status again and again', Sec 4.2).  Report
            # the censored wall time — a LOWER BOUND on the true runtime.
            return SimResult(
                wall_time=t, work_required=work_required / speed,
                n_checkpoints=n_ckpt,
                n_failures=n_fail, wasted_work=wasted, checkpoint_time=ckpt_time,
                restore_time=restore_time, completed=False, **store_stats(),
            )
        policy.tick(t)
        interval = max(policy.interval(), 1e-3)
        # The policy interval is wall time; at `speed` work units per wall
        # second it commits interval * speed work (both exactly the
        # homogeneous values when speed == 1).
        work_target = min(interval * speed, work_required - done)
        # The cycle: work_target/speed seconds of compute, then (if not
        # finished) V seconds of checkpoint.  A failure anywhere in the
        # cycle rolls back to `done`.
        is_final = (done + work_target) >= work_required
        cycle_len = work_target / speed + (0.0 if is_final else V)
        fail_at = drain_observations(t + cycle_len)
        if fail_at is None:
            # Cycle completed.
            t += cycle_len
            if is_final:
                done = work_required
            else:
                done += work_target
                n_ckpt += 1
                ckpt_time += V
                policy.on_checkpoint(V)
                if store is not None:
                    store.commit_checkpoint()
        else:
            # Job failure mid-cycle: lose the whole cycle so far (uncommitted
            # compute plus any in-progress checkpoint time), pay restore.
            wasted += max(0.0, fail_at - t)
            n_fail += 1
            t = fail_at
            # Restore: download image (T_d exogenous, or read from the P2P
            # store's surviving replicas); churn during restore forces a
            # retry, re-reading the replica set at the new start time.
            while True:
                if t > max_wall_time:
                    # Censor INSIDE the retry loop too: under heavy or
                    # correlated churn (shock epochs faster than the
                    # restore time) the expected number of retries grows
                    # like exp(rate * T_d), and a job can burn essentially
                    # unbounded simulated time without ever reaching the
                    # work-loop censor check above.  Interrupted attempts
                    # were already billed per attempt (abort_restore), so
                    # the censored lower-bound result is fully accounted.
                    return SimResult(
                        wall_time=t, work_required=work_required / speed,
                        n_checkpoints=n_ckpt, n_failures=n_fail,
                        wasted_work=wasted, checkpoint_time=ckpt_time,
                        restore_time=restore_time, completed=False,
                        **store_stats(),
                    )
                td = T_d if store is None else store.restore_seconds_at(t)
                fail_in_restore = drain_observations(t + td)
                if fail_in_restore is None:
                    t += td
                    restore_time += td
                    if store is not None:
                        store.commit_restore()
                    break
                restore_time += fail_in_restore - t
                if store is not None:
                    # The interrupted attempt still moved (elapsed/td) of
                    # the image — billed per attempt, matching the engine.
                    store.abort_restore(fail_in_restore - t)
                t = fail_in_restore
            policy.on_restore(td)

    return SimResult(
        wall_time=t,
        work_required=work_required / speed,
        n_checkpoints=n_ckpt,
        n_failures=n_fail,
        wasted_work=wasted,
        checkpoint_time=ckpt_time,
        restore_time=restore_time,
        **store_stats(),
    )
