"""The adaptive checkpoint controller (paper Sec 3 end-to-end).

Wires together the three online estimators (mu, V, T_d — Sec 3.1) and the
utilization-optimal checkpoint rate (Sec 3.2.3).  Fully decentralized in
the paper's sense: on the SPMD runtime every host feeds the controller the
same all-reduced statistics, so each host independently computes the same
lambda* and the checkpoint decision needs no leader.

Two V estimators are provided:

* ``estimate_v_paper`` — Eq. 2 verbatim.  The paper probes the job with and
  without checkpointing for t minutes each and combines the CPU-usage drop
  (P1 -> P2) and message-throughput drop (M1 -> M2):

      V = (P1 - P2)(M1 - M2) t / (2 P1 M1 y)

  NOTE (faithfulness): read as stated this multiplies two relative drops;
  dimensional analysis shows the intended quantity is the *average* of the
  two single-signal estimates, each of the form (drop fraction) * t / y:

      V = [ (P1-P2)/P1 + (M1-M2)/M1 ] / 2 * t / y

  Both readings agree when the two drops are equal; we implement the
  literal formula as ``estimate_v_paper`` and the averaged form as
  ``estimate_v_paper_mean`` and test that they coincide for symmetric
  drops.  The production controller doesn't need the proxy at all — see
  DESIGN.md: a TPU runtime observes step times directly, so V comes from
  the measured inflation of checkpointing steps (``observe_checkpoint``).

* direct measurement — EMA over (checkpoint step time - clean step time).
"""
from __future__ import annotations

from dataclasses import InitVar, dataclass, field
from typing import Optional

from repro_torch.core.failure import FailureRateEstimator
from repro_torch.core.utilization import (
    UtilizationReport,
    optimal_interval_scalar,
    utilization_scalar,
)


def estimate_v_paper(P1: float, P2: float, M1: float, M2: float, t: float, y: int) -> float:
    """Eq. 2, literal: V = (P1-P2)(M1-M2) t / (2 P1 M1 y)."""
    if y <= 0 or P1 <= 0 or M1 <= 0:
        raise ValueError("need y>0 checkpoints and positive baseline P1, M1")
    return (P1 - P2) * (M1 - M2) * t / (2.0 * P1 * M1 * y)


def estimate_v_paper_mean(P1: float, P2: float, M1: float, M2: float, t: float, y: int) -> float:
    """Eq. 2 read as the mean of the CPU-based and IO-based estimates."""
    if y <= 0 or P1 <= 0 or M1 <= 0:
        raise ValueError("need y>0 checkpoints and positive baseline P1, M1")
    v_cpu = (P1 - P2) / P1 * t / y
    v_io = (M1 - M2) / M1 * t / y
    return 0.5 * (v_cpu + v_io)


@dataclass
class _Ema:
    """Exponential moving average with bias-corrected warmup."""

    alpha: float = 0.2
    _value: float = 0.0
    _weight: float = 0.0

    def update(self, x: float) -> float:
        self._value = (1.0 - self.alpha) * self._value + self.alpha * float(x)
        self._weight = (1.0 - self.alpha) * self._weight + self.alpha
        return self.value

    def set(self, x: float) -> None:
        """Overwrite the average with an externally-blended value.

        Used by gossip ingestion: the blend weight was already applied by
        the caller, so the value must land exactly — routing it through
        :meth:`update` would smooth it a second time.
        """
        self._value = float(x)
        self._weight = 1.0

    @property
    def initialized(self) -> bool:
        return self._weight > 0.0

    @property
    def value(self) -> float:
        return self._value / self._weight if self._weight > 0 else 0.0


@dataclass
class AdaptiveCheckpointController:
    """Decides *when to checkpoint* from online estimates (the paper's core).

    Usage pattern (mirrors the trainer loop)::

        ctl = AdaptiveCheckpointController(k=n_nodes, prior_mu=1/8h)
        ...
        ctl.observe_step(step_seconds)              # every step
        ctl.observe_checkpoint(ckpt_step_seconds)   # steps that checkpointed
        ctl.observe_failure(uptime_of_failed_node)  # churn events
        ctl.observe_restore(restore_seconds)        # after restarts
        if ctl.should_checkpoint(seconds_since_last_ckpt):
            save()

    All observe_* inputs are expected to already be globally agreed values
    (all-reduced means) so every host reaches the same decision — the SPMD
    form of the paper's decentralization (DESIGN.md Sec 2).
    """

    k: float  # node count; may be a hazard-weighted host-equivalent sum
    prior_mu: float = 1.0 / (4 * 3600.0)  # 4h node MTBF default
    prior_v: float = 10.0
    mu_window: int = 32
    ema_alpha: float = 0.2
    min_interval: float = 1.0       # safety clamps on 1/lambda*
    max_interval: float = 24 * 3600.0
    prior_count: int = 4            # pseudo-failures backing prior_mu
    # Deprecated engine-cell spellings (repro.policy migration notes).
    min_iv: InitVar[Optional[float]] = None
    max_iv: InitVar[Optional[float]] = None

    mu_est: FailureRateEstimator = field(init=False)
    _clean_step: _Ema = field(init=False)
    _ckpt_overhead: _Ema = field(init=False)
    _t_d: Optional[float] = field(default=None, init=False)
    _cached_interval: Optional[float] = field(default=None, init=False, repr=False)
    n_checkpoints: int = field(default=0, init=False)
    n_failures: int = field(default=0, init=False)
    _exposure_anchor: float = field(default=0.0, init=False, repr=False)
    _anchor_dirty: bool = field(default=False, init=False, repr=False)

    def __post_init__(self, min_iv: Optional[float] = None,
                      max_iv: Optional[float] = None) -> None:
        if min_iv is not None:
            from repro_torch.core.failure import warn_deprecated_alias
            warn_deprecated_alias("min_iv", "min_interval")
            self.min_interval = float(min_iv)
        if max_iv is not None:
            from repro_torch.core.failure import warn_deprecated_alias
            warn_deprecated_alias("max_iv", "max_interval")
            self.max_interval = float(max_iv)
        if self.k <= 0:
            raise ValueError("k (number of nodes) must be positive")
        self.mu_est = FailureRateEstimator(window=self.mu_window, prior_mu=self.prior_mu,
                                           prior_count=self.prior_count)
        self._clean_step = _Ema(alpha=self.ema_alpha)
        self._ckpt_overhead = _Ema(alpha=self.ema_alpha)

    def _invalidate(self) -> None:
        self._cached_interval = None

    # ------------------------------------------------------------------ #
    # Online observations (Sec 3.1)                                      #
    # ------------------------------------------------------------------ #
    def observe_step(self, step_seconds: float) -> None:
        """A training/serving step that did NOT checkpoint."""
        self._clean_step.update(step_seconds)

    def observe_checkpoint(self, step_seconds: float) -> None:
        """A step that included a checkpoint: V = inflation over clean steps."""
        self.n_checkpoints += 1
        if self._clean_step.initialized:
            self._ckpt_overhead.update(max(step_seconds - self._clean_step.value, 0.0))
            self._invalidate()

    def observe_checkpoint_overhead(self, overhead_seconds: float) -> None:
        """Directly measured overhead (e.g. async-save stall time)."""
        self.n_checkpoints += 1
        self._ckpt_overhead.update(max(overhead_seconds, 0.0))
        self._invalidate()

    def observe_failure(self, node_uptime_seconds: float) -> None:
        """A node churn event with the failed node's observed lifetime."""
        self.n_failures += 1
        self.mu_est.observe_failure(node_uptime_seconds)
        self._anchor_dirty = True
        self._invalidate()

    def tick(self, now: float, exposure_peers: Optional[float] = None) -> None:
        """Live-tick path (workflow executor, DESIGN.md Sec 10).

        Between observed failures, ``exposure_peers`` hosts (default: the
        job's k) have survived since the last failure — information the
        windowed MLE would otherwise ignore until the next death.  Each
        tick folds that failure-free exposure in as a single right-censored
        observation ``(now - anchor) * peers``, replacing the previous
        tick's (``reset_censored``) so the censored mass never double
        counts; the anchor re-arms at the first tick after a failure.
        The estimate therefore *decays* toward lower mu while the fleet is
        quiet and snaps back on the next observed inter-arrival — ticking
        on observed failure inter-arrivals rather than on a modeled rate.

        ``exposure_peers`` may be fractional: a heterogeneous fleet folds
        hazard-weighted *host-equivalents* (sum of class hazard mults over
        the watched slots) so the censored mass pairs with observations
        emitted in baseline-hazard-equivalent seconds.  A whole-number
        float is bit-identical to the old integer path.
        """
        n = float(self.k) if exposure_peers is None else float(exposure_peers)
        if n <= 0:
            raise ValueError("exposure_peers must be positive")
        if self._anchor_dirty or now < self._exposure_anchor:
            # First tick after a failure (or a clock reset — a new job
            # incarnation resuming from a checkpoint restarts at t=0).
            self._exposure_anchor = now
            self._anchor_dirty = False
            self.mu_est.reset_censored()
            self._invalidate()
            return
        if now > self._exposure_anchor:
            self.mu_est.reset_censored()
            self.mu_est.observe_alive((now - self._exposure_anchor) * n)
            self._invalidate()

    def observe_restore(self, restore_seconds: float) -> None:
        """Measured restore (image download) time — refines T_d (Sec 3.1.3)."""
        self._t_d = float(restore_seconds)
        self._invalidate()

    def ingest_gossip(self, mu: float, V: float, T_d: float, weight: float = 0.5) -> None:
        """Blend piggybacked global estimates into local ones (Sec 3.1.4).

        ``weight`` is the share given to the remote/global value.  The SPMD
        trainer all-reduces the scalars and calls this with weight=1 so all
        hosts share identical state.
        """
        if not 0.0 <= weight <= 1.0:
            raise ValueError("weight must be in [0, 1]")
        local_mu = self.mu
        merged_mu = (1 - weight) * local_mu + weight * mu
        # Re-seed the estimator so subsequent local observations keep moving it.
        self.mu_est = FailureRateEstimator(window=self.mu_window, prior_mu=merged_mu,
                                           prior_count=self.prior_count)
        if V > 0:
            # The blend is applied here once; _Ema.set stores it verbatim
            # (update() would EMA-damp the already-blended value, skewing
            # every ingest toward the stale local estimate).
            self._ckpt_overhead.set(V if not self._ckpt_overhead.initialized
                                    else (1 - weight) * self._ckpt_overhead.value + weight * V)
        if T_d > 0:
            self._t_d = (1 - weight) * (self._t_d if self._t_d is not None else T_d) + weight * T_d
        self._invalidate()

    # ------------------------------------------------------------------ #
    # Current estimates                                                  #
    # ------------------------------------------------------------------ #
    @property
    def mu(self) -> float:
        return self.mu_est.estimate()

    @property
    def V(self) -> float:
        return self._ckpt_overhead.value if self._ckpt_overhead.initialized else self.prior_v

    @property
    def T_d(self) -> float:
        # Sec 3.1.3: initialized to V until a real download/restore is seen.
        return self._t_d if self._t_d is not None else self.V

    # ------------------------------------------------------------------ #
    # Decisions (Sec 3.2)                                                #
    # ------------------------------------------------------------------ #
    def checkpoint_interval(self) -> float:
        """1/lambda* under current estimates, safety-clamped (cached)."""
        if self._cached_interval is None:
            iv = optimal_interval_scalar(self.mu, self.k, max(self.V, 1e-6), self.T_d)
            self._cached_interval = min(max(iv, self.min_interval), self.max_interval)
        return self._cached_interval

    def should_checkpoint(self, seconds_since_last: float) -> bool:
        return seconds_since_last >= self.checkpoint_interval()

    def utilization_at_optimum(self) -> float:
        lam = 1.0 / optimal_interval_scalar(self.mu, self.k, max(self.V, 1e-6), self.T_d)
        return utilization_scalar(self.mu, self.k, lam, max(self.V, 1e-6), self.T_d)

    def feasible(self, k: Optional[int] = None) -> bool:
        """Paper's U>0 test, optionally for a hypothetical fleet size k."""
        k = self.k if k is None else k
        lam = 1.0 / optimal_interval_scalar(self.mu, k, max(self.V, 1e-6), self.T_d)
        return utilization_scalar(self.mu, k, lam, max(self.V, 1e-6), self.T_d) > 0.0

    def max_feasible_k(self, k_max: int = 1 << 20) -> int:
        """Largest fleet size that still makes progress (binary search on U>0)."""
        if not self.feasible(1):
            return 0
        lo, hi = 1, 1
        while hi < k_max and self.feasible(hi * 2):
            hi *= 2
        hi = min(hi * 2, k_max)
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.feasible(mid):
                lo = mid
            else:
                hi = mid - 1
        return lo

    def report(self) -> UtilizationReport:
        return UtilizationReport.evaluate(self.mu, self.k, max(self.V, 1e-6), self.T_d)
