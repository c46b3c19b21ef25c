"""Failure modelling and online failure-rate estimation (paper Sec 3.1.1).

The paper models peer lifetimes as exponential(mu) (validated against
Gnutella/Overnet/BitTorrent traces, Fig. 2) and estimates mu with the
Maximum-Likelihood estimator over the last K observed failures:

    mu_hat = K / sum_i t_l,i                                   (Eq. 1)

i.e. the reciprocal of the mean observed lifetime.  Estimates are shared
cooperatively: each node piggybacks its most recent (mu, V, T_d) estimate on
messages it already sends, and receivers average the values (Sec 3.1.4).

On a TPU cluster the same machinery estimates the per-node failure rate
from observed inter-failure times (preemptions, crashes, maintenance).  The
window K keeps the estimator responsive to non-stationary churn (the
paper's Fig. 4 right: failure rate doubling over 20h).
"""
from __future__ import annotations

import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Iterable, Optional, Sequence

import numpy as np


def exponential_lifetimes(rng: np.random.Generator, mu: float, size) -> np.ndarray:
    """Sample peer lifetimes t ~ Exp(mu) (mean 1/mu)."""
    return rng.exponential(scale=1.0 / mu, size=size)


def mle_failure_rate(lifetimes: Sequence[float]) -> float:
    """Eq. 1: mu_hat = K / sum(t_i).  Requires at least one observation."""
    lifetimes = np.asarray(lifetimes, dtype=np.float64)
    if lifetimes.size == 0:
        raise ValueError("MLE failure-rate estimate requires >= 1 observed lifetime")
    total = float(lifetimes.sum())
    if total <= 0.0:
        raise ValueError("observed lifetimes must be positive")
    return lifetimes.size / total


@dataclass
class FailureRateEstimator:
    """Windowed MLE estimator of mu (Eq. 1) with censored-observation support.

    ``window`` is the paper's K: the number of most recent failures used to
    compute a fresh estimate.  ``observe_alive`` records right-censored
    lifetimes (nodes still up) — the standard exponential MLE then divides
    the number of *failures* by the *total* observed time, which remains
    unbiased and lets a node fold in "my neighbours have been up for H
    hours" knowledge without waiting for them to die (a beyond-paper
    refinement; with no censored data it reduces exactly to Eq. 1).
    """

    window: int = 32
    prior_mu: Optional[float] = None  # used before the first observation
    # The paper recomputes the estimate per K observed failures (Sec 3.1.1)
    # — a single unlucky lifetime must not override a calm prior.  The
    # prior enters as ``prior_count`` pseudo-failures at rate prior_mu
    # (Gamma-conjugate smoothing); real observations dominate once
    # n >> prior_count.
    prior_count: int = 4
    _lifetimes: Deque[float] = field(default_factory=deque, repr=False)
    _censored: Deque[float] = field(default_factory=deque, repr=False)

    def observe_failure(self, lifetime: float) -> None:
        if lifetime <= 0:
            raise ValueError(f"lifetime must be positive, got {lifetime}")
        self._lifetimes.append(float(lifetime))
        while len(self._lifetimes) > self.window:
            self._lifetimes.popleft()

    def observe_alive(self, uptime_so_far: float) -> None:
        if uptime_so_far <= 0:
            return
        self._censored.append(float(uptime_so_far))
        while len(self._censored) > self.window:
            self._censored.popleft()

    @property
    def n_observations(self) -> int:
        return len(self._lifetimes)

    def estimate(self) -> float:
        """Current mu_hat; blends ``prior_mu`` as pseudo-observations."""
        k = len(self._lifetimes)
        if k == 0:
            if self.prior_mu is None:
                raise ValueError("no failures observed and no prior_mu set")
            return self.prior_mu
        total = sum(self._lifetimes) + sum(self._censored)
        if self.prior_mu is not None and self.prior_count > 0:
            k += self.prior_count
            total += self.prior_count / self.prior_mu
        return k / total

    def reset_censored(self) -> None:
        self._censored.clear()


def gossip_merge(estimates: Iterable[float], weights: Optional[Sequence[float]] = None) -> float:
    """Sec 3.1.4: global estimate as the average of piggybacked local ones.

    The paper averages peers' local estimates to avoid the global checkpoint
    rate being dictated by the single smallest local mu_hat.  On the SPMD
    runtime this is one entry in the metrics all-reduce (mean).
    """
    est = np.asarray(list(estimates), dtype=np.float64)
    if est.size == 0:
        raise ValueError("gossip_merge needs at least one estimate")
    if weights is None:
        return float(est.mean())
    w = np.asarray(list(weights), dtype=np.float64)
    if w.shape != est.shape or w.sum() <= 0:
        raise ValueError("weights must match estimates and sum > 0")
    return float((est * w).sum() / w.sum())


@dataclass
class PiggybackBus:
    """In-process stand-in for the paper's piggyback channel.

    Each node publishes its latest (mu, V, T_d) tuple; readers take the
    average (gossip_merge).  In the distributed runtime this is replaced by
    folding the three scalars into the existing metrics all-reduce — zero
    extra messages, matching the paper's 'no extra message' property.
    """

    _published: dict = field(default_factory=dict)

    def publish(self, node_id: int, mu: float, V: float, T_d: float) -> None:
        self._published[node_id] = (float(mu), float(V), float(T_d))

    def global_estimates(self) -> tuple:
        if not self._published:
            raise ValueError("no estimates published")
        vals = np.asarray(list(self._published.values()), dtype=np.float64)
        return tuple(vals.mean(axis=0))

    def __len__(self) -> int:
        return len(self._published)


def warn_deprecated_alias(old: str, new: str) -> None:
    """Emit the standard alias warning (engine/controller shims)."""
    warnings.warn(
        f"{old}= is deprecated; use the canonical {new}= "
        f"(see repro.policy migration notes)",
        DeprecationWarning, stacklevel=3)
