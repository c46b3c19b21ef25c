"""One typed policy surface: requests in, checkpoint-interval decisions out
(the port of ``repro/policy.py``).

Every layer that turns failure statistics into an Eq. 11 interval -- the
per-event heap (:mod:`repro_torch.sim.job`), the batched engine, the
workflow executor (:mod:`repro_torch.exec.superstep`) and the policy service
(:mod:`repro_torch.serve.policy_service`) -- shares this module's
vocabulary:

* :class:`PolicyRequest` -- one client's observation batch (failure
  lifetimes, measured checkpoint overheads, restore durations, an optional
  live-tick clock) plus the estimator/clamp knobs, in the canonical
  spellings (``min_interval`` / ``max_interval``; the engine's ``min_iv`` /
  ``max_iv`` survive only as deprecated constructor aliases).
* :class:`PolicyDecision` -- the resulting interval with the estimates it
  was derived from and whether the safety clamps bound.
* :func:`decide` / :func:`apply_request` -- the scalar reference path: fold
  a request into an :class:`~repro_torch.core.adaptive.
  AdaptiveCheckpointController` and read the decision off it.  The
  service's vectorized session state is bit-identical to this path.

Events inside one request fold in a fixed order -- failures, then
checkpoint overheads, then restores, then the tick -- matching how the
underlying estimators are independent (mu / V / T_d touch disjoint state),
so only the within-type order can matter and it is preserved.  The wire
forms (``to_dict`` / ``from_dict``) are the reference's, so a client can
speak to either service.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Tuple

from repro_torch.core.failure import warn_deprecated_alias
from repro_torch.core.utilization import optimal_interval_scalar

_DAY = 24 * 3600.0

__all__ = ["PolicyDecision", "PolicyRequest", "apply_request",
           "controller_for", "decide", "decision_from_controller",
           "warn_deprecated_alias"]


@dataclass(frozen=True)
class PolicyRequest:
    """One client's observation batch + decision query.

    ``failures`` are observed peer lifetimes (seconds, positive);
    ``checkpoint_overheads`` measured V samples; ``restores`` measured
    image-download times (only the last matters — T_d is a last-value
    estimate, Sec 3.1.3).  ``now`` (with optional ``exposure_peers``
    host-equivalents) folds right-censored failure-free exposure exactly
    like :meth:`AdaptiveCheckpointController.tick`.  The remaining fields
    are the controller knobs, canonical spellings only.
    """

    client: str = ""
    k: float = 16.0
    failures: Tuple[float, ...] = ()
    checkpoint_overheads: Tuple[float, ...] = ()
    restores: Tuple[float, ...] = ()
    now: Optional[float] = None
    exposure_peers: Optional[float] = None
    prior_mu: float = 1.0 / (4 * 3600.0)
    prior_v: float = 10.0
    prior_count: int = 4
    window: int = 32
    ema_alpha: float = 0.2
    min_interval: float = 1.0
    max_interval: float = _DAY

    def __post_init__(self) -> None:
        for name in ("failures", "checkpoint_overheads", "restores"):
            object.__setattr__(self, name,
                               tuple(float(x) for x in getattr(self, name)))
        if self.k <= 0:
            raise ValueError("k must be positive")
        if self.window < 1:
            raise ValueError("window must be >= 1")
        if self.prior_mu <= 0:
            raise ValueError("prior_mu must be positive")
        if not 0 < self.min_interval <= self.max_interval:
            raise ValueError("need 0 < min_interval <= max_interval")
        if any(x <= 0 for x in self.failures):
            raise ValueError("failure lifetimes must be positive")
        if self.exposure_peers is not None and self.exposure_peers <= 0:
            raise ValueError("exposure_peers must be positive")

    def to_dict(self) -> dict:
        """JSON-safe wire form (the serve_policy line protocol)."""
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            out[f.name] = list(v) if isinstance(v, tuple) else v
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "PolicyRequest":
        known = {f.name for f in fields(cls)}
        bad = set(d) - known
        if bad:
            raise ValueError(f"unknown PolicyRequest fields: {sorted(bad)}")
        return cls(**d)


@dataclass(frozen=True)
class PolicyDecision:
    """The service/controller answer for one client.

    ``interval`` is the committed 1/lambda* after the safety clamps;
    ``mu``/``V``/``T_d`` the estimates it was computed from;
    ``n_failures`` how many lifetimes the estimator has folded in total;
    ``clamped`` whether [min_interval, max_interval] bound the raw solve.
    """

    interval: float
    mu: float
    V: float
    T_d: float
    n_failures: int = 0
    clamped: bool = False
    client: str = ""

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @classmethod
    def from_dict(cls, d: dict) -> "PolicyDecision":
        return cls(**d)


# --------------------------------------------------------------------------- #
# Scalar reference path (the controller IS the spec)                          #
# --------------------------------------------------------------------------- #

def controller_for(req: PolicyRequest):
    """A fresh controller parameterized exactly as the request asks."""
    from repro_torch.core.adaptive import AdaptiveCheckpointController

    return AdaptiveCheckpointController(
        k=req.k, prior_mu=req.prior_mu, prior_v=req.prior_v,
        mu_window=req.window, ema_alpha=req.ema_alpha,
        min_interval=req.min_interval, max_interval=req.max_interval,
        prior_count=req.prior_count)


def apply_request(ctl, req: PolicyRequest) -> None:
    """Fold one request's events into a controller (canonical order)."""
    for x in req.failures:
        ctl.observe_failure(x)
    for x in req.checkpoint_overheads:
        ctl.observe_checkpoint_overhead(x)
    for x in req.restores:
        ctl.observe_restore(x)
    if req.now is not None:
        ctl.tick(req.now, exposure_peers=req.exposure_peers)


def decision_from_controller(ctl, client: str = "") -> PolicyDecision:
    """Read the current decision off a controller, flagging clamp hits."""
    raw = optimal_interval_scalar(ctl.mu, ctl.k, max(ctl.V, 1e-6), ctl.T_d)
    iv = ctl.checkpoint_interval()
    return PolicyDecision(
        interval=iv, mu=ctl.mu, V=ctl.V, T_d=ctl.T_d,
        n_failures=ctl.n_failures, clamped=iv != raw, client=client)


def decide(req: PolicyRequest) -> PolicyDecision:
    """One-shot scalar decision: the reference for every batched path."""
    ctl = controller_for(req)
    apply_request(ctl, req)
    return decision_from_controller(ctl, client=req.client)
