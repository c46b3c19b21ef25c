"""Runtime-utilization model of the paper (Section 3.2) + baselines.

All formulas carry paper equation numbers.  The model treats the execution
as cycles of length 1/lambda; each cycle pays the checkpoint overhead V and,
amortized, the restart costs (wasted computation T_wc + image download T_d)
of the failures expected per c-bar successful cycles.

Variables (Table 1):
    mu       peer (node) failure rate — exponential lifetimes
    k        number of peers (nodes) in the job
    lam      checkpoint rate; the interval is 1/lam
    V        checkpoint overhead (extra runtime per checkpoint)
    T_d      checkpoint image download (restore) overhead
    T_wc     expected wasted computation per failure
    c_bar    expected fault-free cycles per failure
    U        average cycle utilization

The array forms are torch (float64 unless the caller passes float32
tensors) and mirror ``repro.core.utilization``; the scalar forms are the
reference's pure-Python fast paths, copied.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.lambertw import lambertw0

_E = math.e


def _t(x):
    """Tensors pass through; Python numbers become float64 tensors."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.float64)


def job_failure_rate(mu, k):
    """Eq. 7: k peers, each exponential(mu) => job fails at rate k*mu."""
    return k * mu


def expected_cycles_per_failure(mu, k, lam):
    """c-bar' (Eq. 6 / Sec 3.2.2): expected complete cycles before a failure.

    c_bar = 1 / (e^{k mu / lam} - 1)
    """
    x = _t(job_failure_rate(mu, k) / lam)
    return 1.0 / torch.expm1(x)


def _x_over_expm1(x):
    """x / expm1(x) with its x -> 0 limit (1 - x/2) taken explicitly.

    The naive quotient is 0/0 at x = 0 (lam* = inf at the V -> 0 branch
    point); the double-where keeps the NaN from ever being formed."""
    x = _t(x)
    safe = torch.where(x > 1e-6, x, 1.0)
    return torch.where(x > 1e-6, safe / torch.expm1(safe), 1.0 - 0.5 * x)


def wasted_computation(mu, k, lam):
    """T'_wc (Eq. 8): expected computation lost per failure.

    T_wc = 1/(k mu) - c_bar / lam = (1 - x/expm1(x)) / (k mu),  x = k mu / lam

    The second form is the one computed: it stays finite (-> 0) as
    lam -> inf, where the first is inf/inf.
    """
    kmu = job_failure_rate(mu, k)
    return (1.0 - _x_over_expm1(kmu / lam)) / kmu


def cycle_overhead(mu, k, lam, V, T_d):
    """C (Eq. 9): average overhead + failure cost per cycle.

    C = V + (T_wc + T_d) / c_bar = V + (T_wc + T_d) * expm1(k mu / lam)

    Multiplying by 1/c_bar = expm1(x) directly keeps C finite (-> V) as
    lam -> inf instead of dividing by an inf c_bar.
    """
    x = _t(job_failure_rate(mu, k) / lam)
    return V + (wasted_computation(mu, k, lam) + T_d) * torch.expm1(x)


def utilization(mu, k, lam, V, T_d):
    """U (Eq. 10): fraction of each cycle doing useful work, clamped to 0."""
    C = cycle_overhead(mu, k, lam, V, T_d)
    return torch.clamp_min(_t(1.0 - C * lam), 0.0)


def optimal_lambda(mu, k, V, T_d):
    """The paper's closed form (Sec 3.2.3):

        lam* = k mu / ( W0[ (V k mu - T_d k mu - 1) (T_d k mu + 1)^{-1} e^{-1} ] + 1 )

    Derivation check (dU/dlam = 0 with x = k mu / lam):
        (x - 1) e^x = (V k mu - T_d k mu - 1) / (T_d k mu + 1)
        => x = W0[ RHS * e^{-1} ] + 1.

    V == 0 maps to the branch point (x = 0, lam* = inf): free checkpoints
    mean checkpoint continuously; callers should keep V > 0.
    """
    kmu = _t(job_failure_rate(mu, k))
    arg = (V * kmu - T_d * kmu - 1.0) / (T_d * kmu + 1.0) / torch.as_tensor(
        _E, dtype=kmu.dtype, device=kmu.device)
    x = lambertw0(arg) + 1.0
    return kmu / x


def optimal_interval(mu, k, V, T_d):
    """Convenience: the optimal checkpoint interval 1/lam*."""
    return 1.0 / optimal_lambda(mu, k, V, T_d)


def optimal_interval_scalar(mu: float, k: float, V: float, T_d: float,
                            cache=None) -> float:
    """Pure-Python scalar fast path of :func:`optimal_interval`.

    The runtime controller and the discrete-event simulator evaluate this
    inside tight loops where per-call tensor dispatch dominates; tests hold it
    to the torch closed form.

    The W0 solve routes through a :class:`repro.core.lambertw.LambertWCache`
    — ``cache`` if given, else the process-wide *exact* default cache, which
    is bitwise-transparent (it can only return what ``lambertw0_scalar``
    would) so every historical caller is unchanged to the last ulp while
    repeated solves at unchanged estimates become dict lookups.
    """
    from repro_torch.core.lambertw import default_cache

    kmu = float(k) * float(mu)
    arg = (V * kmu - T_d * kmu - 1.0) / (T_d * kmu + 1.0) / _E
    x = (cache if cache is not None else default_cache()).solve(arg) + 1.0
    if x <= 0.0:
        return float("inf")  # branch point: V == 0, checkpoint continuously
    return x / kmu


def utilization_scalar(mu: float, k: float, lam: float, V: float, T_d: float) -> float:
    """Pure-Python scalar fast path of :func:`utilization` (Eq. 10)."""
    kmu = float(k) * float(mu)
    c_bar = 1.0 / math.expm1(kmu / lam)
    t_wc = 1.0 / kmu - c_bar / lam
    C = V + (t_wc + T_d) / c_bar
    return max(0.0, 1.0 - C * lam)


def feasible(mu, k, V, T_d) -> torch.Tensor:
    """Paper's U=0 test: can a k-node job make progress at all?

    Evaluated at the optimal lambda; used by the elastic runtime to gate
    scale-up decisions (Sec 3.2.3, last paragraph).
    """
    lam = optimal_lambda(mu, k, V, T_d)
    return utilization(mu, k, lam, V, T_d) > 0.0


# ---------------------------------------------------------------------------
# Baselines (beyond-paper, for comparison in tests/benchmarks).
# ---------------------------------------------------------------------------

def young_interval(mu, k, V):
    """Young (1974) first-order optimum: T = sqrt(2 V MTBF), MTBF = 1/(k mu)."""
    return torch.sqrt(_t(2.0 * V / job_failure_rate(mu, k)))


def daly_interval(mu, k, V):
    """Daly (2006) higher-order approximation of the optimal interval."""
    M = _t(1.0 / job_failure_rate(mu, k))
    t = torch.sqrt(2.0 * V * M)
    # Daly's refinement, valid for V < 2M.
    refined = t * (1.0 + (1.0 / 3.0) * torch.sqrt(V / (2.0 * M)) + (V / (9.0 * 2.0 * M))) - V
    return torch.where(V < 2.0 * M, refined, M)


@dataclass(frozen=True)
class UtilizationReport:
    """Snapshot of the model at given conditions — used by logs & tests."""

    mu: float
    k: int
    V: float
    T_d: float
    lam_star: float
    interval_star: float
    U_star: float
    feasible: bool

    @classmethod
    def evaluate(cls, mu: float, k: int, V: float, T_d: float) -> "UtilizationReport":
        lam = float(optimal_lambda(mu, k, V, T_d))
        u = float(utilization(mu, k, lam, V, T_d))
        return cls(
            mu=float(mu), k=int(k), V=float(V), T_d=float(T_d),
            lam_star=lam, interval_star=1.0 / lam, U_star=u, feasible=u > 0.0,
        )
