"""The port's core model against ``repro.core`` on the CPU.

Lambert W, the Eq. 6-11 utilization model, the windowed-MLE estimator and
the adaptive controller, each fed the same inputs (made from numpy seeds)
as the reference.  Tolerances: W0 and Eq. 11 in float64 at 1e-14
relative; the float32 W0 at 2e-6 relative (XLA's and torch's float32
exp/log differ by an ulp or two, and four-plus Halley steps amplify that
by a small factor); estimator and controller decisions bit-identical
(they are pure-Python copies).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive as R_adaptive
from repro.core import failure as R_failure
from repro.core import lambertw as R_lw
from repro_torch.core import adaptive as T_adaptive
from repro_torch.core import failure as T_failure
from repro_torch.core import lambertw as T_lw
from repro_torch.core import utilization as T_util

# repro.core re-exports a function named ``utilization`` over the module.
R_util = importlib.import_module("repro.core.utilization")

_BRANCH = -1.0 / np.e
F64 = torch.float64


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _grid():
    rng = np.random.default_rng(11)
    z = np.concatenate([
        np.linspace(_BRANCH, 0.0, 400),
        np.logspace(-12, 6, 400),
        -np.logspace(-12, np.log10(-_BRANCH), 200)[:-1],
        rng.uniform(_BRANCH, 1e6, 400),
        rng.uniform(_BRANCH, 3.0, 400),
    ])
    return np.clip(z, _BRANCH, 1e6)


def test_lambertw0_f64_matches_reference_numpy():
    z = _grid()
    ref = R_lw.lambertw0_numpy(z)
    got = T_lw.lambertw0(torch.as_tensor(z, dtype=F64)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=0.0)


def test_lambertw0_branch_point_is_exact():
    z = torch.tensor([_BRANCH, _BRANCH - 1e-17, -1.0], dtype=F64)
    np.testing.assert_array_equal(T_lw.lambertw0(z).numpy(), [-1.0] * 3)
    assert R_lw.lambertw0_numpy(np.float64(_BRANCH)) == -1.0


def test_lambertw0_engine_iterations_match_reference_numpy():
    """The engine step runs W0 with 4 Halley iterations."""
    z = _grid()
    ref = R_lw.lambertw0_numpy(z, iters=4)
    got = T_lw.lambertw0(torch.as_tensor(z, dtype=F64), iters=4).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=0.0)


def test_lambertw0_f32_matches_reference_f32():
    z = _grid().astype(np.float32)
    ref = np.asarray(R_lw.lambertw0(jnp.asarray(z, dtype=jnp.float32)))
    got = T_lw.lambertw0(torch.as_tensor(z)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-7)


def test_scalar_solvers_and_cache_are_copies():
    rng = np.random.default_rng(3)
    zs = [float(z) for z in rng.uniform(_BRANCH, 50.0, 64)] + [_BRANCH]
    for z in zs:
        assert T_lw.lambertw0_scalar(z) == R_lw.lambertw0_scalar(z)
    for bits in (None, 12):
        a, b = R_lw.LambertWCache(key_bits=bits), T_lw.LambertWCache(key_bits=bits)
        arr = np.asarray(zs * 2)
        np.testing.assert_array_equal(a.solve_many(arr), b.solve_many(arr))
        assert [a.solve(z) for z in zs] == [b.solve(z) for z in zs]
        assert (a.hits, a.misses) == (b.hits, b.misses)


def test_optimal_interval_matches_reference(x64):
    rng = np.random.default_rng(5)
    mu = rng.uniform(1 / 50000.0, 1 / 500.0, 256)
    k = rng.integers(1, 256, 256).astype(np.float64)
    V = rng.uniform(1.0, 120.0, 256)
    Td = rng.uniform(1.0, 300.0, 256)
    ref = np.asarray(R_util.optimal_interval(jnp.asarray(mu), jnp.asarray(k),
                                             jnp.asarray(V), jnp.asarray(Td)))
    t = lambda a: torch.as_tensor(a, dtype=F64)
    got = T_util.optimal_interval(t(mu), t(k), t(V), t(Td)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-14)
    for i in range(0, 256, 17):
        args = (mu[i], k[i], V[i], Td[i])
        assert (T_util.optimal_interval_scalar(*args)
                == R_util.optimal_interval_scalar(*args))


def test_utilization_model_matches_reference(x64):
    rng = np.random.default_rng(6)
    mu = rng.uniform(1 / 50000.0, 1 / 500.0, 128)
    lam = rng.uniform(1 / 7200.0, 1 / 30.0, 128)
    k, V, Td = 16.0, 20.0, 50.0
    t = lambda a: torch.as_tensor(a, dtype=F64)
    for name in ("expected_cycles_per_failure", "wasted_computation"):
        ref = np.asarray(getattr(R_util, name)(jnp.asarray(mu), k, jnp.asarray(lam)))
        got = getattr(T_util, name)(t(mu), k, t(lam)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-13, err_msg=name)
    for name in ("cycle_overhead", "utilization"):
        ref = np.asarray(getattr(R_util, name)(jnp.asarray(mu), k,
                                               jnp.asarray(lam), V, Td))
        got = getattr(T_util, name)(t(mu), k, t(lam), V, Td).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15,
                                   err_msg=name)
    # lam -> inf: the stable x/expm1(x) forms stay finite.
    assert float(T_util.wasted_computation(1 / 7200.0, k, float("inf"))) == 0.0
    assert float(T_util.cycle_overhead(1 / 7200.0, k, float("inf"), V, Td)) == V


def _event_stream(seed, n=400):
    rng = np.random.default_rng(seed)
    kinds = rng.integers(0, 6, n)
    vals = rng.exponential(3600.0, n)
    return list(zip(kinds.tolist(), vals.tolist()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_decisions_bit_identical(seed, x64):
    kw = dict(k=16, prior_mu=1 / 7200.0, prior_v=20.0, mu_window=32)
    a = R_adaptive.AdaptiveCheckpointController(**kw)
    b = T_adaptive.AdaptiveCheckpointController(**kw)
    now = 0.0
    for kind, v in _event_stream(seed):
        for c in (a, b):
            if kind == 0:
                c.observe_failure(v)
            elif kind == 1:
                c.observe_step(v / 3600.0)
            elif kind == 2:
                c.observe_checkpoint(v / 1800.0)
            elif kind == 3:
                c.observe_restore(v / 60.0)
            elif kind == 4:
                c.tick(now + v)
            else:
                c.ingest_gossip(1.0 / (v + 1.0), 20.0, 50.0, weight=0.25)
        now += v
        assert a.checkpoint_interval() == b.checkpoint_interval()
        assert (a.mu, a.V, a.T_d) == (b.mu, b.V, b.T_d)
    assert a.max_feasible_k() == b.max_feasible_k()
    # The report evaluates the jnp closed form on the reference side.
    assert b.report().interval_star == pytest.approx(
        a.report().interval_star, rel=1e-14)


def test_estimator_bus_and_merge_are_copies():
    rng = np.random.default_rng(9)
    ea = R_failure.FailureRateEstimator(window=8, prior_mu=1e-4)
    eb = T_failure.FailureRateEstimator(window=8, prior_mu=1e-4)
    for x in rng.exponential(500.0, 50):
        ea.observe_failure(float(x)), eb.observe_failure(float(x))
        ea.observe_alive(float(x) / 2), eb.observe_alive(float(x) / 2)
        assert ea.estimate() == eb.estimate()
    est, w = rng.uniform(size=7), rng.uniform(0.1, 1, size=7)
    assert T_failure.gossip_merge(est, w) == R_failure.gossip_merge(est, w)
    ba, bb = R_failure.PiggybackBus(), T_failure.PiggybackBus()
    for i in range(5):
        ba.publish(i, *est[i:i + 3]), bb.publish(i, *est[i:i + 3])
    assert ba.global_estimates() == bb.global_estimates()
    ema_a, ema_b = R_adaptive._Ema(alpha=0.3), T_adaptive._Ema(alpha=0.3)
    for x in est:
        assert ema_a.update(x) == ema_b.update(x)
