"""The port's per-event heap oracle (``repro_torch.sim.job``) against
``repro.sim.job`` on the CPU.

``simulate_job`` and its policies are numpy host code on both sides, fed
the same seeds: every ``SimResult`` field must be equal bit for bit, for
each policy (fixed, adaptive, gossip and isolated per-peer controllers,
oracle with and without a shock rate), with a P2P checkpoint store, a
job speed other than 1, a heavy-tailed ``lifetime_sampler`` scenario, a
heterogeneous shocked fleet, and a censored run.  ``compare`` and
``compare_grid`` with ``engine="reference"`` must give the reference's
comparisons.
"""
import dataclasses
import types
import warnings

import numpy as np
import pytest

import repro.core.adaptive as R_adaptive
import repro.p2p as R_p2p
import repro.sim as R_sim
import repro_torch.core.adaptive as T_adaptive
import repro_torch.p2p.store as T_store
import repro_torch.p2p.transfer as T_transfer
import repro_torch.sim as T_sim

R = types.SimpleNamespace(sim=R_sim, store=R_p2p, transfer=R_p2p,
                          ctl=R_adaptive)
T = types.SimpleNamespace(sim=T_sim, store=T_store, transfer=T_transfer,
                          ctl=T_adaptive)

V, TD, K = 20.0, 50.0, 16
SEEDS = (0, 1, 2, 3)


def _policy(ns, name, scen):
    sim = ns.sim
    if name == "fixed":
        return sim.FixedIntervalPolicy(T=900.0)
    if name == "adaptive":
        return sim.AdaptivePolicy(ns.ctl.AdaptiveCheckpointController(
            k=K, prior_mu=1.0 / 4000.0, prior_v=V, mu_window=32))
    if name in ("gossip", "isolated"):
        return sim.GossipAdaptivePolicy.make(
            K, regime=name, period=600.0, fanout=3, weight=0.5,
            prior_mu=1.0 / 32000.0, prior_v=10.0, mu_window=32)
    if name == "oracle":
        return sim.OraclePolicy(k=K, V=V, T_d=TD, mtbf_fn=scen.mtbf_fn)
    if name == "oracle_shock":
        return sim.OraclePolicy(k=K, V=V, T_d=TD, mtbf_fn=scen.mtbf_fn,
                                shock_rate_per_peer=2e-5)
    raise KeyError(name)


def _job(ns, seed, policy="adaptive", scen_name="constant", store=False,
         speed=1.0, mix=None, shock=False, max_wall_time=float("inf"),
         **scen_kw):
    sim = ns.sim
    scen_kw = scen_kw or dict(mtbf=4000.0)
    scen = sim.scenario(scen_name, **scen_kw)
    if shock:
        scen = scen.with_shock(sim.ShockSpec(rate=2e-4, kill_frac=0.3))
    mix = sim.peer_class_mix(mix) if mix else None
    net = sim.ChurnNetwork.from_scenario(scen, 128,
                                         np.random.default_rng(seed), mix=mix)
    st = None
    if store:
        spec = ns.store.StoreSpec(R=3, t_repair=600.0,
                                  transfer=ns.transfer.TransferModel())
        st = ns.store.P2PCheckpointStore(spec, scen.mtbf,
                                         np.random.default_rng(10_000 + seed),
                                         mix=mix)
    return sim.simulate_job(network=net, policy=_policy(ns, policy, scen),
                            k=K, work_required=4 * 3600.0, V=V,
                            T_d=0.0 if store else TD, store=st, speed=speed,
                            max_wall_time=max_wall_time)


CASES = {
    "fixed": dict(policy="fixed"),
    "adaptive": dict(policy="adaptive"),
    "gossip": dict(policy="gossip"),
    "isolated": dict(policy="isolated"),
    "oracle": dict(policy="oracle", scen_name="diurnal", mtbf=4000.0),
    "oracle_shock": dict(policy="oracle_shock"),
    "store": dict(policy="adaptive", store=True),
    "store_mix": dict(policy="fixed", store=True, mix="boinc"),
    "speed": dict(policy="adaptive", speed=0.7),
    "shock_mix": dict(policy="isolated", mix="boinc", shock=True),
    "weibull": dict(policy="adaptive", scen_name="weibull", scale=4000.0,
                    shape=0.6),
    "censored": dict(policy="fixed", mtbf=500.0,
                     max_wall_time=6 * 3600.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_simulate_job_matches_reference_bitwise(case):
    kw = CASES[case]
    for seed in SEEDS:
        a = _job(R, seed, **kw)
        b = _job(T, seed, **kw)
        assert dataclasses.astuple(a) == dataclasses.astuple(b), (case, seed)
    if case == "censored":
        assert not b.completed
    if case.startswith("store"):
        assert b.n_peer_restores + b.n_server_restores > 0


def test_gossip_policy_mixing_matches_reference():
    pols = [ns.sim.GossipAdaptivePolicy.make(
        4, regime="gossip", period=100.0, fanout=3, weight=0.5,
        prior_mu=1.0 / 7200.0, prior_v=V) for ns in (R, T)]
    for pol in pols:
        for i in range(8):
            pol.on_observation_slot(i % 5, 60.0 + i)
        pol.tick(100.0)
        pol.tick(150.0)   # not due: no second round
        pol.tick(200.0)
    assert [c.mu for c in pols[0].controllers] == \
        [c.mu for c in pols[1].controllers]
    assert pols[0].interval() == pols[1].interval()
    with pytest.raises(ValueError):
        T_sim.GossipAdaptivePolicy.make(4, regime="nope")


def test_oracle_policy_aliases_warn_and_apply():
    scen = T_sim.scenario("constant", mtbf=4000.0)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        pol = T_sim.OraclePolicy(
            k=K, V=V, T_d=TD, mtbf_fn=scen.mtbf_fn,
            # reprolint: ignore[A001] -- this test pins the deprecation shim
            min_iv=30.0, max_iv=40.0)
    assert (pol.min_interval, pol.max_interval) == (30.0, 40.0)
    assert len(rec) == 2 and all(
        issubclass(w.category, DeprecationWarning) for w in rec)
    assert pol.interval() == 40.0


def _comparisons_equal(a, b):
    for x, y in zip(a, b):
        for f in ("mtbf0", "fixed_T", "adaptive_wall", "fixed_wall",
                  "oracle_wall"):
            assert getattr(x, f) == getattr(y, f), f
        assert dataclasses.astuple(x.adaptive) == \
            dataclasses.astuple(y.adaptive)
        assert dataclasses.astuple(x.fixed) == dataclasses.astuple(y.fixed)


def test_compare_reference_engine_matches_reference():
    kw = dict(mtbf0=4000.0, fixed_T=900.0, work=2 * 3600.0, seeds=(0, 1),
              engine="reference")
    a = R_sim.compare(scenario=R_sim.scenario("doubling", mtbf0=4000.0,
                                              double_after=4 * 3600.0), **kw)
    b = T_sim.compare(scenario=T_sim.scenario("doubling", mtbf0=4000.0,
                                              double_after=4 * 3600.0), **kw)
    _comparisons_equal([a], [b])
    # A legacy untagged rate function runs on the heap whatever the engine.
    a = R_sim.compare(mtbf_fn=lambda t: 4000.0, **dict(kw, engine="batched"))
    b = T_sim.compare(mtbf_fn=lambda t: 4000.0, **dict(kw, engine="batched"))
    _comparisons_equal([a], [b])
    # A tagged one is recovered as its scenario.
    a = R_sim.compare(mtbf_fn=R_sim.constant_mtbf(4000.0), **kw)
    b = T_sim.compare(mtbf_fn=T_sim.constant_mtbf(4000.0), **kw)
    _comparisons_equal([a], [b])


def test_compare_grid_reference_engine_matches_reference():
    def entries(ns):
        return [ns.sim.GridEntry(ns.sim.scenario("constant", mtbf=m),
                                 mtbf0=m, fixed_T=T_)
                for m in (4000.0, 7200.0) for T_ in (300.0, 3600.0)]

    kw = dict(work=2 * 3600.0, seeds=(0, 1), engine="reference")
    _comparisons_equal(R_sim.compare_grid(entries(R), **kw),
                       T_sim.compare_grid(entries(T), **kw))
    with pytest.raises(ValueError):
        T_sim.compare_grid(entries(T), engine="nope", device="cpu")
