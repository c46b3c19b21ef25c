"""The port's workflow DAG layer (``repro_torch.sim.workflow``) against
``repro.sim.workflow`` on the CPU.

``simulate_workflow(device="cpu", draws="numpy")`` replays the reference's
``backend="numpy"`` run seed for seed (the reference's ``backend="auto"``
reaches a jax API the installed jax lacks, so every reference call here
pins ``"numpy"``): the same hand-off streams, the same engine cell seeds
``1000 * stage_index + seed``.  Counts and ``completed`` must be equal;
makespan, waste, hand-off and server bytes within 1e-9 relative;
``predicted_waste`` and ``waste_band`` likewise.  DAGs: the two of
``tests/test_exec.py``, ``examples/workflow_dag.py``'s at a cut work
scale, per-stage mix and shock overrides, a server-only store, the
per-peer isolated regime (the plain step) and a censored stage.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.p2p as R_p2p
import repro.sim as R_sim
import repro.sim.workflow as R_wf
import repro_torch.p2p as T_p2p
import repro_torch.sim as T_sim
import repro_torch.sim.workflow as T_wf

SIDES = {"ref": (R_sim, R_p2p, R_wf), "port": (T_sim, T_p2p, T_wf)}
COUNTS = ("n_checkpoints", "n_failures", "n_server_restores",
          "n_peer_restores", "completed")
FLOATS = ("wall_time", "wasted_work", "checkpoint_time", "restore_time",
          "server_bytes")
STAGE_FLOATS = ("ready", "start", "finish", "handoff_time", "handoff_waste",
                "server_bytes")


def _rel(x, y) -> float:
    x, y = np.asarray(x, dtype=float), np.asarray(y, dtype=float)
    same = (x == y) | (np.isnan(x) & np.isnan(y))
    r = np.abs(x - y) / np.maximum(np.abs(x), 1e-300)
    return float(np.max(np.where(same, 0.0, r), initial=0.0))


def _case(side, name):
    sim, p2p, wf = SIDES[side]
    shocked = sim.scenario("constant", mtbf=5400.0).with_shock(
        sim.ShockSpec(rate=1 / 3600.0, kill_frac=0.3))
    three = wf.WorkflowSpec(stages=(
        wf.Stage(name="prep", work=1800.0, k=8),
        wf.Stage(name="train", work=2400.0, k=8, deps=("prep",),
                 handoff=120.0),
        wf.Stage(name="eval", work=900.0, k=8, deps=("train",),
                 handoff=60.0)))
    pol = sim.PolicyConfig(kind="adaptive", prior_mu=1 / 5400.0,
                           prior_v=20.0)
    kw = dict(policy=pol, seeds=range(6), V=20.0, T_d=50.0)
    if name == "shocked_3stage":
        return three, shocked, kw
    if name == "two_class_store":
        return three, shocked, dict(
            kw, mix=sim.peer_class_mix("fast_core_volunteer_tail"),
            store=p2p.StoreSpec(R=3))
    example = wf.WorkflowSpec(stages=(
        wf.Stage("preprocess", work=1200.0, k=8),
        wf.Stage("train", work=3600.0, k=16, deps=("preprocess",),
                 handoff=180.0),
        wf.Stage("evaluate", work=600.0, k=4, deps=("train",),
                 handoff=60.0)))
    diurnal = sim.scenario("diurnal", mtbf=7200.0)
    ad = sim.PolicyConfig(kind="adaptive", prior_mu=1 / 7200.0, prior_v=20.0)
    if name == "example_fixed":
        return example, diurnal, dict(
            kw, policy=sim.PolicyConfig(kind="fixed", fixed_T=3600.0))
    if name == "example_mix_p2p":
        return example, diurnal, dict(
            kw, policy=ad, mix=sim.peer_class_mix("fast_core_volunteer_tail"),
            store=p2p.StoreSpec(R=3, transfer=p2p.TransferModel(
                img_bytes=200e6)))
    if name == "server_only":
        return example, diurnal, dict(kw, policy=ad,
                                      store=p2p.StoreSpec(R=0))
    if name == "stage_overrides":
        diamond = wf.WorkflowSpec(stages=(
            wf.Stage("a", work=900.0, k=4),
            wf.Stage("b", work=1800.0, k=8, deps=("a",), handoff=90.0,
                     mix=sim.peer_class_mix("boinc"),
                     shock=sim.ShockSpec(rate=5e-4, kill_frac=0.5)),
            wf.Stage("c", work=1200.0, k=4, deps=("a",), handoff=30.0,
                     V=10.0, T_d=25.0),
            wf.Stage("d", work=600.0, k=4, deps=("b", "c"), handoff=45.0)))
        return diamond, diurnal, dict(kw, policy=ad,
                                      store=p2p.StoreSpec(R=2))
    if name == "isolated_regime":
        return three, shocked, dict(kw, policy=sim.PolicyConfig(
            kind="adaptive", prior_mu=1 / 5400.0, prior_v=20.0,
            regime="isolated"))
    if name == "censored":
        hot = wf.WorkflowSpec(stages=(
            wf.Stage("a", work=600.0, k=8),
            wf.Stage("b", work=600.0, k=8, deps=("a",), handoff=10.0)))
        return hot, sim.scenario("constant", mtbf=60.0), dict(
            kw, max_wall_factor=5.0)
    raise KeyError(name)


def _run(side, name):
    spec, scen, kw = _case(side, name)
    wf = SIDES[side][2]
    if side == "ref":
        return wf.simulate_workflow(spec, scen, backend="numpy", **kw)
    return wf.simulate_workflow(spec, scen, device="cpu", draws="numpy",
                                **kw)


@pytest.mark.parametrize("name", [
    "shocked_3stage", "two_class_store", "example_fixed", "example_mix_p2p",
    "server_only", "stage_overrides", "isolated_regime", "censored"])
def test_simulate_workflow_matches_the_reference(name):
    a, b = _run("ref", name), _run("port", name)
    assert list(a.stages) == list(b.stages)
    assert a.critical_path == b.critical_path
    assert np.array_equal(a.completed, b.completed)
    assert _rel(a.makespan, b.makespan) <= 1e-9
    assert _rel(a.server_bytes, b.server_bytes) <= 1e-9
    for sname in a.stages:
        sa, sb = a.stages[sname], b.stages[sname]
        assert np.array_equal(sa.completed, sb.completed), sname
        for f in COUNTS:
            assert np.array_equal(getattr(sa.sim, f), getattr(sb.sim, f)), \
                (sname, f)
        for f in FLOATS:
            assert _rel(getattr(sa.sim, f), getattr(sb.sim, f)) <= 1e-9, \
                (sname, f)
        for f in STAGE_FLOATS:
            assert _rel(getattr(sa, f), getattr(sb, f)) <= 1e-9, (sname, f)
    assert _rel(R_wf.predicted_waste(a), T_wf.predicted_waste(b)) <= 1e-9
    for n_sigma in (1.0, 3.0):
        assert _rel(R_wf.waste_band(a, n_sigma),
                    T_wf.waste_band(b, n_sigma)) <= 1e-9
    if name == "censored":
        assert not b.completed.any()
    else:
        assert b.all_completed


def test_seed_isolation_and_common_random_numbers():
    spec, scen, kw = _case("port", "two_class_store")
    kw = dict(kw, seeds=(0, 1))
    both = T_wf.simulate_workflow(spec, scen, device="cpu", draws="numpy",
                                  **kw)
    one = T_wf.simulate_workflow(spec, scen, device="cpu", draws="numpy",
                                 **dict(kw, seeds=(1,)))
    assert both.makespan[1] == one.makespan[0]
    for sname in both.stages:
        assert both.stages[sname].handoff_waste[1] == \
            one.stages[sname].handoff_waste[0]


def test_philox_draws_on_the_cpu_complete_the_dag():
    spec, scen, kw = _case("port", "two_class_store")
    res = T_wf.simulate_workflow(spec, scen, device="cpu", **kw)
    assert res.all_completed
    lo, mean, hi = T_wf.waste_band(res)
    assert 0.0 <= lo <= mean <= hi and mean > 0.0


def test_workflow_spec_validates_like_the_reference():
    S, W = T_wf.Stage, T_wf.WorkflowSpec
    with pytest.raises(ValueError, match="unique"):
        W(stages=(S("a", 1.0), S("a", 2.0)))
    with pytest.raises(ValueError, match="unknown"):
        W(stages=(S("a", 1.0, deps=("z",)),))
    with pytest.raises(ValueError, match="cycle"):
        W(stages=(S("a", 1.0, deps=("b",)), S("b", 1.0, deps=("a",))))
    with pytest.raises(ValueError, match="work>0"):
        W(stages=(S("a", 0.0),))
    spec, _, _ = _case("port", "stage_overrides")
    ref, _, _ = _case("ref", "stage_overrides")
    assert [s.name for s in spec.topo_order()] == \
        [s.name for s in ref.topo_order()]
    assert len(spec) == 4
    with pytest.raises(ValueError, match="no stages"):
        T_wf.predicted_waste(dataclasses.replace(
            _run("port", "censored"), stages={}))


def test_simulate_workflow_defaults_to_cuda():
    spec, scen, kw = _case("port", "shocked_3stage")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; tests/test_torch_cuda.py "
                    "drives the workflow on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T_wf.simulate_workflow(spec, scen, **kw)


@pytest.mark.parametrize("argv", [
    ["--seeds", "2", "--draws", "numpy"],
    ["--seeds", "2", "--p2p", "--mix", "fast_core_volunteer_tail",
     "--scenario", "weibull"],
])
def test_launch_workflow_dag_runs_on_cpu(capsys, argv):
    from repro_torch.launch import workflow_dag

    assert workflow_dag.main(["--device", "cpu"] + argv) == 0
    out = capsys.readouterr().out
    assert "device cpu" in out and "critical path: preprocess -> train" in out
    assert ("adaptive wins" in out or "fixed wins" in out
            or "P2P offload:" in out)


def test_launch_workflow_dag_executes_the_twin_on_cpu(capsys):
    from repro_torch.launch import workflow_dag

    spec = T_wf.WorkflowSpec(stages=(
        T_wf.Stage("preprocess", work=900.0, k=8),
        T_wf.Stage("train", work=1800.0, k=16, deps=("preprocess",),
                   handoff=180.0)))
    scen = T_sim.scenario("diurnal", mtbf=7200.0)
    pol = T_sim.PolicyConfig(kind="adaptive", prior_mu=1 / 7200.0,
                             prior_v=20.0)
    got = workflow_dag.execute_for_real(
        spec, scen, pol, sim_seeds=8, exec_seeds=2, device="cpu",
        mix=T_sim.peer_class_mix("fast_core_volunteer_tail"),
        store=T_p2p.StoreSpec(R=3), dim=16)
    out = capsys.readouterr().out
    assert len(got["measured"]) == 2 and all(r.completed
                                            for r in got["reports"])
    assert ("INSIDE" in out) == got["inside"]
    lo, mean, hi = got["band"]
    assert lo <= mean <= hi
    # the seeds run at once, in threads: seed 0 alone gives its report
    one = workflow_dag.execute_for_real(
        spec, scen, pol, sim_seeds=8, exec_seeds=1, device="cpu",
        mix=T_sim.peer_class_mix("fast_core_volunteer_tail"),
        store=T_p2p.StoreSpec(R=3), dim=16)
    assert one["measured"] == got["measured"][:1]
    a, b = one["reports"][0], got["reports"][0]
    assert (a.executed_supersteps, a.n_checkpoints, a.n_restores) == \
        (b.executed_supersteps, b.n_checkpoints, b.n_restores)
