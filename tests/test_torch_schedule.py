"""The port's serialized failure schedules and their replay
(``repro_torch.runtime.failures``) against ``repro.runtime.failures`` on
the CPU.

A schedule is the interchange format between the sim and the executor, and
between the JAX package and the port: ``export_failure_schedule(...)
.to_json()`` must give the reference's string exactly, for the
homogeneous shocked 3-stage DAG and the two-class ``StoreSpec(R=3)`` DAG of
``tests/test_exec.py`` at several seeds; a schedule the reference wrote
must load with the port's ``WorkflowSchedule.from_json`` and replay the
same events (job failures, observed lifetimes, holder availability) as the
reference's injector replays them.
"""
import numpy as np
import pytest

import repro.p2p as R_p2p
import repro.runtime.failures as R_fail
import repro.sim as R_sim
import repro.sim.workflow as R_wf
import repro_torch.p2p as T_p2p
import repro_torch.runtime.failures as T_fail
import repro_torch.sim as T_sim
import repro_torch.sim.workflow as T_wf
from repro_torch.p2p.overlay import HolderTrack


def _spec(wf):
    return wf.WorkflowSpec(stages=(
        wf.Stage(name="prep", work=1800.0, k=8),
        wf.Stage(name="train", work=2400.0, k=8, deps=("prep",),
                 handoff=120.0),
        wf.Stage(name="eval", work=900.0, k=8, deps=("train",),
                 handoff=60.0),
    ))


def _dag(side, form):
    """(spec, scenario, extra kwargs) of ``tests/test_exec.py``'s DAGs."""
    sim, p2p, wf = {"ref": (R_sim, R_p2p, R_wf),
                    "port": (T_sim, T_p2p, T_wf)}[side]
    scen = sim.scenario("constant", mtbf=5400.0).with_shock(
        sim.ShockSpec(rate=1 / 3600.0, kill_frac=0.3))
    kw = {}
    if form == "two_class":
        kw = dict(mix=sim.peer_class_mix("fast_core_volunteer_tail"),
                  store=p2p.StoreSpec(R=3))
    return _spec(wf), scen, kw


def _export(side, form, seed, **extra):
    wf = R_wf if side == "ref" else T_wf
    spec, scen, kw = _dag(side, form)
    return wf.export_failure_schedule(spec, scen, seed=seed,
                                      horizon_factor=60.0, **kw, **extra)


@pytest.mark.parametrize("form", ["homogeneous", "two_class"])
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_exported_schedule_json_equals_the_reference(form, seed):
    a = _export("ref", form, seed).to_json()
    b = _export("port", form, seed).to_json()
    assert a == b
    assert len(a) > 1000


@pytest.mark.parametrize("form", ["homogeneous", "two_class"])
def test_schedule_json_round_trip(form):
    s = _export("port", form, 2)
    again = T_fail.WorkflowSchedule.from_json(s.to_json())
    assert again == s
    assert again.to_json() == s.to_json()


def test_exported_schedule_with_other_slots_and_horizon():
    a = _export("ref", "two_class", 3, n_slots=64)
    b = _export("port", "two_class", 3, n_slots=64)
    assert a.to_json() == b.to_json()
    st = b.stages["train"]
    assert st.n_slots == 64 and st.watch == 32
    assert st.classes and st.holders and st.holder_class


def _drive(inj, fail_cls, seconds=(15.0,) * 400 + (50.0, 20.0) * 40):
    """Advance ``inj`` through steps and exposed/unexposed stretches,
    recording every failure and every drained observation."""
    log = []
    for i, sec in enumerate(seconds):
        try:
            if i % 7 == 3:
                inj.advance_seconds(sec)
            elif i % 5 == 1:
                inj.advance_exposed(sec)
            else:
                inj.advance_step()
        except fail_cls as f:
            log.append(("fail", f.slot, f.lifetime, f.at_virtual_time))
        log.append(("obs", tuple(inj.drain_observations()),
                    inj.virtual_time))
    return log


@pytest.mark.parametrize("form", ["homogeneous", "two_class"])
@pytest.mark.parametrize("stage", ["prep", "train", "eval"])
def test_reference_json_replays_the_same_events(form, stage):
    ref = _export("ref", form, 4)
    port = T_fail.WorkflowSchedule.from_json(ref.to_json())
    r = R_fail.FailureInjector.from_schedule(ref.stages[stage],
                                             seconds_per_step=15.0)
    t = T_fail.FailureInjector.from_schedule(port.stages[stage],
                                             seconds_per_step=15.0)
    a = _drive(r, R_fail.SimulatedFailure)
    b = _drive(t, T_fail.SimulatedFailure)
    assert a == b
    assert sum(x[0] == "fail" for x in b) > 0
    sr, sp = ref.stages[stage], port.stages[stage]
    assert sp.job_speed() == sr.job_speed()
    assert sp.job_hazard_sum() == sr.job_hazard_sum()
    assert sp.watch_hazard_sum() == sr.watch_hazard_sum()
    assert sp.holder_uplinks() == sr.holder_uplinks()
    if form == "two_class":
        hr, hp = sr.holder_view(), sp.holder_view()
        for t_ in np.linspace(0.0, 0.9 * sr.horizon, 200):
            assert hp.alive_slots(float(t_)) == hr.alive_slots(float(t_))


def test_replay_past_the_horizon_raises_schedule_exhausted():
    scen = T_sim.scenario("constant", mtbf=600.0)
    st = T_fail.build_stage_schedule(scen, k=4, seed=0, horizon=100.0,
                                     n_slots=16)
    inj = T_fail.FailureInjector(k=4, schedule=st, seconds_per_step=30.0)
    with pytest.raises(T_fail.ScheduleExhausted):
        for _ in range(10):
            try:
                inj.advance_step()
            except T_fail.SimulatedFailure:
                pass
    with pytest.raises(ValueError, match="k="):
        T_fail.FailureInjector(k=5, schedule=st)


@pytest.mark.parametrize("kw,match", [
    (dict(k=0), "k > 0"),
    (dict(watch=99), "watch"),
    (dict(horizon=0.0), "horizon"),
    (dict(events=(T_fail.FailureEvent(5.0, 1, 3.0),
                  T_fail.FailureEvent(4.0, 2, 3.0))), "time-ordered"),
    (dict(slot_class=(0,) * 16), "class table"),
    (dict(holders=(HolderTrack(True),)), "store params"),
])
def test_stage_schedule_validates_like_the_reference(kw, match):
    base = dict(k=4, watch=8, n_slots=16, seed=0, horizon=100.0, events=())
    with pytest.raises(ValueError, match=match):
        T_fail.StageSchedule(**{**base, **kw})


@pytest.mark.parametrize("stage_index", [0, 2])
def test_build_stage_schedule_equals_the_reference(stage_index):
    r_scen = R_sim.scenario("weibull", scale=3000.0, shape=0.7)
    t_scen = T_sim.scenario("weibull", scale=3000.0, shape=0.7)
    kw = dict(k=6, seed=11, horizon=20_000.0, n_slots=48,
              stage_index=stage_index)
    a = R_fail.build_stage_schedule(
        r_scen, mix=R_sim.peer_class_mix("boinc"),
        shock=R_sim.ShockSpec(rate=2e-4, kill_frac=0.5),
        store=R_p2p.StoreSpec(R=2), **kw)
    b = T_fail.build_stage_schedule(
        t_scen, mix=T_sim.peer_class_mix("boinc"),
        shock=T_sim.ShockSpec(rate=2e-4, kill_frac=0.5),
        store=T_p2p.StoreSpec(R=2), **kw)
    assert R_fail.WorkflowSchedule({"s": a}, seed=11).to_json() == \
        T_fail.WorkflowSchedule({"s": b}, seed=11).to_json()
    assert b.shock_epochs and b.events
