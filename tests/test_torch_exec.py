"""The port's resumable workflow executor (``repro_torch.exec``) on the
CPU: its own contracts, and parity with ``repro.exec``.

* The executor tests of ``tests/test_exec.py`` ported: fault-free
  accounting and determinism, a power iteration that converges, input
  validation, crash-and-resume from a replica with the primary corrupted
  (final payload bitwise equal to an uninterrupted run), resume of a
  finished workflow, censoring, class-speed supersteps, endogenous
  hand-off and restore latency off pinned holders, schedule exhaustion
  reported as censoring, and the fixed policy never ticking the
  controller.
* Parity: the port executor with the port ``MixTask`` and the reference
  executor with the reference ``MixTask`` on the same schedule (the
  reference's JSON, loaded by the port) give the same supersteps,
  failures, checkpoints and restores; waste within 1e-9 relative and the
  final payload within 1e-12 (the tasks' ``cos`` and sums round the last
  bits differently from numpy's).
* ``PowerIterTask``: the JAX task's own initial payload carried across by
  ``from_reference_payload``; after 8 steps ``v`` and ``eig`` agree at
  rtol 1e-5.
* The two digital-twin headlines on the port alone: the executor's mean
  waste inside the port sim's 3-sigma band, homogeneous shocked and
  two-class endogenous.
"""
import glob
import math
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import repro.exec as R_exec
import repro.p2p as R_p2p
import repro.sim as R_sim
import repro.sim.workflow as R_wf
from repro_torch.core.adaptive import AdaptiveCheckpointController
from repro_torch.exec import (
    ExecutorConfig,
    ExecutorKilled,
    KillSpec,
    MixTask,
    PowerIterTask,
    WorkflowExecutor,
    from_reference_payload,
    stage_paths,
)
from repro_torch.p2p import StoreSpec
from repro_torch.p2p.overlay import HolderTrack
from repro_torch.runtime.failures import WorkflowSchedule, build_stage_schedule
from repro_torch.sim import PolicyConfig, peer_class_mix
from repro_torch.sim.scenarios import ShockSpec, scenario
from repro_torch.sim.workflow import (
    Stage,
    WorkflowSpec,
    export_failure_schedule,
    predicted_waste,
    simulate_workflow,
    waste_band,
)

CPU = "cpu"
CALM = scenario("constant", mtbf=1e9)   # effectively churn-free
SPEC2 = WorkflowSpec(stages=(
    Stage(name="a", work=300.0, k=8),
    Stage(name="b", work=600.0, k=8, deps=("a",), handoff=30.0),
))
TASKS2 = {"a": MixTask(dim=16, salt=1, device=CPU),
          "b": MixTask(dim=16, salt=2, device=CPU)}


def _cfg(root, **kw):
    kw.setdefault("seconds_per_superstep", 10.0)
    kw.setdefault("prior_mu", 1 / 5400.0)
    return ExecutorConfig(root=str(root), **kw)


def _payloads_equal(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


# --------------------------------------------------------------------------- #
# Fault-free semantics.                                                       #
# --------------------------------------------------------------------------- #

def test_fault_free_run_executes_every_superstep_once(tmp_path):
    sched = export_failure_schedule(SPEC2, CALM, seed=0, horizon_factor=60.0)
    rep = WorkflowExecutor(SPEC2, TASKS2, sched, _cfg(tmp_path / "r")).run()
    assert rep.completed
    assert rep.stages["a"].executed_supersteps == 30   # 300s / 10s
    assert rep.stages["b"].executed_supersteps == 60
    assert rep.stages["a"].n_failures == 0
    assert rep.total_waste == 0.0
    assert rep.stages["b"].ready == pytest.approx(rep.stages["a"].finish)
    assert rep.stages["b"].handoff_time == pytest.approx(30.0)
    assert rep.makespan == pytest.approx(max(s.finish
                                             for s in rep.stages.values()))
    assert rep.write_real_s > 0.0
    assert rep.n_checkpoints == sum(s.n_checkpoints
                                    for s in rep.stages.values())


def test_fault_free_payload_is_deterministic(tmp_path):
    sched = export_failure_schedule(SPEC2, CALM, seed=0, horizon_factor=60.0)
    like = TASKS2["b"].init({"a": TASKS2["a"].init({})})
    outs = []
    for sub in ("r1", "r2"):
        ex = WorkflowExecutor(SPEC2, TASKS2, sched, _cfg(tmp_path / sub))
        assert ex.run().completed
        outs.append(ex.output("b", like))
    assert _payloads_equal(outs[0], outs[1])
    assert outs[0]["x"].device.type == CPU


def test_power_iteration_task_runs_for_real(tmp_path):
    spec = WorkflowSpec(stages=(Stage(name="p", work=600.0, k=8),))
    task = PowerIterTask(dim=32, seed=0, device=CPU)
    sched = export_failure_schedule(spec, CALM, seed=0, horizon_factor=60.0)
    ex = WorkflowExecutor(spec, {"p": task}, sched, _cfg(tmp_path / "r"))
    assert ex.run().completed
    out = ex.output("p", task.init({}))
    # 60 matvecs converge to the dominant eigenvalue of the PSD matrix.
    eigs = np.linalg.eigvalsh(out["mat"].double().numpy())
    assert float(out["eig"]) == pytest.approx(float(eigs[-1]), rel=1e-3)


def test_executor_validates_tasks_and_schedules(tmp_path):
    sched = export_failure_schedule(SPEC2, CALM, seed=0, horizon_factor=60.0)
    with pytest.raises(ValueError, match="no task bound"):
        WorkflowExecutor(SPEC2, {"a": TASKS2["a"]}, sched, _cfg(tmp_path))
    bad_spec = WorkflowSpec(stages=(
        Stage(name="a", work=300.0, k=4),       # schedule was built for k=8
        Stage(name="b", work=600.0, k=8, deps=("a",), handoff=30.0),
    ))
    with pytest.raises(ValueError, match="k="):
        WorkflowExecutor(bad_spec, TASKS2, sched, _cfg(tmp_path))
    with pytest.raises(ValueError, match="no schedule"):
        WorkflowExecutor(SPEC2, TASKS2, WorkflowSchedule(
            stages={"a": sched.stages["a"]}, seed=0), _cfg(tmp_path))


# --------------------------------------------------------------------------- #
# Crash-and-resume: a stage killed mid-superstep resumes from a replica with  #
# the primary corrupted, losing nothing beyond the last checkpoint.           #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("task", ["mix", "power"])
def test_crash_and_resume_from_replica_with_corrupt_primary(tmp_path, task):
    sched = export_failure_schedule(SPEC2, CALM, seed=0, horizon_factor=60.0)
    tasks = TASKS2 if task == "mix" else {
        "a": MixTask(dim=16, salt=1, device=CPU),
        "b": PowerIterTask(dim=24, seed=3, device=CPU)}
    cfg = _cfg(tmp_path / "r", policy="fixed", fixed_interval=120.0)
    # Fixed 120s cadence at 10s/superstep: stage b commits at 12, 24, 36, 48.
    with pytest.raises(ExecutorKilled) as ei:
        WorkflowExecutor(SPEC2, tasks, sched, cfg).run(
            kill=KillSpec("b", after_supersteps=25))
    assert ei.value.stage == "b" and ei.value.superstep == 25

    paths = stage_paths(cfg.root, "b", cfg.n_replica_dirs)
    newest = sorted(glob.glob(os.path.join(paths.primary, "step_*")))[-1]
    assert newest.endswith("step_00000024")
    shard = sorted(glob.glob(os.path.join(newest, "shard_*.npz")))[0]
    size = os.path.getsize(shard)
    with open(shard, "r+b") as f:
        f.truncate(size // 2)

    rep = WorkflowExecutor(SPEC2, tasks, sched, cfg).run(resume=True)
    assert rep.completed
    assert rep.stages["a"].resumed
    assert rep.stages["a"].executed_supersteps == 0
    b = rep.stages["b"]
    assert b.resumed
    assert b.start_superstep == 24
    assert b.executed_supersteps == 60 - 24
    assert rep.resume_latency_s is not None and rep.resume_latency_s < 60.0
    # Retention drops only an incarnation's own images beyond its newest
    # two: the killed run's 12 and 24 stay beside the resumed run's 48 and
    # the output at 60.
    steps = sorted(int(p[-8:]) for p in glob.glob(
        os.path.join(paths.primary, "step_*")))
    assert steps == [12, 24, 48, 60]

    # Final payload is bit-identical to an uninterrupted run.
    like = tasks["b"].init({"a": tasks["a"].init({})})
    ref_cfg = _cfg(tmp_path / "ref", policy="fixed", fixed_interval=120.0)
    ref = WorkflowExecutor(SPEC2, tasks, sched, ref_cfg)
    assert ref.run().completed
    assert _payloads_equal(ref.output("b", like),
                           WorkflowExecutor(SPEC2, tasks, sched, cfg)
                           .output("b", like))


def test_resume_of_a_finished_workflow_is_a_noop(tmp_path):
    sched = export_failure_schedule(SPEC2, CALM, seed=0, horizon_factor=60.0)
    cfg = _cfg(tmp_path / "r")
    assert WorkflowExecutor(SPEC2, TASKS2, sched, cfg).run().completed
    rep = WorkflowExecutor(SPEC2, TASKS2, sched, cfg).run(resume=True)
    assert rep.completed
    assert rep.executed_supersteps == 0
    assert all(s.resumed for s in rep.stages.values())


def test_censored_stage_marks_dependents_incomplete(tmp_path):
    hot = scenario("constant", mtbf=8.0)
    spec = WorkflowSpec(stages=(
        Stage(name="a", work=300.0, k=8),
        Stage(name="b", work=300.0, k=8, deps=("a",)),
    ))
    sched = export_failure_schedule(spec, hot, seed=0, n_slots=16,
                                    horizon_factor=120.0)
    cfg = _cfg(tmp_path / "r", max_wall_factor=10.0, T_d=5.0, V=2.0)
    rep = WorkflowExecutor(spec, TASKS2, sched, cfg).run()
    assert not rep.completed
    assert not rep.stages["a"].completed
    assert "b" not in rep.stages          # dependent never started


# --------------------------------------------------------------------------- #
# Heterogeneous + endogenous-restore execution.                               #
# --------------------------------------------------------------------------- #

def test_supersteps_run_at_class_speed(tmp_path):
    mix = peer_class_mix("fast_core_volunteer_tail")
    sched = export_failure_schedule(SPEC2, CALM, seed=0, horizon_factor=60.0,
                                    mix=mix)
    speed_a = sched.stages["a"].job_speed()
    speed_b = sched.stages["b"].job_speed()
    assert speed_a != 1.0
    rep = WorkflowExecutor(SPEC2, TASKS2, sched, _cfg(tmp_path / "r")).run()
    assert rep.completed and rep.total_waste == 0.0
    a, b = rep.stages["a"], rep.stages["b"]
    assert a.elapsed_virtual == pytest.approx(
        300.0 / speed_a + a.n_checkpoints * 20.0)
    assert b.elapsed_virtual == pytest.approx(
        30.0 + 600.0 / speed_b + b.n_checkpoints * 20.0)
    plain = export_failure_schedule(SPEC2, CALM, seed=0, horizon_factor=60.0)
    assert plain.stages["a"].job_speed() == 1.0


def test_endogenous_handoff_reads_pinned_holders(tmp_path):
    store = StoreSpec(R=3)
    td_peer = store.transfer.restore_seconds_from([1.0, 1.0, 1.0])
    for up, root in ((True, "up"), (False, "dn")):
        sched = export_failure_schedule(SPEC2, CALM, seed=0,
                                        horizon_factor=60.0, store=store)
        for name in sched.stages:   # pin every holder permanently up/down
            sched.stages[name] = replace(sched.stages[name],
                                         holders=(HolderTrack(up),) * 3)
        rep = WorkflowExecutor(SPEC2, TASKS2, sched,
                               _cfg(tmp_path / root)).run()
        assert rep.completed
        if up:
            assert rep.stages["b"].handoff_time == pytest.approx(td_peer)
            assert rep.server_bytes == 0.0
        else:
            assert rep.stages["b"].handoff_time == \
                pytest.approx(store.td_server)
            assert rep.server_bytes == \
                pytest.approx(store.transfer.img_bytes)


def test_endogenous_restore_latency_from_holder_realization(tmp_path):
    scen = scenario("constant", mtbf=900.0)
    spec = WorkflowSpec(stages=(Stage(name="a", work=1200.0, k=8),))
    tasks = {"a": MixTask(dim=16, salt=1, device=CPU)}

    store = StoreSpec(R=3)
    td_peer = store.transfer.restore_seconds_from([1.0, 1.0, 1.0])
    sched = export_failure_schedule(spec, scen, seed=2, horizon_factor=60.0,
                                    store=store)
    sched.stages["a"] = replace(sched.stages["a"],
                                holders=(HolderTrack(True),) * 3)
    rep = WorkflowExecutor(spec, tasks, sched, _cfg(tmp_path / "up")).run()
    a = rep.stages["a"]
    assert rep.completed and a.n_failures > 0
    assert a.n_server_restores == 0 and a.server_bytes == 0.0
    assert a.restore_time >= a.n_restores * td_peer - 1e-9

    store0 = StoreSpec(R=0)
    sched0 = export_failure_schedule(spec, scen, seed=2, horizon_factor=60.0,
                                     store=store0)
    rep0 = WorkflowExecutor(spec, tasks, sched0, _cfg(tmp_path / "r0")).run()
    a0 = rep0.stages["a"]
    assert rep0.completed and a0.n_failures > 0
    assert a0.n_server_restores == a0.n_restores > 0
    assert a0.server_bytes >= store0.transfer.img_bytes * \
        (a0.n_restores + a0.n_checkpoints) - 1e-6


def test_schedule_exhausted_is_reported_censored_not_raised(tmp_path):
    hot = scenario("constant", mtbf=8.0)
    spec = WorkflowSpec(stages=(Stage(name="a", work=300.0, k=8),))
    st = build_stage_schedule(hot, k=8, seed=0, horizon=400.0, n_slots=16)
    sched = WorkflowSchedule(stages={"a": st}, seed=0, scenario=hot.name)
    rep = WorkflowExecutor(spec, {"a": MixTask(dim=16, salt=1, device=CPU)},
                           sched, _cfg(tmp_path / "r")).run()
    assert not rep.completed
    assert not rep.stages["a"].completed
    assert rep.stages["a"].schedule_exhausted


def test_fixed_policy_never_ticks_the_controller(tmp_path, monkeypatch):
    calls = []
    orig = AdaptiveCheckpointController.tick

    def counting(self, now, exposure_peers=None):
        calls.append(now)
        return orig(self, now, exposure_peers=exposure_peers)

    monkeypatch.setattr(AdaptiveCheckpointController, "tick", counting)
    sched = export_failure_schedule(SPEC2, CALM, seed=0, horizon_factor=60.0)
    cfg = _cfg(tmp_path / "fx", policy="fixed", fixed_interval=120.0)
    assert WorkflowExecutor(SPEC2, TASKS2, sched, cfg).run().completed
    assert calls == []
    assert WorkflowExecutor(SPEC2, TASKS2, sched,
                            _cfg(tmp_path / "ad")).run().completed
    assert len(calls) > 0


def test_tasks_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; tests/test_torch_cuda.py "
                    "runs the tasks on it")
    for task in (MixTask(), PowerIterTask()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            task.init({})


# --------------------------------------------------------------------------- #
# Parity with the reference executor on the same schedule.                   #
# --------------------------------------------------------------------------- #

THREE = ("prep", "train", "eval")
CONTROL = ("executed_supersteps", "n_failures", "n_checkpoints",
           "n_restores", "n_server_restores", "committed_superstep",
           "start_superstep", "completed", "resumed", "schedule_exhausted")
VIRTUAL = ("ready", "finish", "handoff_time", "handoff_waste",
           "recompute_waste", "checkpoint_time", "restore_time",
           "server_bytes", "final_interval")


def _ref_dag(form):
    spec = R_wf.WorkflowSpec(stages=(
        R_wf.Stage(name="prep", work=1800.0, k=8),
        R_wf.Stage(name="train", work=2400.0, k=8, deps=("prep",),
                   handoff=120.0),
        R_wf.Stage(name="eval", work=900.0, k=8, deps=("train",),
                   handoff=60.0)))
    scen = R_sim.scenario("constant", mtbf=5400.0).with_shock(
        R_sim.ShockSpec(rate=1 / 3600.0, kill_frac=0.3))
    kw = {}
    if form == "two_class":
        kw = dict(mix=R_sim.peer_class_mix("fast_core_volunteer_tail"),
                  store=R_p2p.StoreSpec(R=3))
    return spec, scen, kw


def _port_dag(form):
    scen = scenario("constant", mtbf=5400.0).with_shock(
        ShockSpec(rate=1 / 3600.0, kill_frac=0.3))
    kw = {}
    if form == "two_class":
        kw = dict(mix=peer_class_mix("fast_core_volunteer_tail"),
                  store=StoreSpec(R=3))
    return WorkflowSpec(stages=(
        Stage(name="prep", work=1800.0, k=8),
        Stage(name="train", work=2400.0, k=8, deps=("prep",), handoff=120.0),
        Stage(name="eval", work=900.0, k=8, deps=("train",), handoff=60.0),
    )), scen, kw


@pytest.mark.parametrize("form", ["homogeneous", "two_class"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", ["adaptive", "fixed"])
def test_executor_matches_the_reference_on_one_schedule(tmp_path, form, seed,
                                                        policy):
    spec_r, scen_r, kw_r = _ref_dag(form)
    spec_t, _, _ = _port_dag(form)
    sched_r = R_wf.export_failure_schedule(spec_r, scen_r, seed=seed,
                                           horizon_factor=60.0, **kw_r)
    sched_t = WorkflowSchedule.from_json(sched_r.to_json())
    knobs = dict(seconds_per_superstep=15.0, prior_mu=1 / 5400.0,
                 policy=policy, fixed_interval=600.0)
    rt = {n: R_exec.MixTask(dim=16, salt=i + 1) for i, n in enumerate(THREE)}
    tt = {n: MixTask(dim=16, salt=i + 1, device=CPU)
          for i, n in enumerate(THREE)}
    ex_r = R_exec.WorkflowExecutor(spec_r, rt, sched_r, R_exec.ExecutorConfig(
        root=str(tmp_path / "r"), **knobs))
    ex_t = WorkflowExecutor(spec_t, tt, sched_t, ExecutorConfig(
        root=str(tmp_path / "t"), **knobs))
    a, b = ex_r.run(), ex_t.run()
    assert a.completed == b.completed
    assert list(a.stages) == list(b.stages)
    for n in a.stages:
        for f in CONTROL:
            assert getattr(a.stages[n], f) == getattr(b.stages[n], f), (n, f)
        for f in VIRTUAL:
            x, y = getattr(a.stages[n], f), getattr(b.stages[n], f)
            assert abs(x - y) <= 1e-9 * max(abs(x), 1e-300), (n, f)
    assert abs(a.total_waste - b.total_waste) <= 1e-9 * a.total_waste
    assert abs(a.makespan - b.makespan) <= 1e-9 * a.makespan
    assert sum(s.n_failures for s in b.stages.values()) > 0
    out_r = ex_r.output("eval", rt["eval"].init(
        {"train": rt["train"].init({})}))
    out_t = ex_t.output("eval", tt["eval"].init(
        {"train": tt["train"].init({})}))
    for k in out_r:
        np.testing.assert_allclose(out_t[k].numpy(), out_r[k], rtol=1e-12,
                                   atol=0.0)


def test_retention_does_not_change_the_run(tmp_path):
    """The port keeps each stage's newest two images in every directory
    (``KEEP_IMAGES``), the reference every image; on the same schedule,
    with rollbacks, the runs agree on every control field and the port's
    directories hold at most two images each."""
    spec_r, scen_r, kw_r = _ref_dag("two_class")
    spec_t, _, _ = _port_dag("two_class")
    sched_r = R_wf.export_failure_schedule(spec_r, scen_r, seed=0,
                                           horizon_factor=60.0, **kw_r)
    sched_t = WorkflowSchedule.from_json(sched_r.to_json())
    knobs = dict(seconds_per_superstep=15.0, prior_mu=1 / 5400.0)
    rt = {n: R_exec.MixTask(dim=16, salt=i + 1) for i, n in enumerate(THREE)}
    tt = {n: MixTask(dim=16, salt=i + 1, device=CPU)
          for i, n in enumerate(THREE)}
    a = R_exec.WorkflowExecutor(spec_r, rt, sched_r, R_exec.ExecutorConfig(
        root=str(tmp_path / "r"), **knobs)).run()
    b = WorkflowExecutor(spec_t, tt, sched_t, _cfg(tmp_path / "t",
                                                   **knobs)).run()
    for n in THREE:
        for f in CONTROL:
            assert getattr(a.stages[n], f) == getattr(b.stages[n], f), (n, f)
    assert sum(s.n_restores for s in b.stages.values()) > 0

    def images(root):
        return [len(glob.glob(os.path.join(d, "step_*")))
                for d in glob.glob(os.path.join(str(root), "*", "*"))]

    assert max(images(tmp_path / "t")) == 2 < max(images(tmp_path / "r"))


def test_mix_task_matches_the_reference_task():
    rt = {n: R_exec.MixTask(dim=64, salt=i) for i, n in enumerate(THREE)}
    tt = {n: MixTask(dim=64, salt=i, device=CPU) for i, n in enumerate(THREE)}
    pr, pt = rt["prep"].init({}), tt["prep"].init({})
    for s in range(40):
        pr, pt = rt["prep"].step(pr, s), tt["prep"].step(pt, s)
    r2 = rt["train"].init({"prep": pr})
    t2 = tt["train"].init({"prep": pt})
    # a reference payload folds in as a dependency too
    t3 = tt["train"].init({"prep": pr})
    for k in r2:
        np.testing.assert_allclose(t2[k].numpy(), r2[k], rtol=1e-12, atol=0)
        np.testing.assert_allclose(t3[k].numpy(), r2[k], rtol=1e-12, atol=0)


def test_power_iteration_carried_across_from_the_jax_task():
    ref = R_exec.PowerIterTask(dim=64, seed=5)
    pr = ref.init({})
    pt = from_reference_payload(pr, device=CPU)
    assert pt["mat"].dtype == torch.float32 and pt["eig"].shape == ()
    task = PowerIterTask(dim=64, seed=5, device=CPU)
    for s in range(8):
        pr = ref.step(pr, s)
        pt = task.step(pt, s)
    np.testing.assert_allclose(pt["v"].numpy(), np.asarray(pr["v"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(pt["eig"]), float(pr["eig"]), rtol=1e-5)
    assert torch.equal(pt["mat"], torch.from_numpy(np.array(pr["mat"])))


# --------------------------------------------------------------------------- #
# Digital-twin headlines on the port: executor waste within the sim's band.   #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("form", ["homogeneous", "two_class"])
def test_digital_twin_parity(tmp_path, form):
    spec, scen, kw = _port_dag(form)
    pol = PolicyConfig(kind="adaptive", prior_mu=1 / 5400.0, prior_v=20.0)
    res = simulate_workflow(spec, scen, policy=pol, seeds=range(24),
                            V=20.0, T_d=50.0, device=CPU, draws="numpy", **kw)
    assert res.all_completed
    pw = predicted_waste(res)
    lo, mean, hi = waste_band(res)

    tasks = {n: MixTask(dim=16, salt=i + 1, device=CPU)
             for i, n in enumerate(THREE)}
    measured = []
    for seed in range(6):
        sched = export_failure_schedule(spec, scen, seed=seed,
                                        horizon_factor=60.0, **kw)
        cfg = _cfg(tmp_path / f"s{seed}", seconds_per_superstep=15.0,
                   V=20.0, T_d=50.0)
        rep = WorkflowExecutor(spec, tasks, sched, cfg).run()
        assert rep.completed, f"seed {seed} censored"
        measured.append(rep.total_waste)
    m = np.asarray(measured)
    tol = 3.0 * math.sqrt(np.var(pw, ddof=1) / pw.size
                          + np.var(m, ddof=1) / m.size)
    assert abs(float(m.mean()) - mean) <= tol, \
        f"executor mean {m.mean():.1f} vs sim mean {mean:.1f} (tol {tol:.1f})"
    assert lo <= float(m.mean()) <= hi, (lo, float(m.mean()), hi)
