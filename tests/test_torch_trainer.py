"""The port's fault-tolerant training runtime against the JAX package, on
the CPU.

* ``repro_torch.sim.network.ChurnNetwork`` and
  ``repro_torch.runtime.failures.FailureInjector`` / ``StragglerMonitor``
  against ``repro.sim.network`` and ``repro.runtime.failures`` on seeded
  streams: identical event times (bit for bit), slots, observations and
  raise points;
* ``repro_torch.ckpt``: the contracts of ``tests/test_ckpt.py`` as one
  parametrised test (bitwise round trip including bfloat16, uncommitted
  images ignored, corrupt and truncated shards fall through to a replica,
  no ``.part`` left, HRW placement, gc), plus snapshot isolation under the
  in-place updates of the port's train step, retention of the
  checkpointer's own images and restores limited to given steps;
* ``FaultTolerantTrainer`` on the mamba2 and olmo SMOKE configs in
  float32 with the fixed policy, the same injector seed and the same
  initial weights as ``repro.runtime.FaultTolerantTrainer``: equal counts
  (steps, failures, checkpoints, restarts, wasted steps, final fleet size)
  and virtual time, each loss within 1e-4 relative;
* the adaptive policy as ``tests/test_runtime.py`` holds it (survives
  failures, losses decrease, rollback, interval reacts to churn, elastic
  gating), which reads wall-clock step times and so cannot be compared
  step for step;
* ``repro_torch.launch.train --smoke --device cpu`` runs, leaves nothing
  behind without ``--ckpt-dir``, gives the same run twice in one
  directory (a rollback never reaches an earlier run's images), and
  training refuses ``use_flash_kernel=True``;
* ``repro_torch.launch.fault_tolerant_training`` against
  ``examples/fault_tolerant_training.py`` (loaded from its file): its
  ``run`` at the ``ci`` preset in float32 from the JAX package's initial
  weights, adaptive and fixed 60 s -- the same failures, checkpoints,
  wasted steps, virtual hours and interval, the final loss within 1e-4
  relative; its entry point on the CPU prints every policy line and the
  kill-and-resume ``MATCH``.
"""
import os
import shutil
import tempfile

import jax
import numpy as np
import pytest
import torch

import repro.configs as R_cfg
from repro.ckpt import AsyncCheckpointer as R_Ckpt
from repro.data import DataConfig as R_Data
from repro.runtime import (CheckpointPolicyConfig as R_Policy,
                           FailureInjector as R_Inj,
                           FaultTolerantTrainer as R_Trainer,
                           SimulatedFailure as R_Fail,
                           StragglerMonitor as R_Straggler)
from repro.sim import network as R_net
from repro.sim.scenarios import (PeerClass as R_PeerClass,
                                 PeerClassMix as R_Mix, ShockSpec as R_Shock,
                                 scenario as r_scenario)
from repro.train.step import init_train_state as r_init_train_state
import repro_torch.configs as T_cfg
from repro_torch.ckpt import (AsyncCheckpointer, latest_checkpoint,
                              list_checkpoints, load_pytree, save_pytree)
from repro_torch.data import DataConfig
from repro_torch.launch import train as T_launch
from repro_torch.p2p.overlay import rendezvous_placement
from repro_torch.runtime import (CheckpointPolicyConfig, FailureInjector,
                                 FaultTolerantTrainer, SimulatedFailure,
                                 StragglerMonitor)
from repro_torch.sim import network as T_net
from repro_torch.sim.scenarios import (PeerClass, PeerClassMix, ShockSpec,
                                       scenario)
from repro_torch.train import step as T_step

ARCH = "mamba2-130m"


# --------------------------------------------------------------------------- #
# Churn network, injector, straggler monitor                                   #
# --------------------------------------------------------------------------- #

def _nets(kind: str, seed: int):
    """The same network on both sides."""
    def mk(net_mod, scen_fn, Mix, PC, Shock):
        rng = np.random.default_rng(seed)
        if kind == "constant":
            return net_mod.ChurnNetwork(24, net_mod.constant_mtbf(900.0), rng)
        if kind == "doubling":
            return net_mod.ChurnNetwork(
                16, net_mod.doubling_mtbf(3000.0, double_after=5000.0), rng,
                slot_mults=[1.0 + (i % 3) for i in range(16)])
        mix = Mix((PC("stable"), PC("volatile", hazard_mult=3.0)), (0.5, 0.5))
        return net_mod.ChurnNetwork.from_scenario(
            scen_fn("weibull", scale=2000.0, shape=0.7), 32, rng, mix=mix,
            shock=Shock(rate=1e-3, kill_frac=0.4, scope="volatile"))
    return (mk(R_net, r_scenario, R_Mix, R_PeerClass, R_Shock),
            mk(T_net, scenario, PeerClassMix, PeerClass, ShockSpec))


@pytest.mark.parametrize("kind", ["constant", "doubling", "weibull_mix_shock"])
def test_churn_network_streams_are_the_reference_streams(kind):
    r, t = _nets(kind, seed=11)
    a = [r.next_death() for _ in range(300)]
    b = [t.next_death() for _ in range(300)]
    assert [(e.time, e.slot, e.lifetime) for e in a] == \
        [(e.time, e.slot, e.lifetime) for e in b]
    until = a[-1].time + 500.0
    assert [(e.time, e.slot) for e in r.deaths_until(until)] == \
        [(e.time, e.slot) for e in t.deaths_until(until)]
    assert r.peek_next_death_time() == t.peek_next_death_time()


def _drive(inj, Fail, n: int = 400):
    out = []
    for i in range(n):
        try:
            if i % 7 == 3:
                inj.advance_seconds(35.0)
            elif i % 11 == 5:
                inj.advance_exposed(20.0)
            else:
                inj.advance_step()
            out.append(("ok", inj.virtual_time))
        except Fail as f:
            out.append(("fail", f.at_virtual_time, f.slot, f.lifetime))
        out.append(("obs", tuple(inj.drain_observations())))
    return out


@pytest.mark.parametrize("mode", ["legacy", "legacy_shock", "scenario_mix"])
def test_failure_injector_is_the_reference_injector(mode):
    def kw(net_mod, scen_fn, Mix, PC, Shock):
        if mode == "legacy":
            return dict(k=6, mtbf_fn=net_mod.constant_mtbf(1200.0),
                        seconds_per_step=40.0, seed=5)
        if mode == "legacy_shock":
            return dict(k=4, mtbf_fn=net_mod.constant_mtbf(3000.0),
                        seconds_per_step=30.0, seed=6,
                        shock=Shock(rate=2e-3, kill_frac=0.5))
        return dict(k=5, seconds_per_step=50.0, seed=7, n_slots=40,
                    scenario=scen_fn("diurnal", mtbf=2000.0),
                    mix=Mix((PC("a"), PC("b", hazard_mult=2.5)), (0.6, 0.4)))
    r = R_Inj(**kw(R_net, r_scenario, R_Mix, R_PeerClass, R_Shock))
    t = FailureInjector(**kw(T_net, scenario, PeerClassMix, PeerClass,
                             ShockSpec))
    a, b = _drive(r, R_Fail), _drive(t, SimulatedFailure)
    assert a == b
    assert sum(x[0] == "fail" for x in b) > 3


def test_replay_mode_waits_for_the_digital_twin():
    """The replay mode came with the digital twin: ``schedule=`` and
    ``from_schedule`` replay a reference-built schedule as the reference's
    injector does (raise points, observations), no longer raising."""
    from repro.runtime.failures import build_stage_schedule as r_build
    from repro_torch.runtime.failures import WorkflowSchedule

    st = r_build(r_scenario("constant", mtbf=1500.0), k=4, seed=3,
                 horizon=40_000.0, n_slots=32,
                 shock=R_Shock(rate=5e-4, kill_frac=0.4))
    from repro.runtime.failures import WorkflowSchedule as R_Sched
    port = WorkflowSchedule.from_json(
        R_Sched(stages={"s": st}, seed=3).to_json()).stages["s"]
    for make in (lambda cls, s: cls(k=4, schedule=s, seconds_per_step=40.0),
                 lambda cls, s: cls.from_schedule(s, seconds_per_step=40.0)):
        a = _drive(make(R_Inj, st), R_Fail)
        b = _drive(make(FailureInjector, port), SimulatedFailure)
        assert a == b
        assert sum(x[0] == "fail" for x in b) > 3


def test_straggler_monitor_is_the_reference_monitor():
    rng = np.random.default_rng(2)
    times = np.where(rng.random(300) < 0.1, 9.0, 1.0) * rng.uniform(0.8, 1.2, 300)
    r, t = R_Straggler(deadline_factor=2.0, patience=2), \
        StragglerMonitor(deadline_factor=2.0, patience=2)
    for i, s in enumerate(times):
        host = i % 5
        assert r.observe(host, float(s)) == t.observe(host, float(s))
        assert r.ema == t.ema
    assert r.flagged == t.flagged and t.flagged


# --------------------------------------------------------------------------- #
# Checkpoint store and async checkpointer                                      #
# --------------------------------------------------------------------------- #

def _tree():
    rng = np.random.default_rng(0)
    return {
        "params/w": torch.from_numpy(rng.standard_normal((32, 16))
                                     .astype(np.float32)),
        "params/b": torch.from_numpy(rng.standard_normal(16).astype(
            np.float32)).to(torch.bfloat16),
        "opt/m": torch.ones(32, 16),
        "opt/step": torch.tensor(7, dtype=torch.int32),
    }


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _corrupt(path):
    for name in os.listdir(path):
        if name.startswith("shard_"):
            with open(os.path.join(path, name), "wb") as f:
                f.write(b"not a checkpoint shard")


def _truncate(path):
    for name in sorted(os.listdir(path)):
        if name.startswith("shard_"):
            shard = os.path.join(path, name)
            with open(shard, "r+b") as f:
                f.truncate(os.path.getsize(shard) // 2)
            return


CKPT_CASES = ["roundtrip", "latest_and_list", "uncommitted_ignored",
              "corruption_detected", "shape_and_dtype_mismatch",
              "async_restore", "replica_when_primary_gone",
              "replica_when_primary_corrupt", "replica_when_shard_truncated",
              "no_part_files", "replica_tmp_invisible", "hrw_placement", "gc",
              "snapshot_isolated_from_in_place_updates",
              "keep_drops_only_own_images", "restore_among_steps"]


@pytest.mark.parametrize("case", CKPT_CASES)
def test_checkpoint_contracts(case, tmp_path):
    tree, root = _tree(), str(tmp_path / "p")
    if case == "roundtrip":
        path = save_pytree(root, 5, tree, n_shards=3)
        assert os.path.basename(path) == "step_00000005"
        _same(load_pytree(path, tree), tree)
    elif case == "latest_and_list":
        for s in (1, 3, 2):
            save_pytree(root, s, tree)
        assert [s for s, _ in list_checkpoints(root)] == [1, 2, 3]
        assert latest_checkpoint(root)[0] == 3
    elif case == "uncommitted_ignored":
        path = save_pytree(root, 1, tree)
        os.remove(os.path.join(path, "COMMITTED"))
        assert list_checkpoints(root) == []
        with pytest.raises(FileNotFoundError):
            load_pytree(path, tree)
    elif case == "corruption_detected":
        path = save_pytree(root, 1, tree, n_shards=1)
        shard = os.path.join(path, "shard_0.npz")
        data = dict(np.load(shard))
        key = sorted(data)[0]
        data[key] = data[key] + 1
        np.savez(shard, **data)
        with pytest.raises((IOError, ValueError)):
            load_pytree(path, tree, verify=True)
    elif case == "shape_and_dtype_mismatch":
        path = save_pytree(root, 1, tree)
        with pytest.raises(ValueError):
            load_pytree(path, dict(tree, **{"params/w": torch.zeros(8, 8)}))
        with pytest.raises(ValueError):
            load_pytree(path, dict(tree, **{"params/b": torch.zeros(16)}))
    elif case == "no_part_files":
        path = save_pytree(root, 1, tree, n_shards=3)
        assert sorted(os.listdir(path)) == [
            "COMMITTED", "manifest.json", "shard_0.npz", "shard_1.npz",
            "shard_2.npz"]
    else:
        _async_case(case, tree, root, tmp_path)


def _async_case(case, tree, root, tmp_path):
    reps = [str(tmp_path / f"rep{i}") for i in range(4)]
    if case == "async_restore":
        ck = AsyncCheckpointer(root, n_shards=2)
        assert ck.save(1, tree) < 5.0
        ck.save(2, {k: v * 2 for k, v in tree.items()})
        ck.wait()
        step, out = ck.restore_latest(tree)
        assert step == 2
        _same(out, {k: v * 2 for k, v in tree.items()})
    elif case.startswith("replica_when"):
        ck = AsyncCheckpointer(root, replicas=reps[:2], n_shards=2)
        ck.save(4, tree)
        ck.wait()
        assert all(latest_checkpoint(r) is not None for r in reps[:2])
        _, path = latest_checkpoint(root)
        if case == "replica_when_primary_gone":
            shutil.rmtree(root)
            os.makedirs(root)
        elif case == "replica_when_primary_corrupt":
            _corrupt(path)
        else:
            _truncate(path)
            with pytest.raises(Exception):
                load_pytree(path, tree)
        step, out = ck.restore_latest(tree)
        assert step == 4
        _same(out, tree)
    elif case == "replica_tmp_invisible":
        ck = AsyncCheckpointer(root, n_shards=1)
        ck.save(1, tree)
        ck.wait()
        os.makedirs(reps[0])
        shutil.copytree(latest_checkpoint(root)[1],
                        os.path.join(reps[0], "step_00000001.tmp"))
        assert list_checkpoints(reps[0]) == []
    elif case == "hrw_placement":
        ck = AsyncCheckpointer(root, replicas=reps, replication_factor=2,
                               n_shards=1)
        for step in (1, 2):
            ck.save(step, tree)
        ck.wait()
        for step in (1, 2):
            chosen = rendezvous_placement(f"step_{step}", reps, 2)
            for r in reps:
                holds = any(s == step for s, _ in list_checkpoints(r))
                assert holds == (r in chosen), (step, r)
        shutil.rmtree(root)
        os.makedirs(root)
        assert ck.restore_latest(tree)[0] == 2
    elif case == "gc":
        ck = AsyncCheckpointer(root, n_shards=1)
        for s in range(6):
            ck.save(s, tree)
        ck.wait()
        ck.gc(keep=2)
        assert [s for s, _ in list_checkpoints(root)] == [4, 5]
    elif case == "snapshot_isolated_from_in_place_updates":
        ck = AsyncCheckpointer(root, n_shards=2)
        live = {k: v.clone() for k, v in tree.items()}
        ck.save(1, live)
        for v in live.values():           # the train step's in-place update
            v.add_(1)
        ck.wait()
        _same(ck.restore_latest(tree)[1], tree)
    elif case == "keep_drops_only_own_images":
        save_pytree(root, 99, tree)                 # an earlier run's image
        ck = AsyncCheckpointer(root, replicas=reps[:1], n_shards=1, keep=2)
        for s in range(6):
            ck.save(s, tree)
            ck.wait()
        for r in (root, reps[0]):
            assert [s for s, _ in list_checkpoints(r)] == (
                [4, 5, 99] if r == root else [4, 5])
        with pytest.raises(ValueError):
            AsyncCheckpointer(root, keep=0)
    elif case == "restore_among_steps":
        ck = AsyncCheckpointer(root, replicas=reps[:1], n_shards=1)
        for s in (1, 2, 3):
            ck.save(s, {k: v + s for k, v in tree.items()})
        ck.wait()
        step, out = ck.restore_latest(tree, steps={1, 2})
        assert step == 2
        _same(out, {k: v + 2 for k, v in tree.items()})
        assert ck.restore_latest(tree, steps=set()) is None
    else:
        raise AssertionError(case)
    ck.close()


# --------------------------------------------------------------------------- #
# The trainer                                                                  #
# --------------------------------------------------------------------------- #

PARITY = dict(k=8, mtbf=1500.0, steps_per=200.0, seed=3, steps=12)


def _parity_kw(side):
    inj_cls, mtbf, Policy = ((R_Inj, R_net.constant_mtbf, R_Policy)
                             if side == "jax" else
                             (FailureInjector, T_net.constant_mtbf,
                              CheckpointPolicyConfig))
    return dict(
        injector=inj_cls(k=PARITY["k"], mtbf_fn=mtbf(PARITY["mtbf"]),
                         seconds_per_step=PARITY["steps_per"],
                         seed=PARITY["seed"]),
        policy=Policy(kind="fixed", fixed_interval=600.0,
                      prior_mtbf=PARITY["mtbf"], prior_v=5.0,
                      min_interval=30.0),
        virtual_ckpt_overhead=5.0, virtual_restore_time=12.0)


def _f32(cfg):
    return cfg.replace(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def jax_parity_run(tmp_path_factory):
    """The JAX trainer's run on an arch's SMOKE config (cached: it is the
    slow half) and its initial state as numpy arrays."""
    runs = {}

    def run(arch):
        if arch not in runs:
            cfg = _f32(R_cfg.get_smoke_config(arch))
            data = R_Data(vocab=cfg.vocab, seq_len=16, global_batch=4,
                          seed=1)
            ck = R_Ckpt(str(tmp_path_factory.mktemp("jax_ckpt")), n_shards=2)
            tr = R_Trainer(cfg, data, ckpt=ck, **_parity_kw("jax"))
            report = tr.run(n_steps=PARITY["steps"])
            ck.close()
            init = jax.tree.map(np.asarray,
                                r_init_train_state(jax.random.key(0), cfg))
            runs[arch] = report, init
        return runs[arch]

    return run


@pytest.mark.parametrize("arch", [ARCH, "olmo-1b"])
def test_trainer_matches_reference_trainer(jax_parity_run, tmp_path, arch):
    want, init_np = jax_parity_run(arch)
    cfg = _f32(T_cfg.get_smoke_config(arch))
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=1)
    ck = AsyncCheckpointer(str(tmp_path / "ckpt"), n_shards=2)
    tr = FaultTolerantTrainer(
        cfg, data, ckpt=ck, device="cpu",
        init_state=T_step.from_reference(init_np, cfg, device="cpu"),
        **_parity_kw("torch"))
    got = tr.run(n_steps=PARITY["steps"])
    ck.close()
    for f in ("steps_completed", "n_failures", "n_checkpoints", "n_restarts",
              "wasted_steps", "final_k", "virtual_time"):
        assert getattr(got, f) == getattr(want, f), f
    assert want.n_restarts > 0 and want.n_checkpoints > 0
    assert len(got.losses) == len(want.losses)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)


def _trainer(tmp_path, *, mtbf=3000.0, kind="adaptive", fixed=600.0,
             steps_per=60.0, seed=0):
    """``tests/test_runtime.py``'s trainer on the mamba2 SMOKE config."""
    cfg = T_cfg.get_smoke_config(ARCH)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=1)
    inj = FailureInjector(k=8, mtbf_fn=T_net.constant_mtbf(mtbf),
                          seconds_per_step=steps_per, seed=seed)
    ck = AsyncCheckpointer(str(tmp_path / "ckpt"), n_shards=2)
    policy = CheckpointPolicyConfig(kind=kind, fixed_interval=fixed,
                                    prior_mtbf=mtbf, prior_v=5.0,
                                    min_interval=30.0)
    return FaultTolerantTrainer(
        cfg, data_cfg, ckpt=ck, injector=inj, policy=policy, device="cpu",
        virtual_ckpt_overhead=5.0, virtual_restore_time=12.0)


def test_adaptive_training_survives_failures_and_learns(tmp_path):
    tr = _trainer(tmp_path, mtbf=2000.0, steps_per=120.0)
    report = tr.run(n_steps=30)
    assert report.steps_completed == 30
    assert report.n_failures > 0 and report.n_checkpoints > 0
    assert all(np.isfinite(report.losses))
    assert np.mean(report.losses[-8:]) < np.mean(report.losses[:8])
    tr.ckpt.close()


def test_rollback_restarts_and_resume(tmp_path):
    tr = _trainer(tmp_path, mtbf=1500.0, steps_per=200.0, seed=3)
    report = tr.run(n_steps=20)
    assert report.n_restarts > 0 and report.steps_completed == 20
    # a restarted process resumes from the newest committed image
    step, tree = tr.ckpt.restore_latest(tr.state.tree())
    resumed = tr.run(n_steps=step + 1, resume=True)
    assert resumed.steps_completed == step + 1
    tr.ckpt.close()


def test_adaptive_interval_reacts_to_churn(tmp_path):
    calm = _trainer(tmp_path / "calm", mtbf=50000.0, steps_per=60.0)
    churn = _trainer(tmp_path / "churn", mtbf=800.0, steps_per=60.0, seed=5)
    calm_r, churn_r = calm.run(n_steps=25), churn.run(n_steps=25)
    assert churn_r.controller_interval < calm_r.controller_interval
    calm.ckpt.close()
    churn.ckpt.close()


def test_elastic_shrink_respects_feasibility_and_rebatches(tmp_path):
    tr = _trainer(tmp_path, mtbf=50000.0)
    k0, b0 = tr.k, tr.data_cfg.global_batch
    tr.shrink_fleet(k0 - 2)
    assert tr.k == tr.controller.k == tr.injector.k == k0 - 2
    tr.controller.ingest_gossip(mu=1.0, V=100.0, T_d=100.0, weight=1.0)
    tr.shrink_fleet(tr.k - 1)              # U = 0 there: refused
    assert tr.k == k0 - 2
    tr2 = _trainer(tmp_path / "b", mtbf=50000.0)
    tr2.shrink_fleet(k0 // 2, rebatch=True)
    assert tr2.data_cfg.global_batch == max(round(b0 * 0.5), 1)
    assert tr2.data.batch_at(0)["tokens"].shape[0] == tr2.data_cfg.global_batch
    tr.ckpt.close()
    tr2.ckpt.close()


def test_launch_train_smoke_on_cpu(tmp_path, capsys):
    report = T_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--steps", "6", "--seq", "16", "--batch", "4",
                            "--ckpt-dir", str(tmp_path / "ck"), "--keep", "1"])
    assert report.steps_completed == 6
    assert "steps=6" in capsys.readouterr().out
    assert len(list_checkpoints(str(tmp_path / "ck"))) <= 1


def test_launch_train_default_ckpt_dir_is_temporary(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    report = T_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--steps", "3", "--seq", "16", "--batch", "4",
                            "--policy", "fixed", "--fixed-interval", "0"])
    assert report.n_checkpoints == 3
    assert os.listdir(tmp_path) == []


def test_launch_train_twice_in_one_directory(tmp_path):
    """A second run in the same directory is the first run again: its
    rollbacks restore its own images, never the earlier run's later steps."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "12",
            "--seq", "16", "--batch", "4", "--policy", "fixed",
            "--fixed-interval", "300", "--mtbf", "1500", "--nodes", "8",
            "--step-seconds", "200", "--injector-seed", "3",
            "--virtual-ckpt-overhead", "5", "--virtual-restore-time", "12",
            "--ckpt-dir", str(tmp_path / "ck")]
    first = T_launch.main(argv)
    assert first.n_checkpoints > 0 and first.wasted_steps > 0
    second = T_launch.main(argv)
    assert second.__dict__ == first.__dict__


def test_training_refuses_the_ssd_kernel(tmp_path, capsys):
    cfg = T_cfg.get_smoke_config(ARCH).replace(use_flash_kernel=True)
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    with pytest.raises(ValueError, match="use_flash_kernel=False"):
        FaultTolerantTrainer(cfg, data, device="cpu",
                             ckpt=AsyncCheckpointer(str(tmp_path / "c")))
    # the entry point trains the serving CONFIG with the knob off, and says so
    full = T_cfg.get_config(ARCH)
    assert full.use_flash_kernel
    assert not T_launch.training_config(full).use_flash_kernel
    assert "use_flash_kernel=False" in capsys.readouterr().out


# --------------------------------------------------------------------------- #
# The fault-tolerant-training example                                          #
# --------------------------------------------------------------------------- #

FTT_STEPS = 6


@pytest.fixture(scope="module")
def ftt_example():
    """``examples/fault_tolerant_training.py`` (the JAX package's)."""
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parents[1] / "examples"
            / "fault_tolerant_training.py")
    spec = importlib.util.spec_from_file_location("ftt_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind,fixed", [("adaptive", 0.0), ("fixed", 60.0)])
def test_fault_tolerant_training_matches_the_example(ftt_example, kind, fixed):
    """The port's ``run`` against the example's at the ``ci`` preset
    (float32, both sides from the JAX package's initial weights): the same
    failures, checkpoints, wasted steps and virtual hours, the final loss
    within 1e-4."""
    from repro_torch.launch import fault_tolerant_training as T_ftt

    rcfg = _f32(R_cfg.get_smoke_config("olmo-1b"))
    tcfg = _f32(T_cfg.get_smoke_config("olmo-1b"))
    assert (T_ftt.NODES, T_ftt.MTBF, T_ftt.STEP_SECONDS) == (64, 2700.0, 30.0)
    want = ftt_example.run(kind, fixed, rcfg, FTT_STEPS, T_ftt.MTBF,
                           T_ftt.STEP_SECONDS, seed=0)
    init = jax.tree.map(np.asarray, r_init_train_state(jax.random.key(0),
                                                       rcfg))
    got = T_ftt.run(kind, fixed, tcfg, FTT_STEPS, T_ftt.MTBF,
                    T_ftt.STEP_SECONDS, seed=0, device="cpu",
                    init_state=T_step.from_reference(init, tcfg,
                                                     device="cpu"))
    for k in ("failures", "checkpoints", "wasted_steps", "virtual_hours",
              "interval"):
        assert got[k] == want[k], k
    assert want["failures"] > 0 and want["checkpoints"] > 0
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-4)


def test_fault_tolerant_training_entry_point_on_cpu(capsys):
    from repro_torch.launch import fault_tolerant_training as T_ftt

    out = T_ftt.main(["--preset", "ci", "--device", "cpu", "--steps",
                      str(FTT_STEPS)])
    text = capsys.readouterr().out
    assert out["match"] and "-> MATCH" in text
    assert "adaptive :" in text
    for fixed in (60, 600, 3600):
        assert f"fixed {fixed:6d}s:" in text
        assert out[f"fixed_{fixed}"]["relative_runtime"] > 0
