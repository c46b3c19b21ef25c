"""Fault-tolerant training loop with the paper's adaptive checkpointing (the
port of ``repro/runtime/trainer.py``).

Real train steps (:func:`repro_torch.train.step.make_train_step` over the
model library), wrapped in

    * the ADAPTIVE CHECKPOINT CONTROLLER (paper Sec 3) deciding *when* to
      checkpoint from online-estimated (mu, V, T_d);
    * an ASYNC sharded checkpointer (``ckpt/``) providing the mechanism;
    * a virtual-clock FAILURE INJECTOR (``runtime/failures.py``) producing
      exponential churn with the paper's k*mu statistics;
    * restart/rollback on failure: restore parameters, optimizer state and
      data position from the last committed checkpoint (the deterministic
      data stream makes the replay exact);
    * ELASTIC downsizing gated by the paper's U > 0 feasibility test;
    * STRAGGLER exclusion feeding the failure-rate estimator.

The control flow, the virtual-time accounting and the draws are the
reference's line for line.  The port's train step updates the state in
place, and a rollback copies the restored checkpoint into it.  The state
starts from the port's init -- ``seed`` an integer (drawn on the CPU) or a
``torch.Generator`` (drawn on its device: a full-width model's draws on
the card), the same weights every ``run`` -- or from ``init_state``
(copied, so every ``run`` starts from the same weights).  The ssm, dense
and moe families train; their hand-written kernels have no backward, so
training runs ``ssd_chunked`` and ``_attention_core``, and a config with
``use_flash_kernel=True`` is refused.

A rollback restores only images this run committed (or resumed from),
where the reference takes the newest image in the store: a directory
reused from an earlier run would otherwise hand back that run's later
steps.  ``restored_steps`` records what each in-run restore returned.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch.ckpt.async_ckpt import AsyncCheckpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.core.adaptive import AdaptiveCheckpointController
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.runtime.failures import (
    FailureInjector,
    SimulatedFailure,
    StragglerMonitor,
)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.schedule import constant
from repro_torch.train.step import (
    TrainState,
    init_train_state,
    make_train_step,
    require_trainable,
)


@dataclass
class CheckpointPolicyConfig:
    """'adaptive' (the paper) or 'fixed' (the baseline of [16])."""

    kind: str = "adaptive"           # 'adaptive' | 'fixed'
    fixed_interval: float = 600.0    # virtual seconds, for kind='fixed'
    prior_mtbf: float = 4 * 3600.0
    prior_v: float = 10.0
    min_interval: float = 1.0
    max_interval: float = 24 * 3600.0


@dataclass
class TrainerReport:
    steps_completed: int
    virtual_time: float
    n_failures: int
    n_checkpoints: int
    n_restarts: int
    wasted_steps: int
    final_k: int
    losses: List[float]
    controller_interval: float

    @property
    def utilization(self) -> float:
        return (self.steps_completed / max(self.virtual_time, 1e-9))


class FaultTolerantTrainer:
    """Single-process harness with production control flow."""

    def __init__(
        self,
        cfg: ModelConfig,
        data_cfg: DataConfig,
        *,
        ckpt: AsyncCheckpointer,
        injector: Optional[FailureInjector] = None,
        policy: CheckpointPolicyConfig = CheckpointPolicyConfig(),
        opt_cfg: AdamWConfig = AdamWConfig(lr=1e-3),
        n_microbatches: int = 1,
        seed: Union[int, torch.Generator] = 0,
        virtual_ckpt_overhead: Optional[float] = None,
        virtual_restore_time: Optional[float] = None,
        min_feasible_k: int = 1,
        init_state: Optional[TrainState] = None,
        device=None,
    ):
        require_trainable(cfg)
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.ckpt = ckpt
        self.injector = injector
        self.policy = policy
        self.k = injector.k if injector is not None else 1
        self.min_feasible_k = min_feasible_k
        self.controller = AdaptiveCheckpointController(
            k=self.k, prior_mu=1.0 / policy.prior_mtbf, prior_v=policy.prior_v,
            min_interval=policy.min_interval, max_interval=policy.max_interval)
        self.straggler = StragglerMonitor()
        # Virtual overheads: if not given, REAL measured save/restore times
        # are used (scaled 1:1 into virtual seconds).
        self.virtual_ckpt_overhead = virtual_ckpt_overhead
        self.virtual_restore_time = virtual_restore_time

        self.data = SyntheticLM(data_cfg)
        self.train_step = make_train_step(cfg, opt_cfg, constant(1.0),
                                          n_microbatches=n_microbatches)
        self._seed = seed
        # a generator's state at construction: every run draws from it
        self._seed_state = (seed.get_state()
                            if isinstance(seed, torch.Generator) else None)
        self._init_state = init_state
        self.device = (resolve_device(device) if init_state is None
                       else init_state.opt.step.device)
        # seconds of the last run's stages (host clock, synchronised)
        self.timings = {"step": [], "save_blocking": [], "write": [],
                        "restore": []}
        # the step each in-run restore of the last run returned (None: none)
        self.restored_steps: List[Optional[int]] = []

    # ------------------------------------------------------------------ #
    def _interval(self) -> float:
        if self.policy.kind == "fixed":
            return self.policy.fixed_interval
        return self.controller.checkpoint_interval()

    def _feed_observations(self):
        if self.injector is None:
            return
        for lt in self.injector.drain_observations():
            self.controller.observe_failure(lt)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fresh_state(self) -> TrainState:
        if self._init_state is not None:
            return self._init_state.clone()
        seed = self._seed
        if self._seed_state is not None:
            seed = torch.Generator(device=seed.device)
            seed.set_state(self._seed_state)
        return init_train_state(seed, self.cfg, self.device)

    # ------------------------------------------------------------------ #
    def run(self, n_steps: int, max_restarts: int = 1000,
            *, resume: bool = False) -> TrainerReport:
        """Train to ``n_steps``.  With ``resume=True`` the loop first
        restores the newest committed checkpoint (primary or any surviving
        replica) and continues from it: the process-death recovery path."""
        state = self._fresh_state()
        step = 0
        losses: List[float] = []
        n_fail = n_ckpt = n_restart = wasted = 0
        last_ckpt_vtime = 0.0
        committed_step = 0
        own_steps = set()       # the images this run may roll back to
        self.restored_steps = []
        if resume:
            restored = self.ckpt.restore_latest(state.tree())
            if restored is not None:
                committed_step, tree = restored
                state.load_tree(tree)
                step = committed_step
                own_steps.add(committed_step)

        vclock = lambda: (self.injector.virtual_time if self.injector else
                          float(step) * 1.0)

        while step < n_steps:
            batch = self.data.batch_at(step)
            t0 = time.monotonic()
            try:
                if self.injector is not None:
                    self.injector.advance_step()
                state, metrics = self.train_step(state, batch)
                loss = float(metrics["loss"])      # waits for the device
            except SimulatedFailure as f:
                # ---- failure: rollback to last committed checkpoint ----
                n_fail += 1
                self.controller.observe_failure(f.lifetime)
                self._feed_observations()
                restore_t0 = time.monotonic()
                restored = self.ckpt.restore_latest(state.tree(),
                                                    steps=own_steps)
                if restored is not None:
                    committed_step, tree = restored
                    state.load_tree(tree)
                self.restored_steps.append(
                    None if restored is None else committed_step)
                self._sync()
                real_restore = time.monotonic() - restore_t0
                self.timings["restore"].append(real_restore)
                t_d = (self.virtual_restore_time if self.virtual_restore_time
                       is not None else real_restore)
                if self.injector is not None:
                    self.injector.advance_seconds(t_d)
                self.controller.observe_restore(t_d)
                wasted += step - committed_step
                step = committed_step
                n_restart += 1
                if n_restart > max_restarts:
                    raise RuntimeError("too many restarts") from f
                # elastic: node permanently gone with p=0.5 -> shrink fleet
                rng = np.random.default_rng(n_restart)
                if self.injector is not None and rng.random() < 0.5 and self.k > self.min_feasible_k:
                    self.shrink_fleet(self.k - 1)
                continue

            real_dt = time.monotonic() - t0
            self.timings["step"].append(real_dt)
            step += 1
            losses.append(loss)
            self.controller.observe_step(real_dt)
            self._feed_observations()
            if self.straggler.observe(host=0, step_seconds=real_dt):
                # a flagged straggler counts as a departure event
                self.controller.observe_failure(self.straggler.ema * 10)

            # ---- checkpoint decision (the paper's core loop) -------------
            since_last = vclock() - last_ckpt_vtime
            if self.controller.should_checkpoint(since_last) if self.policy.kind == "adaptive" \
                    else since_last >= self.policy.fixed_interval:
                blocking = self.ckpt.save(step, state.tree())
                self.timings["save_blocking"].append(blocking)
                v = (self.virtual_ckpt_overhead if self.virtual_ckpt_overhead
                     is not None else blocking)
                if self.injector is not None:
                    self.injector.advance_seconds(v)
                self.controller.observe_checkpoint_overhead(v)
                n_ckpt += 1
                last_ckpt_vtime = vclock()
                self.ckpt.wait()  # commit before the next failure window
                self.timings["write"].append(self.ckpt.last_write_seconds)
                committed_step = step
                own_steps.add(step)

        self.ckpt.wait()
        self.state = state
        return TrainerReport(
            steps_completed=step, virtual_time=vclock(), n_failures=n_fail,
            n_checkpoints=n_ckpt, n_restarts=n_restart, wasted_steps=wasted,
            final_k=self.k, losses=losses,
            controller_interval=self._interval())

    # ------------------------------------------------------------------ #
    def shrink_fleet(self, new_k: int, *, rebatch: bool = False) -> None:
        """Elastic downsizing, gated by the paper's U>0 feasibility test.

        With ``rebatch=True`` the global batch is scaled with the fleet
        (constant per-node batch) and the data pipeline is rebuilt.
        """
        if new_k < self.min_feasible_k:
            return
        if not self.controller.feasible(new_k):
            # paper Sec 3.2.3: U==0 at this size -- refuse to run, keep
            # waiting for replacements instead of livelocking.
            return
        old_k = self.k
        self.k = new_k
        self.controller.k = new_k
        self.controller._invalidate()
        if self.injector is not None:
            self.injector.k = new_k
        if rebatch and new_k != old_k:
            new_batch = max(round(self.data_cfg.global_batch * new_k / old_k), 1)
            if new_batch != self.data_cfg.global_batch:
                self.data_cfg = dataclasses.replace(
                    self.data_cfg, global_batch=new_batch)
                self.data = SyntheticLM(self.data_cfg)
