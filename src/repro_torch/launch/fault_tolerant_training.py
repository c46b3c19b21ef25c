"""End-to-end driver: train a language model under churn with adaptive
checkpointing, and compare against fixed intervals (paper Eq. 11 on a REAL
training loop).  The port of ``examples/fault_tolerant_training.py``:

    PYTHONPATH=src python -m repro_torch.launch.fault_tolerant_training --preset ci [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.fault_tolerant_training --preset full

``full`` trains a ~100M-parameter OLMo-family model for a few hundred
steps; ``ci`` runs the olmo SMOKE config so the whole comparison finishes
in minutes on one CPU.  Node churn is injected on a virtual clock
(exponential lifetimes, Eq. 7 statistics); failures roll the job back to
the last committed checkpoint, exactly the paper's execution model
(Fig. 3).  The adaptive policy runs against fixed intervals of 60, 600 and
3,600 virtual seconds (relative runtime against adaptive), then a trainer
is killed halfway and a second one resumes from the checkpoint store; its
final loss must match an uninterrupted run's (``MATCH``).

Without ``--device`` it runs on CUDA (and raises where there is no card).
The weights are the port's seeded init (drawn on the CPU, the same on
every device).  Training runs attention through ``_attention_core``: the
flash-attention kernel has no backward.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
from typing import Dict, Optional, Sequence

from repro_torch.ckpt import AsyncCheckpointer
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import AttentionConfig, ModelConfig, RopeConfig
from repro_torch.data import DataConfig
from repro_torch.device import resolve_device
from repro_torch.runtime import (
    CheckpointPolicyConfig,
    FailureInjector,
    FaultTolerantTrainer,
)
from repro_torch.sim.network import constant_mtbf
from repro_torch.train.step import TrainState

FULL_100M = ModelConfig(
    name="olmo-100m",
    family="dense",
    n_layers=8,
    d_model=768,
    d_ff=3072,
    vocab=50304,
    attention=AttentionConfig(n_heads=12, n_kv_heads=12, head_dim=64,
                              rope=RopeConfig()),
    norm="nonparametric",
    act="silu_gated",
    tie_embeddings=True,
    remat="none",
)

NODES, MTBF, STEP_SECONDS = 64, 2700.0, 30.0   # 45 min MTBF, job ~42 s
V, T_D = 10.0, 25.0                             # virtual overheads


def _data(cfg: ModelConfig) -> DataConfig:
    return DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=3)


def _policy(kind: str, fixed: float, mtbf: float) -> CheckpointPolicyConfig:
    return CheckpointPolicyConfig(kind=kind, fixed_interval=fixed,
                                  prior_mtbf=mtbf, prior_v=10.0,
                                  min_interval=30.0)


def run(policy_kind: str, fixed: float, cfg: ModelConfig, steps: int,
        mtbf: float, step_seconds: float, seed: int, *, device=None,
        init_state: Optional[TrainState] = None) -> Dict[str, float]:
    """One trainer under churn (injector ``seed``), its summary.
    ``init_state`` replaces the seeded init (copied)."""
    tmp = tempfile.mkdtemp(prefix="ftt_")
    try:
        trainer = FaultTolerantTrainer(
            cfg, _data(cfg),
            ckpt=AsyncCheckpointer(tmp, n_shards=4),
            injector=FailureInjector(k=NODES, mtbf_fn=constant_mtbf(mtbf),
                                     seconds_per_step=step_seconds,
                                     seed=seed),
            policy=_policy(policy_kind, fixed, mtbf),
            virtual_ckpt_overhead=V, virtual_restore_time=T_D,
            init_state=init_state, device=device)
        try:
            rep = trainer.run(n_steps=steps)
        finally:
            trainer.ckpt.close()
        return {
            "virtual_hours": rep.virtual_time / 3600.0,
            "failures": rep.n_failures,
            "checkpoints": rep.n_checkpoints,
            "wasted_steps": rep.wasted_steps,
            "final_loss": rep.losses[-1] if rep.losses else float("nan"),
            "interval": rep.controller_interval,
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def kill_resume_demo(cfg: ModelConfig, steps: int, mtbf: float,
                     step_seconds: float, *, device=None) -> bool:
    """Survive a hard process death: trainer A is killed (abandoned without
    any shutdown) partway through, trainer B reopens the same checkpoint
    store with ``resume=True`` and finishes the job.  Determinism check:
    rollback + resume replay the same batches from committed state, so the
    final loss matches an uninterrupted fault-free run.  Returns whether
    it matched."""
    print(f"\n== kill -9 and resume ({steps} steps) ==", flush=True)
    tmp = tempfile.mkdtemp(prefix="ftt_resume_")
    kill_at = max(steps // 2, 1)
    ckpts = []
    try:
        def make(seed):
            ckpts.append(AsyncCheckpointer(tmp, n_shards=4))
            return FaultTolerantTrainer(
                cfg, _data(cfg), ckpt=ckpts[-1],
                injector=FailureInjector(k=NODES, mtbf_fn=constant_mtbf(mtbf),
                                         seconds_per_step=step_seconds,
                                         seed=seed),
                policy=_policy("adaptive", 0.0, mtbf),
                virtual_ckpt_overhead=V, virtual_restore_time=T_D,
                device=device)

        rep_a = make(seed=0).run(n_steps=kill_at)
        # Hard kill: no close(), no final checkpoint -- everything since the
        # last committed image is gone, exactly like a process death.
        print(f"trainer A killed after step {rep_a.steps_completed} "
              f"({rep_a.n_checkpoints} checkpoints committed)", flush=True)

        rep_b = make(seed=1).run(n_steps=steps, resume=True)
        print(f"trainer B resumed and finished: steps={rep_b.steps_completed} "
              f"failures={rep_b.n_failures} final_loss={rep_b.losses[-1]:.4f}",
              flush=True)
        if rep_b.steps_completed != steps:
            raise RuntimeError("resumed trainer fell short")

        # Fault-free reference: deterministic data + rollback replay mean the
        # resumed job's final state equals never having died.
        ref_tmp = tempfile.mkdtemp(prefix="ftt_ref_")
        try:
            ref_ckpt = AsyncCheckpointer(ref_tmp, n_shards=4)
            ref = FaultTolerantTrainer(
                cfg, _data(cfg), ckpt=ref_ckpt,
                policy=CheckpointPolicyConfig(kind="adaptive",
                                              prior_mtbf=mtbf, prior_v=10.0),
                device=device)
            try:
                rep_ref = ref.run(n_steps=steps)
            finally:
                ref_ckpt.close()
        finally:
            shutil.rmtree(ref_tmp, ignore_errors=True)
        match = abs(rep_ref.losses[-1] - rep_b.losses[-1]) < 1e-6
        print(f"final loss vs uninterrupted run: {rep_ref.losses[-1]:.4f} "
              f"-> {'MATCH' if match else 'MISMATCH'}", flush=True)
        return match
    finally:
        for c in ckpts:       # the killed trainer's writer thread too
            c.close()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=["ci", "full"], default="ci")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.preset == "full":
        cfg, steps = FULL_100M, args.steps or 300
    else:
        cfg, steps = get_smoke_config("olmo-1b"), args.steps or 40
    n_params = cfg.n_params_estimate
    print(f"model: {cfg.name} (~{n_params/1e6:.0f}M params), {steps} steps, "
          f"{NODES} nodes @ 45min MTBF (job MTBF ~42s virtual) on {dev}",
          flush=True)

    adaptive = run("adaptive", 0.0, cfg, steps, MTBF, STEP_SECONDS, seed=0,
                   device=dev)
    print(f"adaptive : {adaptive}", flush=True)
    out: Dict[str, object] = {"adaptive": adaptive}
    for fixed in (60.0, 600.0, 3600.0):
        r = run("fixed", fixed, cfg, steps, MTBF, STEP_SECONDS, seed=0,
                device=dev)
        rel = 100.0 * r["virtual_hours"] / adaptive["virtual_hours"]
        print(f"fixed {fixed:6.0f}s: {r}  -> relative runtime {rel:.1f}%",
              flush=True)
        out[f"fixed_{fixed:.0f}"] = dict(r, relative_runtime=rel)

    out["match"] = kill_resume_demo(cfg, steps, MTBF, STEP_SECONDS,
                                    device=dev)
    if not out["match"]:
        raise SystemExit("resume diverged from the uninterrupted reference")
    return out


if __name__ == "__main__":
    main()
