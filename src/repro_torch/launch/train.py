"""Training entry point of the port (single-process execution of the
production stack):

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --steps 20 [--smoke] [--device cpu] [--ckpt-dir DIR] --mtbf 3600

Runs the fault-tolerant trainer: real train steps, adaptive checkpointing
(the paper's controller), virtual-clock failure injection, restart from
the sharded checkpoint store.  ``--smoke`` selects the reduced config;
without ``--device`` it runs on CUDA (and raises where there is no card).
The weights come from the port's init with a generator of seed 0 on the
run's device (on the card the draws are made there, as
``launch/serve.py`` makes them; on the CPU they are the seeded init's).
The flags are the JAX entry point's, plus ``--device``, ``--lr`` (the
trainer's AdamW rate, 1e-3 by default as in the JAX package),
``--injector-seed``, ``--keep`` (checkpoint images of the full models are
1.8 GB for mamba2-130m, 16.5 GB for olmo-1b) and the fixed virtual
overheads ``--virtual-ckpt-overhead`` and ``--virtual-restore-time`` (by
default the measured seconds count).  Without ``--ckpt-dir`` the images go
to a fresh temporary directory that is removed at the end; with it,
replicas go to ``DIR_rep0``, ... beside it.

The ssm, dense, moe and hybrid archs train here (mamba2-130m; olmo-1b,
gemma2-27b, stablelm-1.6b, starcoder2-3b, qwen2-vl-7b; olmoe-1b-7b,
deepseek-moe-16b; zamba2-7b).  Neither hand-written kernel of
their serving paths has a backward, so training runs the SSD through
``ssd_chunked`` and attention through ``_attention_core``, as the JAX
package trains them: a config with ``use_flash_kernel=True`` (the port's
serving ``CONFIG``) is trained with the knob off, and the entry point says
so.  The encdec arch (whisper-large-v3) is refused: its loss needs the
audio frames, ``SyntheticLM`` makes tokens only, and the JAX entry point
feeds none either.  ``repro_torch.train.step.make_train_step`` trains it
on a batch that carries 'frames'.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.ckpt import AsyncCheckpointer
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig
from repro_torch.device import resolve_device
from repro_torch.runtime import (
    CheckpointPolicyConfig,
    FailureInjector,
    FaultTolerantTrainer,
    TrainerReport,
)
from repro_torch.sim.network import constant_mtbf
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import require_trainable_family, serving_kernel


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "one, removed at the end)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="neighbour checkpoint replicas")
    ap.add_argument("--policy", choices=["adaptive", "fixed"], default="adaptive")
    ap.add_argument("--fixed-interval", type=float, default=600.0)
    ap.add_argument("--mtbf", type=float, default=4 * 3600.0,
                    help="per-node MTBF (virtual seconds)")
    ap.add_argument("--nodes", type=int, default=64)
    ap.add_argument("--step-seconds", type=float, default=20.0,
                    help="virtual seconds per step for the churn clock")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--lr", type=float, default=1e-3,
                    help="AdamW learning rate (constant schedule)")
    ap.add_argument("--injector-seed", type=int, default=0)
    ap.add_argument("--keep", type=int, default=None,
                    help="keep only this run's newest N checkpoints "
                         "(default: all)")
    ap.add_argument("--virtual-ckpt-overhead", type=float, default=None,
                    help="virtual seconds a checkpoint costs (default: the "
                         "measured blocking seconds)")
    ap.add_argument("--virtual-restore-time", type=float, default=None,
                    help="virtual seconds a restore costs (default: the "
                         "measured seconds)")
    return ap


def training_config(cfg: ModelConfig) -> ModelConfig:
    """The config training runs: the serving kernel off (the SSD and the
    flash-attention kernels have no backward).  The families not ported
    yet are refused."""
    require_trainable_family(cfg)
    if cfg.use_flash_kernel:
        why, plain = serving_kernel(cfg)
        print(f"use_flash_kernel=False: training runs {plain} ({why})")
        cfg = dataclasses.replace(cfg, use_flash_kernel=False)
    return cfg


def build(args) -> Tuple[FaultTolerantTrainer, AsyncCheckpointer]:
    """The trainer and checkpointer the command line describes."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "encdec":
        raise ValueError(
            f"{args.arch}: an encdec train step needs batch['frames'] (the "
            f"audio frame embeddings), and SyntheticLM makes tokens only; "
            f"the JAX entry point feeds none either.  Train it through "
            f"repro_torch.train.step.make_train_step with frames in the "
            f"batch")
    dev = resolve_device(args.device)
    cfg = training_config(cfg)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    ckpt = AsyncCheckpointer(
        args.ckpt_dir,
        replicas=[f"{args.ckpt_dir}_rep{i}" for i in range(args.replicas)],
        n_shards=4, keep=args.keep)
    injector = FailureInjector(k=args.nodes, mtbf_fn=constant_mtbf(args.mtbf),
                               seconds_per_step=args.step_seconds,
                               seed=args.injector_seed)
    trainer = FaultTolerantTrainer(
        cfg, data_cfg, ckpt=ckpt, injector=injector,
        seed=torch.Generator(device=dev).manual_seed(0),
        policy=CheckpointPolicyConfig(kind=args.policy,
                                      fixed_interval=args.fixed_interval,
                                      prior_mtbf=args.mtbf),
        opt_cfg=AdamWConfig(lr=args.lr),
        n_microbatches=args.microbatches, device=dev,
        virtual_ckpt_overhead=args.virtual_ckpt_overhead,
        virtual_restore_time=args.virtual_restore_time)
    return trainer, ckpt


def summary(report: TrainerReport) -> str:
    return (f"steps={report.steps_completed} virtual_hours="
            f"{report.virtual_time / 3600:.2f} failures={report.n_failures} "
            f"checkpoints={report.n_checkpoints} restarts={report.n_restarts} "
            f"final_loss={report.losses[-1] if report.losses else float('nan'):.4f} "
            f"interval*={report.controller_interval:.0f}s")


def main(argv: Optional[Sequence[str]] = None) -> TrainerReport:
    args = parser().parse_args(argv)
    scratch = None
    if args.ckpt_dir is None:
        scratch = tempfile.mkdtemp(prefix="repro_ckpt_")
        args.ckpt_dir = os.path.join(scratch, "ckpt")
    try:
        trainer, ckpt = build(args)
        try:
            report = trainer.run(n_steps=args.steps)
        finally:
            ckpt.close()
    finally:
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)
    print(summary(report))
    return report


if __name__ == "__main__":
    main()
