"""Quickstart: the adaptive checkpoint controller on a tiny training job.
The port of ``examples/quickstart.py``:

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

Trains the olmo-1b SMOKE config for 20 steps (SyntheticLM, 4 x 32 tokens,
AdamW 1e-3) while the paper's controller watches the step times, and
shows the online estimates (mu, V, T_d) driving the optimal interval
1/lambda*: the prior interval, the loss and interval every 5 steps, the
interval after 64 node lifetimes at twice the prior failure rate, and the
``UtilizationReport`` at the end.  The weights are the port's seeded init
(seed 0, drawn on the CPU); without ``--device`` it runs on CUDA (and
raises where there is no card).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core.adaptive import AdaptiveCheckpointController
from repro_torch.core.utilization import UtilizationReport
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.train import (AdamWConfig, constant, init_train_state,
                               make_train_step)


def main(argv: Optional[Sequence[str]] = None) -> UtilizationReport:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config("olmo-1b")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), constant(1.0))
    state = init_train_state(0, cfg, device=dev)

    # 256 nodes, 6h node MTBF -> job MTBF ~84s; checkpoint overhead ~8s.
    ctl = AdaptiveCheckpointController(k=256, prior_mu=1 / (6 * 3600.0),
                                       prior_v=8.0)
    print(f"prior interval 1/lambda* = {ctl.checkpoint_interval():8.1f}s")

    for i in range(20):
        t0 = time.monotonic()
        state, metrics = step(state, data.batch_at(i))
        loss = float(metrics["loss"])          # waits for the device
        ctl.observe_step(time.monotonic() - t0)
        if i % 5 == 0:
            print(f"step {i:3d} loss {loss:.4f} "
                  f"interval* {ctl.checkpoint_interval():8.1f}s")

    # Churn doubles -> interval shrinks (paper Fig. 4 right behaviour).
    rng = np.random.default_rng(0)
    for lt in rng.exponential(3 * 3600.0, size=64):
        ctl.observe_failure(max(lt, 1.0))
    print(f"after churn at 2x the prior rate: interval* = "
          f"{ctl.checkpoint_interval():8.1f}s")
    report = UtilizationReport.evaluate(ctl.mu, ctl.k, ctl.V, ctl.T_d)
    print(report)
    return report


if __name__ == "__main__":
    main()
