"""Training traffic: the train step of the configuration, stepped back to
back on a global batch of ``batch`` sequences of ``seq`` tokens in
``microbatches``, AdamW with the file's hyper-parameters and a constant
schedule.  Each step's tokens and labels (the next token) are drawn from
the seed and the step's index, so every row differs; the loss is read
back every step, as a trainer's loop reads it.  No checkpoint is written.

Set-up builds one training state (the model holding the benchmark's
weights, ``requires_grad``, and a fresh AdamW state) and the step, and
drives it through the first ``check_steps`` steps with the window's own
call and feed; those are the warm-up.  From them it keeps each leaf's
first gradient as the optimizer took it (the first moment after one step
over (1 - b1), over the clip factor of the step's reported norm) and each
leaf's change after the last (the float32 master against the start).  The
window continues the same state from the next step.  The check runs the
plain reference over the same batches from the same weights and compares
each step's loss, the gradient norms and the changes, leaf by leaf.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

import torch
from torch.autograd.profiler import record_function

from harness import compare, counts, program
from reference.precision import Products

SPAN = "perfbench.train_step"


class Bench(program.Cell):
    def __init__(self, cell, seed: int, device: str, scale: str):
        super().__init__(cell, seed, device, scale)
        # the serving kernels have no backward: training runs the plain
        # forms, as the port's trainer does (launch/train.py)
        self.cfg = dataclasses.replace(self.cfg, use_flash_kernel=False)
        self.first_unit = int(self.t["check_steps"])
        if self.t["schedule"] != "constant":
            raise ValueError(f"{cell.name}: the train kind runs a constant "
                             f"schedule, not {self.t['schedule']!r}")

    def batch(self, i: int):
        seq = program.draw_tokens(self.seed, "step", i,
                                  (self.t["batch"], self.t["seq"] + 1),
                                  self.vocab, self.device)
        return seq[:, :-1].contiguous(), seq[:, 1:].contiguous()

    def setup(self) -> None:
        from repro_torch.train.optimizer import AdamWConfig, init_adamw
        from repro_torch.train.schedule import constant
        from repro_torch.train.step import TrainState, make_train_step

        o = self.t["optimizer"]
        self.opt_cfg = AdamWConfig(
            lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
            weight_decay=o["weight_decay"], grad_clip=o["grad_clip"],
            no_decay_substrings=tuple(o["no_decay"]))
        weights = self.weights()
        start = {k: v.clone() for k, v in weights.items()}
        model = program.load_model(self.cfg, weights,
                                   self.ref.leaves(self.m))
        model.requires_grad_(True)
        self.state = TrainState(params=model, opt=init_adamw(
            dict(model.named_parameters())))
        program.mark(self, "weights and state")
        self.step = make_train_step(self.cfg, self.opt_cfg, constant(),
                                    n_microbatches=self.t["microbatches"])
        self.losses: List[float] = []
        for i in range(self.first_unit):
            rec = self.unit(i)
            program.mark(self, f"step {i}")
            if i == 0:
                clip = min(1.0, o["grad_clip"] / max(rec["grad_norm"],
                                                     1e-12))
                self.grad_norms = {
                    k: float(torch.linalg.vector_norm(m)) /
                    ((1 - o["b1"]) * clip)
                    for k, m in self.state.opt.m.items()}
        with torch.no_grad():
            self.change = {k: float(torch.linalg.vector_norm(
                self.state.opt.master[k] - start[k].float()))
                for k in start}
        del start

    def unit(self, i: int) -> Dict[str, Any]:
        tokens, labels = self.batch(i)
        t0 = time.perf_counter()
        with record_function(SPAN):
            self.state, metrics = self.step(
                self.state, {"tokens": tokens, "labels": labels})
        t_call = time.perf_counter()
        loss = float(metrics["loss"])
        t1 = time.perf_counter()
        rec = {"t0": t0, "t_call": t_call, "t1": t1,
               "tokens": tokens.numel(), "ok": loss == loss
               and abs(loss) != float("inf")}
        if i < self.first_unit:
            self.losses.append(loss)
            rec["grad_norm"] = float(metrics["grad_norm"])
        return rec

    def unit_flops(self) -> float:
        return counts.train_step_flops(self.m, self.t["batch"], self.t["seq"])

    def kernel_work(self, kernel: str) -> None:
        """No port kernel runs in training (the plain forms run)."""
        return None

    def release(self) -> None:
        self.free("state", "step")

    def reference(self, mode: str) -> Dict[str, Any]:
        o = dict(self.t["optimizer"])
        batches = [self.batch(i) for i in range(self.first_unit)]
        return self.ref.train_steps(self.weights(), self.config, batches, o,
                                    Products(mode))

    def numbers(self, got: Dict[str, Any], want: Dict[str, Any]
                ) -> Dict[str, float]:
        """The worst step's loss gap (relative), and the worst leaf's gap
        of the first gradient's norm and of the change's norm.  Leaves
        whose reference gradient is under a thousandth of the median
        leaf's move by round-off alone and are left out of the change."""
        loss = max(abs(g - w) / abs(w) for g, w in
                   zip(got["losses"], want["losses"]))
        gn = want["grad_norms"]
        med = sorted(gn.values())[len(gn) // 2]
        keep = {k: v >= 1e-3 * med for k, v in gn.items()}
        return {"loss_gap": loss,
                "grad_gap": compare.worst_leaf_gap(got["grad_norms"], gn),
                "change_gap": compare.worst_leaf_gap(got["change"],
                                                     want["change"], keep)}

    def check(self, precision: str = "float32") -> Dict[str, float]:
        want = self.reference("float32")
        got = {"losses": self.losses, "grad_norms": self.grad_norms,
               "change": self.change} if precision == "float32" \
            else self.reference(precision)
        return self.numbers(got, want)
