"""Prefill traffic: one client in a closed loop sends a request of
``batch`` prompts of ``prompt_len`` tokens, the ids uniform over the
configuration's ``token_vocab`` and fresh for each request, waits for the
reply (each prompt's greedy first token, read back to the host) and sends
the next.  Each request calls the serving entry point as a server does:
``make_prefill_step(cfg, max_seq)(params, batch)``, which allocates the
request's cache.

Set-up makes the weights, builds the step and runs ``warmup`` requests
of the same shapes, holding their outputs as the window holds those it
keeps for the check.  The check compares ``check_requests`` requests,
drawn from the seed among the first ``check_from`` of the window (whole
outputs kept for those only): the last position's logits and the cache
(the SSM state and conv carry, or the K and V), against the plain
reference run over the same prompts once the window has closed.
"""
from __future__ import annotations

import random
import time
from typing import Any, Dict, Optional

import torch
from torch.autograd.profiler import record_function

from harness import compare, counts, program
from harness.core import sub_seed
from reference.precision import Products

SPAN = "perfbench.prefill_step"


class Bench(program.Cell):
    first_unit = 0

    def __init__(self, cell, seed: int, device: str, scale: str):
        super().__init__(cell, seed, device, scale)
        self.kept: Dict[int, Dict[str, Any]] = {}
        if self.t["loop"] != "closed" or self.t["clients"] != 1:
            raise ValueError(f"{cell.name}: the prefill kind runs one "
                             f"client in a closed loop")
        if self.t["warmup"] <= self.t["check_requests"]:
            raise ValueError(f"{cell.name}: warm up more requests than the "
                             f"check keeps")

    # -- set-up ---------------------------------------------------------
    def tokens(self, i: int, tag: str = "request") -> torch.Tensor:
        return program.draw_tokens(
            self.seed, tag, i, (self.t["batch"], self.t["prompt_len"]),
            self.vocab, self.device)

    def setup(self) -> None:
        from repro_torch.serve.step import make_prefill_step

        self.model = program.load_model(self.cfg, self.weights(),
                                        self.ref.leaves(self.m))
        program.mark(self, "weights")
        self.step = make_prefill_step(self.cfg, max_seq=self.t["max_seq"])
        # The window holds the outputs of the ``check_requests`` sampled
        # requests beside the live one.  Holding the warm-up's outputs as
        # long leaves as many caches' blocks in the allocator's pool, so
        # that no request of the window waits on a fresh device allocation
        # (one such wait is 30-85 ms).
        held = [self._run(self.tokens(j, "warmup"))
                for j in range(self.t["warmup"])]
        program.mark(self, "warm-up")
        del held
        rng = random.Random(sub_seed(self.seed, "sample"))
        self.sample = set(rng.sample(range(self.t["check_from"]),
                                     self.t["check_requests"]))

    # -- the timed unit ---------------------------------------------------
    def _run(self, tokens: torch.Tensor):
        with record_function(SPAN):
            logits, cache = self.step(self.model, {"tokens": tokens})
        t_call = time.perf_counter()
        last = logits[:, -1]
        reply = torch.cat([last.argmax(-1),
                           torch.isfinite(last).all().long()[None]]).cpu()
        return logits, cache, t_call, reply

    def unit(self, i: int) -> Dict[str, Any]:
        tokens = self.tokens(i)
        t0 = time.perf_counter()
        logits, cache, t_call, reply = self._run(tokens)
        t1 = time.perf_counter()
        if i in self.sample:
            self.kept[i] = {"logits": logits[:, -1], "cache": cache}
        return {"t0": t0, "t_call": t_call, "t1": t1,
                "tokens": tokens.numel(), "ok": bool(reply[-1])}

    # -- counts -------------------------------------------------------------
    def unit_flops(self) -> float:
        return counts.forward_flops(self.m, self.t["batch"],
                                    self.t["prompt_len"], self.t["batch"])

    def kernel_work(self, kernel: str) -> Optional[Dict[str, float]]:
        """The yardstick's work of ``kernel`` in one request (None where
        the model has no layer that calls it)."""
        return counts.kernel_work(self.m, kernel, self.t["batch"],
                                  self.t["prompt_len"])

    # -- the check ----------------------------------------------------------
    def release(self) -> None:
        self.free("model", "step")

    def _program_view(self, out: Dict[str, Any]) -> Dict[str, Any]:
        """The program's outputs in the reference's terms."""
        cache, S = out["cache"], self.t["prompt_len"]
        got: Dict[str, Any] = {"logits": out["logits"]}
        if "ssm" in cache:
            got["state"] = list(cache["ssm"]["state"].unbind(0))
            got["conv"] = list(cache["ssm"]["conv"].unbind(0))
        if "kv" in cache:
            got["k"] = [t[:, :, :S] for t in cache["kv"]["k"].unbind(0)]
            got["v"] = [t[:, :, :S] for t in cache["kv"]["v"].unbind(0)]
        return got

    @staticmethod
    def numbers(got: Dict[str, Any], want: Dict[str, Any]
                ) -> Dict[str, float]:
        out = {"logits_rel_rms": compare.rel_rms(got["logits"],
                                                 want["logits"]),
               "token_gap": compare.token_gap(got["logits"],
                                              want["logits"])}
        for k, layers in want.items():
            if k != "logits":
                out[f"{k}_rel_rms"] = max(
                    compare.rel_rms(g, w) for g, w in zip(got[k], layers))
        return out

    def reference(self, weights, tokens, mode: str) -> Dict[str, Any]:
        return self.ref.prefill(weights, self.config, tokens,
                                Products(mode))

    def check(self, precision: str = "float32") -> Dict[str, float]:
        """The worst of each number over the sampled requests the window
        finished (``precision`` other than float32: the reference in that
        precision takes the program's place -- the control)."""
        if not self.kept:
            return {"requests_compared": float("inf")}
        weights = self.weights()
        worst: Dict[str, float] = {}
        for i in sorted(self.kept):
            tokens = self.tokens(i)
            want = self.reference(weights, tokens, "float32")
            got = self._program_view(self.kept[i]) if precision == \
                "float32" else self.reference(weights, tokens, precision)
            for k, v in self.numbers(got, want).items():
                worst[k] = max(worst.get(k, 0.0), v)
            del want, got
        return worst
