"""Learning-rate schedules (the port of ``repro/train/schedule.py``): pure
functions of the step, returning a float32 0-dim tensor on the step's
device."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr_scale: float = 1.0):
    return lambda step: torch.tensor(lr_scale, dtype=torch.float32,
                                     device=torch.as_tensor(step).device)


def linear_warmup_cosine(warmup_steps: int, total_steps: int,
                         min_scale: float = 0.1):
    """Warmup to 1.0 then cosine decay to min_scale."""

    def fn(step):
        step = _f32(step)
        c = step.new_tensor
        warm = step / c(max(warmup_steps, 1))
        prog = ((step - warmup_steps) / c(max(total_steps - warmup_steps, 1))
                ).clamp(0, 1)
        cos = min_scale + (1.0 - min_scale) * 0.5 * (
            1.0 + torch.cos(c(math.pi) * prog))
        return torch.where(step < warmup_steps, warm, cos)

    return fn


def inverse_sqrt(warmup_steps: int):
    def fn(step):
        step = _f32(step)
        c = step.new_tensor
        warm = step / c(max(warmup_steps, 1))
        decay = torch.sqrt(c(warmup_steps) / torch.clamp(step, min=warmup_steps))
        return torch.where(step < warmup_steps, warm, decay)

    return fn
