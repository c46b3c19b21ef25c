"""AdamW from scratch (the port of ``repro/train/optimizer.py:1-108``).

Layout: model parameters live in ``param_dtype`` (bf16 by default); the
optimizer state holds an fp32 master copy plus Adam moments.  Updates:
grads -> fp32, Adam math in fp32, master update, parameters re-cast to
``param_dtype`` (:func:`params_from_master`).

The port's parameter "pytree" is a flat mapping of the model's parameter
names (``blocks.3.mixer.a_log``) to tensors; the no-decay substrings are
matched against those names, as the JAX package matches its key paths
(``blocks/mixer/a_log``).  Every division is by a tensor (IEEE division on
every device; on CUDA a division by a Python float multiplies by its
reciprocal).  The ZeRO-1 sharding of the state (``zero1_spec``,
``zero1_state_shardings``) waits for ROADMAP Queue 1 item 6.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, NamedTuple, Tuple, Union

import torch

Params = Mapping[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor                 # () int32
    master: Dict[str, torch.Tensor]    # fp32 master copy
    m: Dict[str, torch.Tensor]         # fp32 first moment
    v: Dict[str, torch.Tensor]         # fp32 second moment


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # names (substrings) excluded from weight decay
    no_decay_substrings: Tuple[str, ...] = ("norm", "bias", "scale", "dt_bias", "a_log", "d_skip")


def init_adamw(params: Params) -> AdamWState:
    """Master copies and zero moments, on the parameters' devices."""
    master = {k: p.detach().float().clone() for k, p in params.items()}
    dev = next(iter(master.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev), master=master,
        m={k: torch.zeros_like(x) for k, x in master.items()},
        v={k: torch.zeros_like(x) for k, x in master.items()})


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tree.values()))


def adamw_update(
    cfg: AdamWConfig,
    grads: Params,
    state: AdamWState,
    lr_scale: Union[torch.Tensor, float] = 1.0,
) -> Tuple[Dict[str, torch.Tensor], AdamWState]:
    """One AdamW step.  Returns (new fp32 master, new state); the inputs are
    not modified."""
    step = state.step + 1
    gnorm = global_norm(grads)
    c = gnorm.new_tensor
    clip = torch.clamp(c(cfg.grad_clip) / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    stepf = step.float()
    b1c = 1.0 - c(cfg.b1) ** stepf
    b2c = 1.0 - c(cfg.b2) ** stepf
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=gnorm.device)
    eps, wd = c(cfg.eps), cfg.weight_decay
    master_new, m_new, v_new = {}, {}, {}
    for name, g in grads.items():
        master, m, v = state.master[name], state.m[name], state.v[name]
        g = g.float() * clip
        m1 = cfg.b1 * m + (1.0 - cfg.b1) * g
        v1 = cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g)
        update = (m1 / b1c) / (torch.sqrt(v1 / b2c) + eps)
        if wd > 0 and not any(s in name for s in cfg.no_decay_substrings):
            update = update + wd * master
        master_new[name] = master - lr * update
        m_new[name], v_new[name] = m1, v1
    return master_new, AdamWState(step=step, master=master_new, m=m_new,
                                  v=v_new)


@torch.no_grad()
def params_from_master(master: Params, like: Params) -> None:
    """Copy the fp32 master into the working parameters, in place (cast to
    each parameter's dtype, round to nearest even as ``astype`` does)."""
    for k, p in like.items():
        p.copy_(master[k])
