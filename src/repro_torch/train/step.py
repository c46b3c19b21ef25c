"""train_step factory: microbatched gradient accumulation + AdamW (the port
of ``repro/train/step.py``).

The returned step has the signature ``(TrainState, batch) -> (TrainState,
metrics)``.  It runs eagerly: the forward and backward of
:func:`repro_torch.models.model.loss_fn` per microbatch, float32
accumulation of the gradients, then :func:`adamw_update`.  The working
parameters (an ``nn.Module``, ``requires_grad``) and the optimizer state
are updated in place and returned; a caller that needs the old state keeps
a :meth:`TrainState.clone`.

Every family trains: ssm, dense, moe, hybrid and encdec.  Neither
hand-written kernel of their serving paths has a backward, in the JAX
package or here: training runs the SSD through ``ssd_chunked`` and
attention through ``_attention_core`` (encdec: its cross-attention
through the plain form) under autograd, as the JAX package trains them,
so a config with ``use_flash_kernel=True`` is refused.  An encdec batch
carries 'frames' (B, enc_seq, d_model) beside the tokens and labels; the
microbatch split slices every entry along the batch, frames too.  A moe step
averages the blocks' ``moe_aux_loss`` and ``moe_dropped_frac`` over the
microbatches with the loss.  ``grad_constraint`` and
``zero1_grads_in_scan`` (the ZeRO-1 sharding of the gradients) wait for
ROADMAP Queue 1 item 6 and raise.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, Mapping, NamedTuple, Optional,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.train.optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_update,
    global_norm,
    init_adamw,
    params_from_master,
)

_OPT_PARTS = ("master", "m", "v")


class TrainState(NamedTuple):
    params: M.LM         # param_dtype (bf16) working copy, requires grad
    opt: AdamWState      # fp32 master + moments

    def tree(self) -> Dict[str, torch.Tensor]:
        """The state as one flat mapping (the checkpoint layout):
        ``params/<name>``, ``opt/step``, ``opt/{master,m,v}/<name>``."""
        out = {f"params/{k}": p for k, p in self.params.named_parameters()}
        out["opt/step"] = self.opt.step
        for part in _OPT_PARTS:
            out.update({f"opt/{part}/{k}": t
                        for k, t in getattr(self.opt, part).items()})
        return out

    @torch.no_grad()
    def load_tree(self, tree: Mapping[str, torch.Tensor]) -> "TrainState":
        """Copy a :meth:`tree` mapping into this state in place."""
        for k, t in self.tree().items():
            t.copy_(tree[k])
        return self

    def clone(self) -> "TrainState":
        """A copy that shares no storage with this state."""
        cfg = self.params.cfg
        params = M.model_class(cfg)(cfg)            # on the meta device
        params.load_state_dict({k: p.detach().clone() for k, p
                                in self.params.named_parameters()},
                               strict=True, assign=True)
        params.requires_grad_(True)
        parts = {p: {k: t.clone() for k, t in getattr(self.opt, p).items()}
                 for p in _OPT_PARTS}
        return TrainState(params, AdamWState(step=self.opt.step.clone(),
                                             **parts))


def require_trainable_family(cfg: ModelConfig) -> None:
    """Training is ported for every family; an unknown one raises."""
    M._require_ported(cfg)


def serving_kernel(cfg: ModelConfig) -> Tuple[str, str]:
    """Why training turns ``use_flash_kernel`` off for ``cfg``'s family --
    the clause naming the hand-written kernels the knob turns on, which
    have no backward -- and the plain paths training runs in their place."""
    if cfg.family in M.ATTENTION_FAMILIES:
        return ("the flash-attention kernel has no backward",
                "_attention_core")
    if cfg.family == "encdec":
        return ("the flash-attention kernel has no backward",
                "_attention_core and the plain cross-attention")
    if cfg.family == "hybrid":
        return ("the SSD kernel and the flash-attention kernel have no "
                "backward", "ssd_chunked and _attention_core")
    return "the SSD kernel has no backward", "ssd_chunked"


def require_trainable(cfg: ModelConfig) -> None:
    """Refuse a config that training cannot run faithfully."""
    require_trainable_family(cfg)
    if cfg.use_flash_kernel:
        why, plain = serving_kernel(cfg)
        raise ValueError(
            f"training needs use_flash_kernel=False: {why} (in the JAX "
            f"package or in the port), so training runs {plain}; pass "
            f"dataclasses.replace(cfg, use_flash_kernel=False)")


def _named(params: M.LM) -> Dict[str, torch.Tensor]:
    return dict(params.named_parameters())


def init_train_state(seed: Union[int, torch.Generator], cfg: ModelConfig,
                     device=None) -> TrainState:
    """The port's init (:func:`repro_torch.models.init_params`: a seed
    draws on the CPU, a ``torch.Generator`` on its own device) with
    trainable parameters, and a fresh AdamW state."""
    require_trainable_family(cfg)
    params = M.init_params(seed, cfg, device=device).requires_grad_(True)
    return TrainState(params=params, opt=init_adamw(_named(params)))


def from_reference(state_np: Any, cfg: ModelConfig, device=None) -> TrainState:
    """The port's state holding a JAX ``TrainState`` given as numpy arrays
    (``params`` the ``init_params`` pytree; ``opt`` an ``AdamWState`` with
    ``step`` and the ``master``/``m``/``v`` pytrees), the layer-stacked
    leaves split per layer through ``models.model.reference_state``'s
    naming."""
    require_trainable_family(cfg)
    params_np, opt = state_np[0], state_np[1]
    params = M.from_reference(params_np, cfg, device).requires_grad_(True)
    dev = next(params.parameters()).device
    parts = {}
    for part in _OPT_PARTS:
        flat = M.reference_state(getattr(opt, part), cfg)
        parts[part] = {k: torch.from_numpy(np.array(a, dtype=np.float32))
                       .to(dev) for k, a in flat.items()}
    step = torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                        device=dev)
    return TrainState(params, AdamWState(step=step, **parts))


def _zero_metrics(cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    """The metrics a microbatched step averages: the loss and the
    cross-entropy, and for the moe family the aux loss and the dropped
    share."""
    names = ("loss", "ce")
    if cfg.family == "moe":
        names += ("moe_aux_loss", "moe_dropped_frac")
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in names}


def _to_device(batch: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """The batch as tensors on ``device``: the integer entries (tokens,
    labels, positions) as int64, the encdec 'frames' in their own floating
    dtype."""
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else M._tensor(np.asarray(v))
        out[k] = t.to(device=device, dtype=t.dtype if t.is_floating_point()
                      else torch.long)
    return out


def compute_grads(params: M.LM, batch: Mapping[str, torch.Tensor],
                  cfg: ModelConfig
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Gradients of :func:`loss_fn` by name (in the parameters' dtypes) and
    its metrics; leaves no ``.grad`` on the parameters."""
    params.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss, metrics = M.loss_fn(params, batch, cfg)
        loss.backward()
    grads = {k: p.grad for k, p in params.named_parameters()}
    params.zero_grad(set_to_none=True)
    return grads, {k: v.detach() for k, v in metrics.items()}


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    schedule: Callable[[torch.Tensor], torch.Tensor],
    *,
    n_microbatches: int = 1,
    grad_constraint: Optional[Callable] = None,
    zero1_grads_in_scan: bool = False,
) -> Callable[[TrainState, Mapping[str, Any]],
              Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the train step.  ``batch``: ``{'tokens', 'labels'}`` (B, S)
    integer arrays or tensors (encdec: and 'frames' (B, enc_seq,
    d_model)), moved to the parameters' device."""
    require_trainable(cfg)
    if grad_constraint is not None or zero1_grads_in_scan:
        raise NotImplementedError(
            "grad_constraint / zero1_grads_in_scan (ZeRO-1 sharding of the "
            "gradients) are not ported yet (ROADMAP Queue 1 item 6)")

    def train_step(state: TrainState, batch: Mapping[str, Any]):
        dev = state.opt.step.device
        batch = _to_device(batch, dev)
        if n_microbatches > 1:
            b = batch["tokens"].shape[0]
            if b % n_microbatches:
                raise ValueError(f"batch {b} % n_microbatches "
                                 f"{n_microbatches} != 0")
            mb = b // n_microbatches
            g_sum = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for k, p in state.params.named_parameters()}
            m_sum = _zero_metrics(cfg, dev)
            for i in range(n_microbatches):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                grads, metrics = compute_grads(state.params, micro, cfg)
                for k, g in grads.items():
                    g_sum[k] += g.float()
                m_sum = {k: m_sum[k] + metrics[k] for k in m_sum}
            n = torch.tensor(float(n_microbatches), device=dev)
            grads = {k: g / n for k, g in g_sum.items()}
            metrics = {k: v / n for k, v in m_sum.items()}
        else:
            grads, metrics = compute_grads(state.params, batch, cfg)

        lr_scale = schedule(state.opt.step)
        master, new_opt = adamw_update(opt_cfg, grads, state.opt, lr_scale)
        params_from_master(master, _named(state.params))
        metrics = dict(metrics)
        metrics["grad_norm"] = global_norm(grads)
        metrics["lr_scale"] = torch.as_tensor(lr_scale, dtype=torch.float32)
        metrics["step"] = new_opt.step.float()
        return TrainState(params=state.params, opt=new_opt), metrics

    return train_step
