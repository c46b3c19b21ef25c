"""GOOD: branchless step bodies; branches only on static flags, configs
and tensor metadata."""
from typing import Optional

import torch


class ModelConfig:
    post_block_norm = True


def _masked_steps(s, p, draws, *, macro_threshold: float,
                    obs: Optional[torch.Tensor] = None):
    if s.ema_d.shape[1] != 1:                   # metadata
        raise ValueError("peer axis")
    if obs is not None and obs.shape[0] != draws.shape[0]:
        raise ValueError("obs")                 # keyword flag, metadata
    for i in range(draws.shape[0]):
        live = ~s.finished
        s = torch.where(live, s + draws[i], s)
    return s


def _replica_draw(mu, u2, p, any_het: bool, any_shock: bool):
    A = torch.clamp(1.0 / (1.0 + mu), 1e-12, 1.0)
    if any_het:                                 # bool parameter
        A = torch.where(p > 0, A * 2.0, A)
    pmf = A * u2 if any_shock else A            # bool parameter
    return pmf


def _apply(s, p, pre, macro_threshold: float, any_pm: bool, u3=None):
    elapsed = s.t - pre
    peer_axis = s.ema_d.shape[1]                # metadata does not taint
    if peer_axis == 1:
        d = elapsed[:, None]
    else:
        d = torch.zeros_like(s.ema_d)
    if u3 is None:                              # identity, not value
        u3 = torch.zeros_like(d)
    if len(s.t) > 4 and s.t.dim() == 1 and s.t.numel() > 0:
        d = d + u3
    return d if s.t.is_cuda or s.t.dtype == torch.float64 else d


def _gossip_mix(ema_d, n_round, p):
    P = ema_d.shape[1]
    idx = torch.arange(P, dtype=torch.float64)
    j = torch.clamp_max(idx + n_round, float(P - 1)).to(torch.int64)
    return torch.gather(ema_d, 1, j[None, :].expand_as(ema_d))


def _apply_dense_block(bp, x, cfg: ModelConfig, *, cache=None):
    h = bp.norm(x)
    if cfg.post_block_norm:                     # config type
        h = bp.post_norm(h)
    if cache is not None:
        h = h + cache
    if isinstance(x, tuple):
        x = x[0]
    return x + h


def _mamba_layer(params, i: int, x, *, remat: str = "none"):
    bp = params.blocks[i]
    if remat != "none":                         # keyword flag
        return bp(x)
    return bp(x)


def compute_grads(params, batch, cfg: "ModelConfig", n: Optional[int] = None):
    if n is not None and n > 1:                 # Optional[int] parameter
        batch = batch[:n]
    return params(batch)
