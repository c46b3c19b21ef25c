"""Mixture-of-Experts layer of the port: ``repro/models/moe.py`` (GShard-
style token-choice top-k routing with per-group capacity).

Tokens are processed in groups of ``group = min(group_size, B·S)``; each
expert accepts at most ``C = max(ceil(group · top_k · capacity_factor /
n_experts), top_k)`` claims a group, with priority by (k slot, then
sequence order); the claims past capacity drop and a token whose claims
all drop rides the residual.  Routing runs in float32: softmax of
``x @ router``, top-k sorted descending, the gates renormalized.  The aux
loss is the Switch loss ``E · Σ(me · ce) · aux_loss_weight``.  Shared
experts (deepseek) are applied to every token and added.

The reference builds a (G, S, K, E, C) one-hot for the dispatch and the
combine (16·512·8·64·80 float32, ~1.7 GB a layer at olmoe's prefill of
8 × 1024).  The port dispatches by index: each kept (token, k) claim has
its own slot of an (E, G·C, D) buffer (empty slots zero, as in the
reference), filled from an expanded (N, K, D) view of the tokens; the
expert products are ``torch.bmm`` over the stacked (E, d, f) weights;
each claim's output is gathered back and the K outputs are summed with
their gates by a batched product, float32 accumulation and one rounding
to the compute dtype, as the reference's combine einsum rounds.  The
forward and the backward are deterministic on the card: the dispatch
writes unique slots (the dropped claims all go to one discarded row), so
its backward is a gather and the sum over a token's K claims a dense
reduction; the combine's gather reads each kept slot once (a dropped
claim reads slot 0 at weight 0), so its backward adds to a slot one
gradient and, at slot 0, zeros.  Nowhere do two values meet in an atomic
add.

The reference's router-noise path is dead (its model never passes a
key), so :func:`apply_moe` takes no key.  :func:`route` is the routing
alone (:func:`assign` its gates and capacity for given choices); the
model calls it through this module, so a caller can read the routes
(``expert_ids`` and the within-capacity mask) of every layer.

On a shard of a split model (``distributed/tensor_parallel.py``) the
experts lie on the model axis: ``p`` holds the shard's ``E/m`` stacked
experts, from ``expert_offset`` on, and the router whole.  Every shard
routes the same replicated tokens with the same router, so every shard
computes the same routes; each dispatches only the claims on its own
experts (the tokens are replicated, so no all-to-all), runs its experts
and combines their outputs: a partial sum that the caller all-reduces.
The shared experts split as the MLP does (:func:`apply_shared`).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import div
from repro_torch.distributed.sharding import logically_sharded as shard
from repro_torch.models.layers import (Params, _dtype, activate,
                                       truncated_normal_init)


def init_moe(gen: Optional[torch.Generator],
             cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The router (d, E), float32 whatever ``param_dtype``; the stacked
    experts ``w_up``/``w_gate`` (E, d, f) and ``w_down`` (E, f, d); the
    shared experts (deepseek) ``shared_up``/``shared_gate`` (d, sf) and
    ``shared_down`` (sf, d) of width ``sf = (shared_dff or expert_dff) ·
    n_shared``.  Scales 1/sqrt(fan-in), drawn in that order."""
    m = cfg.moe
    dt = _dtype(cfg.param_dtype)
    d, f, E = cfg.d_model, m.expert_dff, m.n_experts
    gated = cfg.act.endswith("gated")
    p = {"router": truncated_normal_init(gen, (d, E), 1.0 / math.sqrt(d),
                                         torch.float32),
         "w_up": truncated_normal_init(gen, (E, d, f), 1.0 / math.sqrt(d),
                                       dt),
         "w_down": truncated_normal_init(gen, (E, f, d), 1.0 / math.sqrt(f),
                                         dt)}
    if gated:
        p["w_gate"] = truncated_normal_init(gen, (E, d, f),
                                            1.0 / math.sqrt(d), dt)
    if m.n_shared > 0:
        sf = (m.shared_dff or m.expert_dff) * m.n_shared
        p["shared_up"] = truncated_normal_init(gen, (d, sf),
                                               1.0 / math.sqrt(d), dt)
        p["shared_down"] = truncated_normal_init(gen, (sf, d),
                                                 1.0 / math.sqrt(sf), dt)
        if gated:
            p["shared_gate"] = truncated_normal_init(gen, (d, sf),
                                                     1.0 / math.sqrt(d), dt)
    return p


def moe_param_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """Logical axes of :func:`init_moe`'s leaves."""
    specs = {
        "router": ("embed", None),
        "w_up": ("experts", "embed", None),
        "w_down": ("experts", None, "embed"),
    }
    if cfg.act.endswith("gated"):
        specs["w_gate"] = ("experts", "embed", None)
    if cfg.moe.n_shared > 0:
        specs["shared_up"] = ("embed", "mlp")
        specs["shared_down"] = ("mlp", "embed")
        if cfg.act.endswith("gated"):
            specs["shared_gate"] = ("embed", "mlp")
    return specs


def _capacity(cfg: ModelConfig, group: int) -> int:
    m = cfg.moe
    c = int(math.ceil(group * m.top_k * m.capacity_factor / m.n_experts))
    return max(c, m.top_k)


def _groups(cfg: ModelConfig, n_tok: int) -> Tuple[int, int, int]:
    """(G, group, C) for ``n_tok`` tokens."""
    group = min(cfg.moe.group_size, n_tok)
    if n_tok % group:
        raise ValueError(f"tokens {n_tok} not divisible by group {group}")
    return n_tok // group, group, _capacity(cfg, group)


class Routing(NamedTuple):
    """One layer's routing of (G, group) tokens: ``probs`` (G, group, E)
    float32; ``gates`` (G, group, K) float32, renormalized; ``expert_ids``
    (G, group, K) int64, by descending probability; ``pos`` (G, group, K):
    the claims of the same expert before this one in the (k, s) order;
    ``kept`` (G, group, K) bool: ``pos < C``."""
    probs: torch.Tensor
    gates: torch.Tensor
    expert_ids: torch.Tensor
    pos: torch.Tensor
    kept: torch.Tensor


def route(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig,
          C: int) -> Routing:
    """Top-k routing with capacity ``C`` of tokens ``xt`` (G, group, D)."""
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    _, expert_ids = torch.topk(probs, cfg.moe.top_k, dim=-1)  # descending
    return assign(probs, expert_ids, C)


def assign(probs: torch.Tensor, expert_ids: torch.Tensor,
           C: int) -> Routing:
    """The routing of the claims ``expert_ids`` (G, group, K): their gates
    (the probabilities renormalized by ``max(sum, 1e-9)``) and their
    places under capacity ``C``, by (k slot, then sequence order)."""
    G, group, E = probs.shape
    K = expert_ids.shape[-1]
    gates = probs.gather(-1, expert_ids)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    # position of each claim among its expert's claims, in (k, s) order:
    # a running count along the claims, expert by expert (the scan runs
    # along the contiguous axis)
    claims = expert_ids.transpose(1, 2).reshape(G, 1, K * group)
    mine = claims == torch.arange(E, device=claims.device)[None, :, None]
    upto = mine.to(torch.int32).cumsum(-1, dtype=torch.int32)   # (G, E, ·)
    before = upto.gather(1, claims)[:, 0] - 1
    pos = before.reshape(G, K, group).transpose(1, 2)
    return Routing(probs, gates, expert_ids, pos, pos < C)


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              expert_offset: Optional[int] = None, with_shared: bool = True
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The MoE block on (B, S, D).  Returns (out in ``x``'s dtype, aux):
    aux holds ``moe_aux_loss`` and ``moe_dropped_frac`` (float32 scalars).

    ``expert_offset``: ``p`` holds the experts ``[offset, offset + E_local)``
    of a shard, and ``out`` is their part of the routed output.
    ``with_shared=False`` leaves the shared experts out of ``out``
    (:func:`apply_shared` computes them)."""
    m = cfg.moe
    B, S, D = x.shape
    cdt = _dtype(cfg.compute_dtype)
    E, K = m.n_experts, m.top_k
    El = p["w_up"].shape[0]          # the experts held here
    off = 0 if expert_offset is None else int(expert_offset)
    G, group, C = _groups(cfg, B * S)
    N = B * S
    xc = x.to(cdt)
    r = route(p["router"], xc.reshape(G, group, D), cfg, C)

    # the Switch load-balancing loss and the dropped share
    me = r.probs.mean(dim=(0, 1))
    # claims an expert (a dense count: bincount would wait on the card)
    counts = (r.expert_ids.reshape(-1, 1)
              == torch.arange(E, device=x.device)).sum(0)
    ce = div(counts.float(), G * group * K)
    aux_loss = E * torch.sum(me * ce) * m.aux_loss_weight
    # (a 0-dim float32 over the float64 constant: float64, rounded back)
    dropped = 1.0 - div(r.kept.sum().float(), G * group * K).float()

    # dispatch: each kept claim on an expert held here into its own slot
    # (e, g, c) of the (E_local, G·C, D) buffer; the dropped ones (and, on
    # a shard, the other shards' claims) into a trash row, never read
    g_idx = torch.arange(G, device=x.device)[:, None, None]
    local = r.expert_ids - off
    mine = r.kept & (local >= 0) & (local < El)
    slot = ((local * G + g_idx) * C + r.pos).reshape(N * K)
    kept = mine.reshape(N * K)
    claims = xc.reshape(N, 1, D).expand(N, K, D).reshape(N * K, D)
    buf = claims.new_zeros(El * G * C + 1, D).index_copy(
        0, torch.where(kept, slot, El * G * C), claims)
    exp_in = shard(buf[:-1].view(El, G * C, D), ("experts", None, "embed"))

    def expert(name):
        return torch.bmm(exp_in, p[name].to(cdt))

    h = shard(activate(cfg, expert("w_up"),
                       expert("w_gate") if cfg.act.endswith("gated")
                       else None), ("experts", None, None))
    exp_out = torch.bmm(h, p["w_down"].to(cdt)).reshape(El * G * C, D)

    # combine: each claim's output times its gate (rounded to the compute
    # dtype, as the reference's combine tensor is), summed over K with
    # float32 accumulation and one rounding (a batched product, as the
    # reference's combine einsum); a dropped claim (and another shard's)
    # reads slot 0 at weight 0
    y = exp_out.index_select(0, torch.where(kept, slot, 0)).view(N, K, D)
    w = torch.where(mine, r.gates, 0.0).to(cdt).reshape(N, 1, K)
    out = torch.bmm(w, y).reshape(N, D)

    if m.n_shared > 0 and with_shared:
        out = out + apply_shared(p, xc, cfg).reshape(N, D)
    aux = {"moe_aux_loss": aux_loss, "moe_dropped_frac": dropped}
    return shard(out.reshape(B, S, D), ("batch", "seq", "embed")
                 ).to(x.dtype), aux


def apply_shared(p: Params, x: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    """The shared experts (deepseek) on (B, S, D), in the compute dtype
    (on a shard: its columns of up/gate and rows of down, a partial
    sum)."""
    cdt = _dtype(cfg.compute_dtype)
    xs = x.to(cdt)
    up = shard(xs @ p["shared_up"].to(cdt), ("batch", "seq", "mlp"))
    sh = activate(cfg, up, xs @ p["shared_gate"].to(cdt)
                  if cfg.act.endswith("gated") else None)
    return sh @ p["shared_down"].to(cdt)
