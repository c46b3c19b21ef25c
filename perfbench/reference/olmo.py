"""Plain OLMo language model (Groeneveld et al. 2024, arXiv:2402.00838) in
float32: pre-norm blocks with non-parametric LayerNorm, multi-head
attention with rotary embeddings, a SwiGLU MLP, a tied head, no biases.

    x = embed[tokens]
    per layer:  h = layernorm(x)                  (no scale, no bias)
                q, k, v = h @ wq, h @ wk, h @ wv  (rotary on q and k)
                x = x + softmax(q k^T / sqrt(hd), causal) v @ wo
                h = layernorm(x)
                x = x + (silu(h @ w_gate) * (h @ w_up)) @ w_down
    logits = layernorm(x) @ embed^T

One departure from OLMo's code: the rotary embedding rotates interleaved
channel pairs (0, 1), (2, 3), ... where OLMo rotates the two halves of a
head.  The two are the same map under a fixed permutation of each head's
q and k channels, which random weights do not see; the benchmark's
weights are laid out for the pairs.

``train_steps`` runs AdamW steps (decoupled weight decay, the global norm
clipped, the configuration's hyper-parameters) over the same batches the
program gets, one sequence at a time so that float32 fits beside nothing
else, its gradients summed in float32.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .precision import Products

_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaves(m: Mapping[str, Any]) -> List[Tuple[str, Tuple[int, ...],
                                               torch.dtype]]:
    d, V, f = m["d_model"], m["vocab"], m["d_ff"]
    a = m["attention"]
    H, G, hd = a["n_heads"], a["n_kv_heads"], a["head_dim"]
    pd = _DT[m["param_dtype"]]
    out = [("embed.tok", (V, d), pd)]
    for i in range(m["n_layers"]):
        b = f"blocks.{i}"
        out += [(f"{b}.attn.wq", (d, H, hd), pd),
                (f"{b}.attn.wk", (d, G, hd), pd),
                (f"{b}.attn.wv", (d, G, hd), pd),
                (f"{b}.attn.wo", (H, hd, d), pd),
                (f"{b}.mlp.w_up", (d, f), pd),
                (f"{b}.mlp.w_down", (f, d), pd),
                (f"{b}.mlp.w_gate", (d, f), pd)]
    return out


def layernorm(x: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, H, S, hd) rotated at positions 0 ... S-1, interleaved pairs."""
    S, hd = x.shape[2], x.shape[3]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def block(P, i: int, x: torch.Tensor, m, prod: Products):
    """Layer ``i`` over (B, S, d).  Returns (x, k, v) with k (rotated)
    and v of (B, G, S, hd)."""
    a = m["attention"]
    H, G, hd = a["n_heads"], a["n_kv_heads"], a["head_dim"]
    d, eps = m["d_model"], m["norm_eps"]
    B, S, _ = x.shape
    b = f"blocks.{i}"
    h = layernorm(x, eps)

    def heads(w, n):
        return prod.mm(h, P[w].reshape(d, n * hd)).reshape(
            B, S, n, hd).transpose(1, 2)

    theta = a["rope"]["theta"]
    q = rotary(heads(f"{b}.attn.wq", H), theta)
    k = rotary(heads(f"{b}.attn.wk", G), theta)
    v = heads(f"{b}.attn.wv", G)
    rep = H // G
    kr = k.repeat_interleave(rep, dim=1)
    vr = v.repeat_interleave(rep, dim=1)
    s = (q @ kr.transpose(-1, -2)) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    ctx = (probs @ vr).transpose(1, 2).reshape(B, S, H * hd)
    x = x + prod.mm(ctx, P[f"{b}.attn.wo"].reshape(H * hd, d))
    h = layernorm(x, eps)
    up = prod.mm(h, P[f"{b}.mlp.w_up"])
    gate = prod.mm(h, P[f"{b}.mlp.w_gate"])
    x = x + prod.mm(F.silu(gate) * up, P[f"{b}.mlp.w_down"])
    return x, k, v


def forward(P: Mapping[str, torch.Tensor], m: Mapping[str, Any],
            tokens: torch.Tensor, prod: Products, last_only: bool = False,
            collect_kv: bool = False):
    """Logits (B, S or 1, V) and, with ``collect_kv``, each layer's k and
    v (B, G, S, hd)."""
    x = P["embed.tok"][tokens]
    kv = []
    for i in range(m["n_layers"]):
        x, k, v = block(P, i, x, m, prod)
        if collect_kv:
            kv.append((k, v))
    if last_only:
        x = x[:, -1:]
    logits = prod.mm(layernorm(x, m["norm_eps"]), P["embed.tok"].t())
    return logits, kv


@torch.no_grad()
def prefill(weights: Mapping[str, torch.Tensor], config: Mapping[str, Any],
            tokens: torch.Tensor, prod: Products, rows: int = 1
            ) -> Dict[str, Any]:
    """The last position's logits (B, V) and each layer's k and v (B, G,
    S, hd), ``rows`` prompts at a time."""
    m = config["model"]
    P = {k: v.float() for k, v in weights.items()}
    logits, ks, vs = [], [[] for _ in range(m["n_layers"])], \
        [[] for _ in range(m["n_layers"])]
    for r in range(0, tokens.shape[0], rows):
        lg, kv = forward(P, m, tokens[r:r + rows], prod, last_only=True,
                         collect_kv=True)
        logits.append(lg[:, 0])
        for i, (k, v) in enumerate(kv):
            ks[i].append(k)
            vs[i].append(v)
    return {"logits": torch.cat(logits),
            "k": [torch.cat(t) for t in ks], "v": [torch.cat(t) for t in vs]}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[..., None])[..., 0]).mean()


def train_steps(weights: Mapping[str, torch.Tensor], config: Mapping[str, Any],
                batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                opt: Mapping[str, Any], prod: Products
                ) -> Dict[str, Any]:
    """AdamW steps from ``weights`` over ``batches`` of (tokens, labels)
    (B, S).  Returns each step's loss, each leaf's gradient norm at the
    first step (the mean over the batch, before the clip) and each leaf's
    change after the last step."""
    m = config["model"]
    P = {k: v.float().clone().requires_grad_(True)
         for k, v in weights.items()}
    start = {k: v.float() for k, v in weights.items()}
    mom = {k: torch.zeros_like(v) for k, v in P.items()}
    vel = {k: torch.zeros_like(v) for k, v in P.items()}
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    losses: List[float] = []
    grad_norms: Optional[Dict[str, float]] = None
    for step, (tokens, labels) in enumerate(batches, start=1):
        B = tokens.shape[0]
        total = 0.0
        for r in range(B):
            logits, _ = forward(P, m, tokens[r:r + 1], prod)
            loss = cross_entropy(logits, labels[r:r + 1]) / B
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            g = {k: p.grad for k, p in P.items()}
            if grad_norms is None:
                grad_norms = {k: float(torch.linalg.vector_norm(t))
                              for k, t in g.items()}
            gnorm = torch.sqrt(sum(t.square().sum() for t in g.values()))
            clip = torch.clamp(opt["grad_clip"] / gnorm.clamp(min=1e-12),
                               max=1.0)
            for k, p in P.items():
                gk = g[k] * clip
                mom[k].mul_(b1).add_((1 - b1) * gk)
                vel[k].mul_(b2).add_((1 - b2) * gk.square())
                upd = (mom[k] / (1 - b1 ** step)) / (
                    torch.sqrt(vel[k] / (1 - b2 ** step)) + eps)
                if opt["weight_decay"] > 0 and not any(
                        s in k for s in opt["no_decay"]):
                    upd = upd + opt["weight_decay"] * p
                p.sub_(opt["lr"] * upd)
                p.grad = None
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(P[k] - start[k]))
                  for k in P}
    return {"losses": losses, "grad_norms": grad_norms, "change": change}
