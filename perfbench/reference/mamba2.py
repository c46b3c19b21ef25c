"""Plain Mamba2 language model (Dao & Gu 2024, arXiv:2405.21060; the
``mamba_ssm`` ``MixerModel`` with ``Mamba2`` mixers) in float32.

    x = embed[tokens] * embedding_multiplier
    per layer:  h = rmsnorm(x) * scale
                z, xBC, dt = h @ in_proj          (xBC = [x, B, C])
                xBC = silu(causal depthwise conv(xBC) + conv_b)
                dt = softplus(dt + dt_bias),  A = -exp(a_log)
                y = SSD(x, dt, A, B, C) + d_skip * x
                y = rmsnorm(y * silu(z)) * norm_scale        (one group)
                x = x + y @ out_proj
    logits = (rmsnorm(x) * final scale) @ embed^T      (tied head)

The SSD runs chunk by chunk at the configuration's chunk length, in its
exact dual form: within a chunk the masked decay matrix, between chunks
the carried state.  The prefill returns each layer's final state and the
conv carry (the last W-1 inputs of the conv), as a serving cache holds
them.  The embedding multiplier is the configuration file's (departing
from ``mamba_ssm``, which has none: the program scales tied rmsnorm
embeddings by sqrt(d_model)).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

from .precision import Products

_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dims(m: Mapping[str, Any]):
    s = m["ssm"]
    di = s["expand"] * m["d_model"]
    h = di // s["head_dim"]
    return di, h, s["head_dim"], s["d_state"], s["conv_width"], s["chunk"]


def leaves(m: Mapping[str, Any]) -> List[Tuple[str, Tuple[int, ...],
                                               torch.dtype]]:
    """(name, shape, dtype) of every weight, by the serving layout's
    names: the benchmark makes these and hands the same to both sides."""
    d, V = m["d_model"], m["vocab"]
    di, h, p, n, w, _ = dims(m)
    pd = _DT[m["param_dtype"]]
    f32 = torch.float32
    out = [("embed.tok", (V, d), pd)]
    for i in range(m["n_layers"]):
        b = f"blocks.{i}"
        out += [(f"{b}.norm.scale", (d,), pd),
                (f"{b}.mixer.in_proj", (d, 2 * di + 2 * n + h), pd),
                (f"{b}.mixer.conv_w", (w, di + 2 * n), pd),
                (f"{b}.mixer.conv_b", (di + 2 * n,), pd),
                (f"{b}.mixer.a_log", (h,), f32),
                (f"{b}.mixer.dt_bias", (h,), f32),
                (f"{b}.mixer.d_skip", (h,), f32),
                (f"{b}.mixer.norm_scale", (di,), pd),
                (f"{b}.mixer.out_proj", (di, d), pd)]
    out.append(("final_norm.scale", (d,), pd))
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def ssd(x, dt, A, B, C, chunk: int):
    """x (b, s, h, p), dt (b, s, h), A (h,), B and C (b, s, n), all
    float32, s a multiple of ``chunk``.  Returns y (b, s, h, p) and the
    final state (b, h, p, n)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    state = x.new_zeros(b, h, p, n)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    ys = []
    for c0 in range(0, s, chunk):
        xc, dtc = x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        Bc, Cc = B[:, c0:c0 + chunk], C[:, c0:c0 + chunk]
        cum = torch.cumsum(dtc * A, dim=1)                   # (b, q, h)
        ch = cum.transpose(1, 2)                             # (b, h, q)
        diff = ch[..., :, None] - ch[..., None, :]           # (b, h, i, j)
        decay = torch.exp(torch.where(tri, diff, float("-inf")))
        w = (Cc @ Bc.transpose(1, 2))[:, None] * decay \
            * dtc.transpose(1, 2)[:, :, None, :]             # (b, h, i, j)
        y = torch.einsum("bhij,bjhp->bihp", w, xc)
        y = y + torch.einsum("bin,bhpn->bihp", Cc, state) \
            * torch.exp(cum)[..., None]
        ys.append(y)
        to_end = torch.exp(cum[:, -1:] - cum) * dtc          # (b, q, h)
        state = state * torch.exp(cum[:, -1])[..., None, None] \
            + torch.einsum("bjhp,bjn->bhpn", xc * to_end[..., None], Bc)
    return torch.cat(ys, dim=1), state


def mixer(P: Mapping[str, torch.Tensor], b: str, h_in: torch.Tensor,
          m: Mapping[str, Any], prod: Products):
    """One Mamba2 mixer over (B, S, d) float32 ``h_in``.  Returns (out,
    final state, conv carry)."""
    di, nh, hp, n, W, chunk = dims(m)
    eps = m["norm_eps"]
    Bsz, S, _ = h_in.shape
    proj = prod.mm(h_in, P[f"{b}.mixer.in_proj"])
    z, xbc, dt = proj.split([di, di + 2 * n, nh], dim=-1)
    carry = xbc[:, S - (W - 1):].clone()    # not a view of all of proj
    padded = F.pad(xbc, (0, 0, W - 1, 0))
    cw = P[f"{b}.mixer.conv_w"]
    conv = sum(padded[:, i:i + S] * cw[i] for i in range(W))
    xbc = F.silu(conv + P[f"{b}.mixer.conv_b"])
    xs, Bm, Cm = xbc.split([di, n, n], dim=-1)
    dt = F.softplus(dt + P[f"{b}.mixer.dt_bias"])
    A = -torch.exp(P[f"{b}.mixer.a_log"])
    xh = xs.reshape(Bsz, S, nh, hp)
    y, state = ssd(xh, dt, A, Bm, Cm, chunk)
    y = y + P[f"{b}.mixer.d_skip"][:, None] * xh
    y = y.reshape(Bsz, S, di) * F.silu(z)
    y = rmsnorm(y, P[f"{b}.mixer.norm_scale"], eps)
    return prod.mm(y, P[f"{b}.mixer.out_proj"]), state, carry


@torch.no_grad()
def prefill(weights: Mapping[str, torch.Tensor], config: Mapping[str, Any],
            tokens: torch.Tensor, prod: Products
            ) -> Dict[str, Any]:
    """The last position's logits (B, V), and each layer's final SSM
    state (B, h, p, n) and conv carry (B, W-1, conv_dim), float32."""
    m = config["model"]
    P = {k: v.float() for k, v in weights.items()}
    eps = m["norm_eps"]
    x = P["embed.tok"][tokens] * float(config.get("embedding_multiplier",
                                                  1.0))
    states, convs = [], []
    for i in range(m["n_layers"]):
        b = f"blocks.{i}"
        out, st, cv = mixer(P, b, rmsnorm(x, P[f"{b}.norm.scale"], eps), m,
                            prod)
        x = x + out
        states.append(st)
        convs.append(cv)
    h = rmsnorm(x[:, -1], P["final_norm.scale"], eps)
    logits = prod.mm(h, P["embed.tok"].t())
    return {"logits": logits, "state": states, "conv": convs}
