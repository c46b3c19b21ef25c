"""Counts of a dense decoder (``family: dense``): each layer attention
(q, k, v and out projections, the scores and the weighted sum over the
causal pairs) and an MLP, then a final norm and the head."""
from harness.counts import flash_call


def forward_flops(m, batch, seq, logits_rows):
    d, v, L = m["d_model"], m["vocab"], m["n_layers"]
    a = m["attention"]
    H, G, hd, f = a["n_heads"], a["n_kv_heads"], a["head_dim"], m["d_ff"]
    tok = batch * seq
    gated = 3 if m["act"].endswith("gated") else 2
    proj = 2.0 * tok * d * hd * (H + 2 * G) + 2.0 * tok * H * hd * d
    mlp = gated * 2.0 * tok * d * f
    attn = flash_call(batch * G, H // G, seq, hd)["flops"]
    return L * (proj + mlp + attn) + 2.0 * logits_rows * d * v


def n_params(m):
    d, v, L = m["d_model"], m["vocab"], m["n_layers"]
    a = m["attention"]
    H, G, hd, f = a["n_heads"], a["n_kv_heads"], a["head_dim"], m["d_ff"]
    gated = 3 if m["act"].endswith("gated") else 2
    norm = {"nonparametric": 0, "layernorm": 2}.get(m["norm"], 1) * d
    block = d * hd * (H + 2 * G) + H * hd * d + gated * d * f + 2 * norm
    return L * block + v * d * (1 if m["tie_embeddings"] else 2) + norm


def layers(m):
    return {"attention": m["n_layers"]}
