"""Counts of an attention-free Mamba2 stack (``family: ssm``): each layer
a norm and a Mamba2 mixer (in projection to z, x, B, C and dt, the
depthwise conv over x, B and C, the SSD, the gated norm, the out
projection), then a final norm and the head."""
from harness.counts import ssd_call, ssm_dims


def forward_flops(m, batch, seq, logits_rows):
    d, v, L = m["d_model"], m["vocab"], m["n_layers"]
    di, h, p, n, w, q = ssm_dims(m)
    tok = batch * seq
    proj = 2.0 * tok * d * (2 * di + 2 * n + h) + 2.0 * tok * di * d
    conv = 2.0 * tok * w * (di + 2 * n)
    ssd = ssd_call(batch, seq, h, p, n, min(q, seq))["flops"]
    return L * (proj + conv + ssd) + 2.0 * logits_rows * d * v


def n_params(m):
    d, v, L = m["d_model"], m["vocab"], m["n_layers"]
    di, h, p, n, w, q = ssm_dims(m)
    conv_dim = di + 2 * n
    norm = {"nonparametric": 0, "layernorm": 2}.get(m["norm"], 1) * d
    mixer = (d * (2 * di + 2 * n + h) + w * conv_dim + conv_dim + 3 * h
             + di + di * d)
    return L * (mixer + norm) + v * d * (1 if m["tie_embeddings"] else 2) \
        + norm


def layers(m):
    return {"ssm": m["n_layers"]}
