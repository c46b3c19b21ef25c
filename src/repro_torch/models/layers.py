"""Layer library of the port: ``repro/models/layers.py`` for every
family -- the norms (rmsnorm, gemma's ``(1 + scale)`` rmsnorm,
LayerNorm with and without bias, the non-parametric LayerNorm), RoPE,
partial RoPE and M-RoPE, GQA attention, causal or unmasked, over a
serving cache (bfloat16 or float32, or int8 codes with float32
per-(token, head) scales), the audio-frames frontend (a stub), the MLPs,
tied or untied embedding and unembedding and the final logit softcap, in
bfloat16, float32 and float16.

Conventions, as in the JAX package: parameters are mappings of name to
tensor (``nn.ParameterDict`` inside the modules), ``init_*`` functions
build them and the ``apply`` logic is plain functions; compute runs in
``cfg.compute_dtype``, norm statistics and the softmax in float32.
Initialisation draws from an explicit ``torch.Generator`` on the
generator's own device: a CPU generator (a seed) gives the same weights
on every device, a CUDA generator draws on the card (the full-width
models, whose draw on the CPU would take minutes).  ``gen=None`` gives
uninitialised tensors on the meta device (shapes and dtypes only).

Activations carry logical sharding names through
:func:`repro_torch.distributed.sharding.logically_sharded` at the
reference's sites: a no-op outside a sharding context, a check of a
shard's local shape inside one.  The functions run on a shard of a split
model (``distributed/tensor_parallel.py``) as they run on the whole one:
attention on a config with the shard's heads, the MLP and the unembedding
on the shard's columns, the embedding on the shard's rows
(:func:`embed_rows` with the shard's ``vocab_offset``).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import div
from repro_torch.distributed.sharding import logically_sharded as shard
from repro_torch.kernels import flash_attention as FA

Params = Mapping[str, torch.Tensor]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
NEG_INF = -1e30
INV_127 = 1.0 / 127.0   # the int8 KV scale's factor (rounded to float32)
NORMS = ("rmsnorm", "rmsnorm_one", "layernorm", "layernorm_nobias",
         "nonparametric")
ACTS = ("silu_gated", "gelu_gated", "gelu")
# 'audio_frames' is a stub, as in the JAX package: the encdec model takes
# the frames pre-embedded, (B, enc_seq, d_model)
FRONTENDS = ("none", "patches", "audio_frames")


def _dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}")
    return _DTYPES[name]


def check_ported(cfg: ModelConfig) -> None:
    """Raise for an unknown dtype, frontend, norm or activation."""
    _dtype(cfg.param_dtype)
    _dtype(cfg.compute_dtype)
    if cfg.frontend not in FRONTENDS:
        raise ValueError(f"unknown frontend {cfg.frontend!r}")
    if cfg.norm not in NORMS:
        raise ValueError(f"unknown norm {cfg.norm!r}")
    if cfg.act not in ACTS:
        raise ValueError(f"unknown act {cfg.act!r}")


def truncated_normal_init(gen: Optional[torch.Generator], shape, scale: float,
                          dtype: torch.dtype) -> torch.Tensor:
    """Normal draws truncated to [-2, 2], times ``scale``, cast to ``dtype``
    (inverse CDF of float32 uniforms from ``gen``, on ``gen``'s device,
    in place: one float32 buffer at a time).  ``gen`` None: an
    uninitialised tensor on the meta device."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    x = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=gen.device)
    x.mul_(1.0 - 2.0 * lo).add_(lo)                       # u
    x.mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return x.mul_(scale).to(dtype)


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #

def init_norm(gen: Optional[torch.Generator], cfg: ModelConfig,
              dim: int) -> Dict[str, torch.Tensor]:
    """The norm's parameters (none are drawn): rmsnorm's scale of ones,
    gemma's ``rmsnorm_one`` scale of zeros (applied as ``1 + scale``),
    LayerNorm's scale of ones and bias of zeros, ``layernorm_nobias``'s
    scale, nothing for the non-parametric norm."""
    check_ported(cfg)
    dt = _dtype(cfg.param_dtype)
    dev = gen.device if gen is not None else None
    if cfg.norm == "nonparametric":
        return {}
    if cfg.norm == "rmsnorm_one":
        return {"scale": torch.zeros(dim, dtype=dt, device=dev)}
    p = {"scale": torch.ones(dim, dtype=dt, device=dev)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(dim, dtype=dt, device=dev)
    return p


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Statistics in float32: rmsnorm over the mean square; the LayerNorms
    over the mean and the population variance."""
    xf = x.float()
    if cfg.norm.startswith("rmsnorm"):
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps)
        scale = p["scale"].float()
        y = y * (1.0 + scale) if cfg.norm == "rmsnorm_one" else y * scale
    else:
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + cfg.norm_eps)
        if cfg.norm == "layernorm":
            y = y * p["scale"].float() + p["bias"].float()
        elif cfg.norm == "layernorm_nobias":
            y = y * p["scale"].float()
        # 'nonparametric' (olmo): no affine parameters at all
    return y.to(x.dtype)


# --------------------------------------------------------------------------- #
# Rotary embeddings (RoPE, partial RoPE, M-RoPE)
# --------------------------------------------------------------------------- #

def _rope_freqs(head_dim_rot: int, theta: float,
                device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim_rot, 2,
                                         dtype=torch.float32, device=device)
                            / head_dim_rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               partial_pct: float = 1.0,
               mrope_sections: Optional[Tuple[int, int, int]] = None,
               channels: Optional[Tuple[int, int]] = None
               ) -> torch.Tensor:
    """Rotate ``x`` (B, H, S, D) by ``positions``: interleaved pairs
    (``x[..., 0::2]``, ``x[..., 1::2]``) as in the JAX package, angles in
    float32.  The first ``d_rot = int(D * partial_pct)`` dims (rounded
    down to an even number) rotate and the rest pass through (stablelm:
    0.25).

    positions: (B or 1, S) for RoPE, (B or 1, 3, S) for M-RoPE
    (qwen2-vl): the d_rot/2 frequency slots split into
    ``mrope_sections`` (t, h, w), each driven by its own position stream;
    for text the three streams are equal and M-RoPE reduces to RoPE.

    ``channels`` (first, whole): ``x`` holds the channels ``first ...
    first + D`` of a head of ``whole`` (a ``head_dim`` shard; ``first``
    even, so that every pair lies inside it): they rotate with the whole
    head's frequency slots and sections, as they would unsplit."""
    B, H, S, D = x.shape
    c0, whole = channels or (0, D)
    d_rot = int(whole * partial_pct)
    d_rot -= d_rot % 2
    hi = min(D, d_rot - c0)          # this x's rotating channels: [0, hi)
    if hi <= 0:
        return x
    if c0 % 2:
        raise ValueError(f"a head_dim shard starts at channel {c0}: the "
                         f"interleaved pairs would straddle it")
    slots = slice(c0 // 2, (c0 + hi) // 2)
    freqs = _rope_freqs(d_rot, theta, x.device)[slots]
    if mrope_sections is None:
        if positions.dim() == 3:
            positions = positions[:, 0]
        angles = positions[:, None, :, None].float() * freqs     # (B,1,S,d/2)
    else:
        if positions.dim() != 3:
            raise ValueError(f"M-RoPE needs (B, 3, S) positions, got "
                             f"{tuple(positions.shape)}")
        if sum(mrope_sections) != d_rot // 2:
            raise ValueError(f"mrope sections {mrope_sections} != "
                             f"{d_rot // 2} freq slots")
        # each frequency slot's stream, made from the sections on the host
        # (the meta device cannot size a repeat_interleave)
        sec_id = torch.tensor([i for i, n in enumerate(mrope_sections)
                               for _ in range(n)], device=x.device)[slots]
        per_slot = positions.float()[:, sec_id, :]           # (B, slots, S)
        angles = per_slot.transpose(1, 2)[:, None] * freqs   # (B,1,S,slots)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0:hi:2].float(), x[..., 1:hi:2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(
        *r1.shape[:3], hi).to(x.dtype)
    return torch.cat([rotated, x[..., hi:]], dim=-1) if hi < D else rotated


# --------------------------------------------------------------------------- #
# Attention (GQA, softcap, sliding window, decode cache)
# --------------------------------------------------------------------------- #

def quantize_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, G, S, hd) -> int8 codes and float32 per-(token, head) scales:
    scale = absmax · float32(1/127) (1 for an all-zero row), codes =
    clip(round half to even (t / scale), -127, 127).

    The JAX package writes ``amax / 127.0``, which XLA compiles (the
    serving steps are jitted) to the product with the float32 reciprocal,
    as the Pallas quantize kernel computes it; the port writes that
    product.  One multiplication by a float32 constant and one true
    division by a tensor round the same on the card and the CPU, so both
    give the same scales and codes for the same input."""
    tf = t.float()
    amax = tf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax * INV_127, 1.0)
    codes = torch.round(tf / scale[..., None]).clamp_(-127, 127)
    return codes.to(torch.int8), scale


def init_attention(gen: Optional[torch.Generator],
                   cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    a = cfg.attention
    dt = _dtype(cfg.param_dtype)
    d = cfg.d_model
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(a.n_heads * a.head_dim)
    return {
        "wq": truncated_normal_init(gen, (d, a.n_heads, a.head_dim), s_in, dt),
        "wk": truncated_normal_init(gen, (d, a.n_kv_heads, a.head_dim), s_in,
                                    dt),
        "wv": truncated_normal_init(gen, (d, a.n_kv_heads, a.head_dim), s_in,
                                    dt),
        "wo": truncated_normal_init(gen, (a.n_heads, a.head_dim, d), s_out,
                                    dt),
    }


def attention_param_specs() -> Dict[str, tuple]:
    """Logical axes of :func:`init_attention`'s leaves (see
    :func:`repro_torch.models.model.param_logical_specs`)."""
    return {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }


def _attn_mask(q_pos: torch.Tensor, kv_len: int, *, causal: bool,
               sliding_window: Optional[int], local_flag: bool,
               kv_valid_len: Optional[int]) -> torch.Tensor:
    """Boolean (q_len, kv_len) mask: True = attend.  ``q_pos`` are absolute
    query positions; ``kv_valid_len`` masks not-yet-written cache slots."""
    q = q_pos[:, None]
    k_pos = torch.arange(kv_len, device=q_pos.device)[None, :]
    mask = (k_pos <= q) if causal else torch.ones(
        q.shape[0], kv_len, dtype=torch.bool, device=q_pos.device)
    if sliding_window is not None and local_flag:
        mask = mask & (k_pos > q - sliding_window)
    if kv_valid_len is not None:
        mask = mask & (k_pos < kv_valid_len)
    return mask


def attention_probs(s: torch.Tensor, q_pos: torch.Tensor, *, scale,
                    softcap, causal, sliding_window, local_flag, kv_valid,
                    cdt) -> torch.Tensor:
    """The float32 scores ``s`` (..., S, Sk) of queries at ``q_pos`` over
    keys 0 ... Sk: scaled, softcapped, masked, soft-maxed in float32 and
    cast to the compute dtype."""
    s = s * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    m = _attn_mask(q_pos, s.shape[-1], causal=causal,
                   sliding_window=sliding_window, local_flag=local_flag,
                   kv_valid_len=kv_valid)
    s = torch.where(m, s, NEG_INF)
    return torch.softmax(s, dim=-1).to(cdt)


def query_chunks(S: int, q_chunk: int):
    """The (start, stop) query chunks of the plain attention: one where
    ``S <= q_chunk`` or ``q_chunk`` does not divide it."""
    if S <= q_chunk or S % q_chunk:
        return [(0, S)]
    return [(c, c + q_chunk) for c in range(0, S, q_chunk)]


def _attention_core(qg, k, v, *, scale, softcap, causal, sliding_window,
                    local_flag, q_offset, kv_valid, q_chunk: int, cdt):
    """Softmax attention, chunked over queries (the JAX package's plain
    path).  qg: (B, G, R, S, hd); k, v: (B, G, Sk, hd).  Scores are
    multiplied in the compute dtype, then scaled and soft-maxed in
    float32; the probabilities are cast back to the compute dtype before
    the product with v."""
    pos = torch.arange(qg.shape[3], device=qg.device) + q_offset
    out = []
    for c0, c1 in query_chunks(qg.shape[3], q_chunk):
        s = torch.einsum("bgrsk,bgtk->bgrst", qg[..., c0:c1, :], k).float()
        probs = attention_probs(
            s, pos[c0:c1], scale=scale, softcap=softcap, causal=causal,
            sliding_window=sliding_window, local_flag=local_flag,
            kv_valid=kv_valid, cdt=cdt)
        out.append(torch.einsum("bgrst,bgtk->bgrsk", probs, v))
    return out[0] if len(out) == 1 else torch.cat(out, dim=3)


def query_scale(cfg: ModelConfig) -> float:
    """The softmax scale: the config's ``query_scale`` or
    ``1/sqrt(head_dim)``."""
    a = cfg.attention
    return a.query_scale if a.query_scale is not None else \
        1.0 / math.sqrt(a.head_dim)


def flash_route(cfg: ModelConfig, *, q_offset: int, seq: int,
                layer_is_local: bool) -> bool:
    """Whether the attention of a call runs through the flash kernel: the
    knob is on, a kernel takes the compute dtype and head_dim
    (``flash_attention.takes``: bfloat16 or float32 at head_dim 16, 32, 64
    or 128, and bfloat16 at a multiple of 16 between 64 and 128), the
    queries start at position 0 (a prefill, or a forward without a cache:
    the keys are the call's own) and no sliding window is narrower than
    the prompt.  Causal or not, the mask is then the kernel's: bottom-right
    causal over the call's own keys, or none (the encoder's
    self-attention and the cross-attention); a context-parallel part of
    the keys passes the kernel its own diagonal offset
    (``models/parallel_attention.py``).  Everything else (float16,
    float32 at head_dim 112, decode, a prefill behind earlier tokens) runs
    :func:`_attention_core`.  A model split over ``head_dim`` never asks:
    each shard holds a partial score, which the kernel cannot take, so
    its attention runs the plain path
    (``parallel_attention.head_dim_core``)."""
    a = cfg.attention
    narrow = (a.sliding_window is not None and layer_is_local
              and a.sliding_window < seq)
    return bool(cfg.use_flash_kernel
                and FA.takes(_dtype(cfg.compute_dtype), a.head_dim)
                and q_offset == 0 and not narrow)


def multi_head_attention(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    layer_is_local: bool = False,
    causal: bool = True,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Optional[int] = None,
    layer_index: Optional[int] = None,
    q_chunk: int = 512,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """GQA attention over (B, S, D) input.

    With ``cache`` (dict with 'k', 'v') this is a serving step: the new K/V
    are written at ``cache_index`` and attention runs over the whole
    (masked) cache.  ``layer_index`` selects the layer slice of a stacked
    (L, B, G, max_seq, hd) cache.  Unlike the JAX package, which returns
    updated copies, the port writes into the given cache tensors in place
    and returns the same dict.  A cache that also holds 'k_scale' and
    'v_scale' is the int8 cache (``kv_cache_quant``): the new K/V go in as
    :func:`quantize_kv` codes and scales, and attention reads them back as
    codes times scales in the compute dtype.

    With ``cfg.use_flash_kernel`` and :func:`flash_route` true, the
    attention runs through ``kernels.ops.flash_attention`` on the prompt's
    own K and V (as read back through the cache's dtype), with this call's
    ``causal``: over them it is the attention ``_attention_core`` computes
    over the whole cache with the slots past the prompt masked.  The
    kernel's causal mask is bottom-right aligned, so it is never given the
    longer cache buffer.
    """
    from repro_torch.kernels import ops

    a = cfg.attention
    B, S, _ = x.shape
    G, hd = a.n_kv_heads, a.head_dim
    rep = a.n_heads // G
    cdt = _dtype(cfg.compute_dtype)
    q, k, v = attention_qkv(p, x, cfg, positions)
    q_offset, kv_valid = 0, None
    k_own, v_own = k, v

    def read_all():   # what _attention_core reads: with a cache, all of it
        return k, v

    if cache is not None:
        idx = int(cache_index or 0)
        names = ("k", "v", "k_scale", "v_scale") if "k_scale" in cache \
            else ("k", "v")
        bufs = [cache[n] if layer_index is None else cache[n][layer_index]
                for n in names]
        for buf in bufs[:2]:
            shard(buf, ("batch", "kv_heads", "kv_seq", "head_dim"))
        if len(bufs) == 4:
            ck, cv, cks, cvs = bufs
            (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
            ck[:, :, idx:idx + S], cks[:, :, idx:idx + S] = kq, ks
            cv[:, :, idx:idx + S], cvs[:, :, idx:idx + S] = vq, vs

            def read(codes, scales):
                return codes.to(cdt) * scales[..., None].to(cdt)

            k_own, v_own = read(kq, ks), read(vq, vs)

            def read_all():
                return read(ck, cks), read(cv, cvs)
        else:
            ck, cv = bufs
            ck[:, :, idx:idx + S] = k.to(ck.dtype)
            cv[:, :, idx:idx + S] = v.to(cv.dtype)
            k_own, v_own = k.to(ck.dtype).to(cdt), v.to(cv.dtype).to(cdt)

            def read_all():
                return ck.to(cdt), cv.to(cdt)
        q_offset, kv_valid = idx, idx + S

    scale = query_scale(cfg)
    if flash_route(cfg, q_offset=q_offset, seq=S,
                   layer_is_local=layer_is_local):
        ctx = ops.flash_attention(
            q.reshape(B * G, rep, S, hd), k_own.reshape(B * G, S, hd),
            v_own.reshape(B * G, S, hd), scale=scale, causal=causal,
            softcap=a.softcap)
    else:
        k_all, v_all = read_all()
        ctx = _attention_core(
            q.reshape(B, G, rep, S, hd), k_all, v_all, scale=scale,
            softcap=a.softcap, causal=causal,
            sliding_window=a.sliding_window, local_flag=layer_is_local,
            q_offset=q_offset, kv_valid=kv_valid, q_chunk=q_chunk, cdt=cdt)
    return attention_out(p, ctx, cfg, B, S, x.dtype), cache


def _projection(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig,
                positions, channels, rope: bool) -> torch.Tensor:
    """(B, S, D) ``x`` through ``w`` (D, n, hd) into (B, n, S, hd) in the
    compute dtype, rotated by ``positions`` where ``rope``."""
    a = cfg.attention
    cdt = _dtype(cfg.compute_dtype)
    B, S, d = x.shape
    n, hd = w.shape[1], w.shape[2]
    out = (x.to(cdt) @ w.to(cdt).reshape(d, n * hd)).reshape(
        B, S, n, hd).transpose(1, 2)
    if rope and a.rope is not None:
        out = apply_rope(out, positions, a.rope.theta, a.rope.partial_pct,
                         a.rope.mrope_sections, channels)
    return out


def attention_q(p: Params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, channels=None) -> torch.Tensor:
    """q (B, H, S, hd) of (B, S, D) ``x``, rotated by ``positions``
    (``channels``: a head_dim shard's, :func:`apply_rope`)."""
    return shard(_projection(x, p["wq"], cfg, positions, channels, True),
                 ("batch", "heads", "q_seq", "head_dim"))


def attention_kv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, channels=None,
                 seq: Optional[str] = "kv_seq"):
    """k, v (B, G, S, hd) of (B, S, D) ``x``, k rotated by
    ``positions``; ``seq`` the logical name of their sequence dimension
    (None for a context-parallel part's keys, which are no even cut of
    the rules' ``kv_seq``)."""
    k = _projection(x, p["wk"], cfg, positions, channels, True)
    v = _projection(x, p["wv"], cfg, positions, channels, False)
    spec = ("batch", "kv_heads", seq, "head_dim")
    return shard(k, spec), shard(v, spec)


def attention_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, channels=None):
    """q (B, H, S, hd) and k, v (B, G, S, hd) of (B, S, D) ``x`` in the
    compute dtype, q and k rotated by ``positions``."""
    return (attention_q(p, x, cfg, positions, channels),
            *attention_kv(p, x, cfg, positions, channels))


def attention_out(p: Params, ctx: torch.Tensor, cfg: ModelConfig, B: int,
                  S: int, dtype: torch.dtype) -> torch.Tensor:
    """The heads' context (any shape holding (B, H, S, hd)) through
    ``wo``, in ``dtype``."""
    a = cfg.attention
    cdt = _dtype(cfg.compute_dtype)
    ctx = shard(ctx.reshape(B, a.n_heads, S, a.head_dim),
                ("batch", "heads", "q_seq", "head_dim"))
    out = torch.einsum("bhsk,hkd->bsd", ctx, p["wo"].to(cdt))
    return shard(out, ("batch", "seq", "embed")).to(dtype)


# --------------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------------- #

def init_mlp(gen: Optional[torch.Generator], cfg: ModelConfig,
             d_ff: Optional[int] = None) -> Dict[str, torch.Tensor]:
    dt = _dtype(cfg.param_dtype)
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    p = {"w_up": truncated_normal_init(gen, (d, f), 1.0 / math.sqrt(d), dt),
         "w_down": truncated_normal_init(gen, (f, d), 1.0 / math.sqrt(f), dt)}
    if cfg.act.endswith("gated"):
        p["w_gate"] = truncated_normal_init(gen, (d, f), 1.0 / math.sqrt(d),
                                            dt)
    return p


def mlp_param_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    specs = {"w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}
    if cfg.act.endswith("gated"):
        specs["w_gate"] = ("embed", "mlp")
    return specs


def activate(cfg: ModelConfig, up: torch.Tensor,
             gate: Optional[torch.Tensor]) -> torch.Tensor:
    """The MLP's hidden activation: ``silu(gate) * up``, ``gelu(gate) *
    up`` or ``gelu(up)``; GELU is the tanh approximation, as
    ``jax.nn.gelu(approximate=True)``."""
    if cfg.act == "silu_gated":
        return F.silu(gate) * up
    if cfg.act == "gelu_gated":
        return F.gelu(gate, approximate="tanh") * up
    if cfg.act == "gelu":
        return F.gelu(up, approximate="tanh")
    raise ValueError(f"unknown act {cfg.act!r}")


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cdt = _dtype(cfg.compute_dtype)
    xc = x.to(cdt)
    gated = cfg.act.endswith("gated")
    up = shard(xc @ p["w_up"].to(cdt), ("batch", "seq", "mlp"))
    h = shard(activate(cfg, up, xc @ p["w_gate"].to(cdt) if gated else None),
              ("batch", "seq", "mlp"))
    return shard(h @ p["w_down"].to(cdt), ("batch", "seq", "embed")
                 ).to(x.dtype)


# --------------------------------------------------------------------------- #
# Embedding / unembedding
# --------------------------------------------------------------------------- #

def init_embedding(gen: Optional[torch.Generator],
                   cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The token embedding (vocab, d_model) and, untied, the unembedding
    (d_model, vocab), drawn in that order."""
    check_ported(cfg)
    dt = _dtype(cfg.param_dtype)
    p = {"tok": truncated_normal_init(gen, (cfg.vocab, cfg.d_model), 0.02,
                                      dt)}
    if not cfg.tie_embeddings:
        p["unembed"] = truncated_normal_init(
            gen, (cfg.d_model, cfg.vocab), 1.0 / math.sqrt(cfg.d_model), dt)
    return p


def embedding_param_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    specs = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        specs["unembed"] = ("embed", "vocab")
    return specs


def embed_rows(p: Params, tokens: torch.Tensor,
               vocab_offset: Optional[int] = None) -> torch.Tensor:
    """The tokens' rows of the table, in its dtype.  ``vocab_offset``
    (vocabulary-parallel): ``p["tok"]`` holds the rows ``[offset, offset +
    rows)`` of the whole table, and a token outside them gives a zero row
    (the masked lookup; the sum over the shards is the whole lookup)."""
    tok = p["tok"]
    if vocab_offset is None:
        return tok[tokens]
    local = tokens - vocab_offset
    mine = (local >= 0) & (local < tok.shape[0])
    rows = tok[local.clamp(0, tok.shape[0] - 1)]
    return torch.where(mine[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))


def scale_embedding(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Looked-up rows in the compute dtype, with gemma's sqrt(d) scaling."""
    x = x.to(_dtype(cfg.compute_dtype))
    if cfg.norm.startswith("rmsnorm") and cfg.tie_embeddings:
        # gemma-style embedding scaling for tied embeddings, in the compute
        # dtype (sqrt(d_model) rounded to it first, as the JAX package does)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return shard(x, ("batch", "seq", "embed"))


def embed_tokens(p: Params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return scale_embedding(embed_rows(p, tokens), cfg)


def logits_from_hidden(p: Params, x: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """float32 logits through the tied embedding or the untied
    unembedding, then the final softcap ``tanh(logits / cap) * cap``
    (gemma2: 30).  On a vocabulary shard: the shard's columns of the
    logits (the softcap is elementwise)."""
    cdt = _dtype(cfg.compute_dtype)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x.to(cdt), p["tok"].to(cdt))
    else:
        logits = x.to(cdt) @ p["unembed"].to(cdt)
    logits = logits.float()
    if cfg.logit_softcap is not None:
        logits = torch.tanh(div(logits, cfg.logit_softcap)) \
            * cfg.logit_softcap
    return shard(logits, ("batch", "seq", "vocab"))
