"""Mamba2 block via SSD (state-space duality), the port of
``repro/models/ssm.py``.

The SSD computation (Dao & Gu 2024, arXiv:2405.21060) for scalar-A heads:

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t x_t
    y_t = C_t^T h_t + D x_t

Prefill computes it chunkwise: through the CUDA kernel of
:mod:`repro_torch.kernels.ssd_scan` when ``cfg.use_flash_kernel`` is set,
else through :func:`ssd_chunked`, the model's plain chunked path.  Decode
uses the O(1) recurrent form with a persistent (state, conv) cache.

The JAX version's ``layer_index`` (a stacked cache addressed in place) is
not carried over: the port's stack hands each layer its own cache slice.
Its ``logically_sharded`` annotations are no-ops on one device and are
dropped.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, _dtype, truncated_normal_init


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, n_heads, head_dim) of the SSM block."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    assert d_inner % s.head_dim == 0
    return d_inner, d_inner // s.head_dim, s.head_dim


def mamba2_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...],
                                                       torch.dtype]]:
    """Name -> (shape, dtype) of one mixer's parameters."""
    s = cfg.ssm
    dt = _dtype(cfg.param_dtype)
    d = cfg.d_model
    d_inner, nheads, _ = ssm_dims(cfg)
    conv_dim = d_inner + 2 * s.d_state
    f32 = torch.float32
    return {
        "in_proj": ((d, 2 * d_inner + 2 * s.d_state + nheads), dt),
        "conv_w": ((s.conv_width, conv_dim), dt),
        "conv_b": ((conv_dim,), dt),
        "a_log": ((nheads,), f32),
        "dt_bias": ((nheads,), f32),
        "d_skip": ((nheads,), f32),
        "norm_scale": ((d_inner,), dt),
        "out_proj": ((d_inner, d), dt),
    }


def _dt_bias_init(gen: torch.Generator, nheads: int, dt_min: float,
                  dt_max: float) -> torch.Tensor:
    """dt bias initialised so softplus(dt_bias) spans [dt_min, dt_max]."""
    u = torch.rand(nheads, generator=gen, dtype=torch.float32,
                   device=gen.device)
    dt_init = torch.exp(u * (math.log(dt_max) - math.log(dt_min))
                        + math.log(dt_min))
    return dt_init + torch.log(-torch.expm1(-dt_init))  # inverse softplus


def init_mamba2(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    dt = _dtype(cfg.param_dtype)
    d = cfg.d_model
    d_inner, nheads, _ = ssm_dims(cfg)
    conv_dim = d_inner + 2 * s.d_state
    dt_bias = _dt_bias_init(gen, nheads, s.dt_min, s.dt_max)
    return {
        # fused input projection: [z (gate), x, B, C, dt]
        "in_proj": truncated_normal_init(
            gen, (d, 2 * d_inner + 2 * s.d_state + nheads),
            1.0 / math.sqrt(d), dt),
        "conv_w": truncated_normal_init(gen, (s.conv_width, conv_dim),
                                        1.0 / math.sqrt(s.conv_width), dt),
        "conv_b": torch.zeros(conv_dim, dtype=dt),
        "a_log": torch.log(torch.arange(1, nheads + 1, dtype=torch.float32)),
        "dt_bias": dt_bias,
        "d_skip": torch.ones(nheads, dtype=torch.float32),
        "norm_scale": torch.ones(d_inner, dtype=dt),  # gated RMSNorm
        "out_proj": truncated_normal_init(gen, (d_inner, d),
                                          1.0 / math.sqrt(d_inner), dt),
    }


def mamba2_param_specs() -> Dict[str, tuple]:
    """Logical axes of :func:`init_mamba2`'s leaves."""
    return {
        "in_proj": ("embed", "inner"),
        "conv_w": (None, "inner"),
        "conv_b": ("inner",),
        "a_log": (None,),
        "dt_bias": (None,),
        "d_skip": (None,),
        "norm_scale": ("inner",),
        "out_proj": ("inner", "embed"),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    s = cfg.ssm
    d_inner, _, _ = ssm_dims(cfg)
    idx = [d_inner, 2 * d_inner, 2 * d_inner + s.d_state,
           2 * d_inner + 2 * s.d_state]
    z = proj[..., : idx[0]]
    x = proj[..., idx[0]: idx[1]]
    B = proj[..., idx[1]: idx[2]]
    C = proj[..., idx[2]: idx[3]]
    dt = proj[..., idx[3]:]
    return z, x, B, C, dt


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD over a full sequence (the model's plain path).

    x (b, s, h, p), dt (b, s, h), A (h,), B/C (b, s, n), optional initial
    state (b, h, p, n).  A sequence that is not a chunk multiple is padded
    with zeros (dt = 0 makes the pad positions exact no-ops).  Returns
    y (b, s, h, p) in x's dtype and the final state (b, h, p, n) float32.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    s_orig = s
    if s % chunk:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        s = s + pad
    nc = s // chunk

    xc = x.float().reshape(b, nc, chunk, h, p)
    dtc = dt.float().reshape(b, nc, chunk, h)
    Bc = B.float().reshape(b, nc, chunk, n)
    Cc = C.float().reshape(b, nc, chunk, n)

    dA = dtc * A[None, None, None, :]                  # (b,nc,Q,h), negative
    cum = torch.cumsum(dA, dim=2)                      # within-chunk cumulative

    # ---- intra-chunk (the 'attention-like' quadratic term) -----------------
    li = cum[:, :, :, None, :]                         # (b,nc,Q,1,h)
    lj = cum[:, :, None, :, :]                         # (b,nc,1,Q,h)
    mask = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    # Mask before the exp: above the diagonal cum_i - cum_j > 0 can pass
    # ~88 and exp overflows to inf there, and the backward of exp would then
    # multiply the masked zero gradient by inf (NaN).  exp(-inf) = 0, so
    # the forward is bit for bit what masking after the exp gives.
    L = torch.exp(torch.where(mask[None, None, :, :, None], li - lj,
                              float("-inf")))
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    M = scores[..., None] * L * dtc[:, :, None, :, :]  # (b,nc,Q,Q,h)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xc)

    # ---- chunk states -------------------------------------------------------
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (b,nc,Q,h)
    weighted_x = (decay_to_end * dtc)[..., None] * xc  # (b,nc,Q,h,p)
    states = torch.einsum("bcjhp,bcjn->bchpn", weighted_x, Bc)

    # ---- inter-chunk scan ---------------------------------------------------
    chunk_decay = torch.exp(dA.sum(dim=2))             # (b,nc,h)
    st = (torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
          if initial_state is None else initial_state.float())
    entering = []
    for c in range(nc):
        entering.append(st)                            # state ENTERING chunk
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)            # (b,nc,h,p,n)

    # ---- inter-chunk output term -------------------------------------------
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc, entering)
    y_inter = y_inter * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(b, s, h, p)[:, :s_orig]
    return y.to(x.dtype), st


def ssd_recurrent_step(x, dt, A, B, C, state):
    """Single-token recurrent update (decode).

    x: (b, h, p), dt: (b, h), B/C: (b, n), state: (b, h, p, n)
    Returns (y (b,h,p), new_state).
    """
    dtf = dt.float()
    dA = torch.exp(dtf * A)[..., None, None]                     # (b,h,1,1)
    # dt_h B_n x_hp as two broadcast products (the einsum of three
    # operands would plan its contraction on the host at every step)
    dBx = (dtf[:, :, None] * B.float()[:, None, :])[:, :, None, :] \
        * x.float()[..., None]
    new_state = state * dA + dBx
    y = torch.einsum("bhpn,bn->bhp", new_state, C.float())
    return y.to(x.dtype), new_state


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 carry: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d over (B, S, Cdim) with width-W filter (W, Cdim).

    ``carry`` is the last W-1 inputs from the previous segment (decode).
    Returns (out, new_carry).
    """
    W = w.shape[0]
    pad = (torch.zeros(seq.shape[0], W - 1, seq.shape[2], dtype=seq.dtype,
                       device=seq.device)
           if carry is None else carry.to(seq.dtype))
    full = torch.cat([pad, seq], dim=1)                 # (B, S+W-1, C)
    out = torch.zeros(seq.shape, dtype=torch.float32, device=seq.device)
    for i in range(W):
        out = out + full[:, i: i + seq.shape[1], :].float() * w[i].float()
    out = out + b.float()
    new_carry = full[:, full.shape[1] - (W - 1):, :]
    return F.silu(out).to(seq.dtype), new_carry


def _ssd_prefill(xh, dt, A, Bc, Cc, s, init_state, use_kernel: bool):
    """The SSD over a prompt of (b, S, h, p) ``xh``: the CUDA kernel with
    ``use_kernel`` (through ``kernels.ops.ssd_scan``), else
    :func:`ssd_chunked`.  Returns (y (b, S, h, p), final state)."""
    S = xh.shape[1]
    if use_kernel:
        from repro_torch.kernels.ops import ssd_scan as ssd_kernel
        # the kernel takes only chunk multiples: zero-pad as
        # ssd_chunked does (dt = 0 makes the pad exact) and slice back
        pad = -S % min(s.chunk, S)
        kx, kdt, kB, kC = xh, dt, Bc, Cc
        if pad:
            kx = F.pad(xh, (0, 0, 0, 0, 0, pad))
            kdt = F.pad(dt, (0, 0, 0, pad))
            kB = F.pad(Bc, (0, 0, 0, pad))
            kC = F.pad(Cc, (0, 0, 0, pad))
        y, final_state = ssd_kernel(kx, kdt, A, kB, kC, chunk=s.chunk,
                                    initial_state=init_state)
        return y[:, :S], final_state
    return ssd_chunked(xh, dt, A, Bc, Cc, chunk=min(s.chunk, S),
                       initial_state=init_state)


def _mixer_ssm(cfg: ModelConfig, z, x, Bv, Cv, dt_raw, p: Params, heads,
               d_inner: int, nheads: int, cache, use_kernel: bool):
    """The conv, the SSD and the skip of a mixer over ``nheads`` heads of
    ``d_inner`` channels (the whole mixer, or a shard's heads: ``heads``
    slices ``a_log``, ``dt_bias`` and ``d_skip``, whole when None).
    Returns (y (B, S, d_inner) float32 before the gate, the new cache or
    None)."""
    s = cfg.ssm
    Bsz, S = x.shape[:2]
    hd = s.head_dim
    sl = slice(None) if heads is None else heads
    xbc = torch.cat([x, Bv, Cv], dim=-1)
    A = -torch.exp(p["a_log"][sl])                                  # (h,)
    dt = F.softplus(dt_raw.float() + p["dt_bias"][sl])              # (b,s,h)
    d_skip = p["d_skip"][sl]

    if cache is not None and S == 1:
        xbc_out, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                         cache["conv"])
        xx = xbc_out[..., :d_inner]
        Bc = xbc_out[..., d_inner: d_inner + s.d_state]
        Cc = xbc_out[..., d_inner + s.d_state:]
        xh = xx.reshape(Bsz, nheads, hd)
        y, new_state = ssd_recurrent_step(xh, dt[:, 0], A, Bc[:, 0], Cc[:, 0],
                                          cache["state"].float())
        y = y + d_skip[None, :, None] * xh.float()
        y = y.reshape(Bsz, 1, d_inner)
        return y, {"state": new_state.to(cache["state"].dtype),
                   "conv": new_conv.to(cache["conv"].dtype)}
    xbc_out, conv_carry = _causal_conv(
        xbc, p["conv_w"], p["conv_b"],
        cache["conv"] if cache is not None else None)
    xx = xbc_out[..., :d_inner]
    Bc = xbc_out[..., d_inner: d_inner + s.d_state]
    Cc = xbc_out[..., d_inner + s.d_state:]
    # views of the conv output: the kernel reads these strided slices
    # in place (batch and sequence strides are its arguments)
    xh = xx.reshape(Bsz, S, nheads, hd)
    init_state = cache["state"] if cache is not None else None
    y, final_state = _ssd_prefill(xh, dt, A, Bc, Cc, s, init_state,
                                  use_kernel)
    y = y + d_skip[None, None, :, None].float() * xh.float()
    y = y.reshape(Bsz, S, d_inner)
    new_cache = None
    if cache is not None:
        new_cache = {"state": final_state.to(cache["state"].dtype),
                     "conv": conv_carry.to(cache["conv"].dtype)}
    return y, new_cache


def apply_mamba2(p: Params, xin: torch.Tensor, cfg: ModelConfig, *,
                 cache: Optional[Mapping[str, torch.Tensor]] = None,
                 use_kernel: bool = False
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Mamba2 mixer over (B, S, D).

    cache (serving): {'state': (B,h,p,n), 'conv': (B, W-1, conv_dim)}.
    When ``cache`` is provided and S == 1 the recurrent path is used.
    """
    cdt = _dtype(cfg.compute_dtype)
    d_inner, nheads, hd = ssm_dims(cfg)

    proj = torch.einsum("bsd,de->bse", xin.to(cdt), p["in_proj"].to(cdt))
    z, x, Bv, Cv, dt_raw = _split_proj(cfg, proj)
    y, new_cache = _mixer_ssm(cfg, z, x, Bv, Cv, dt_raw, p, None, d_inner,
                              nheads, cache, use_kernel)

    # gated RMSNorm (mamba2: norm(y * silu(z)))
    yg = y.float() * F.silu(z.float()).reshape(y.shape)
    var = yg.square().mean(dim=-1, keepdim=True)
    yn = yg * torch.rsqrt(var + cfg.norm_eps) * p["norm_scale"].float()
    out = torch.einsum("bse,ed->bsd", yn.to(cdt), p["out_proj"].to(cdt))
    return out.to(xin.dtype), new_cache


# --------------------------------------------------------------------------- #
# A mixer split over its heads (tensor parallelism over ``inner``)
# --------------------------------------------------------------------------- #

def shard_dims(cfg: ModelConfig, m: int) -> Tuple[int, int]:
    """(channels, heads) of one of ``m`` head-aligned shards of the mixer:
    ``d_inner / m`` and ``n_heads / m``.  Raises ValueError where ``m``
    does not divide the heads (a shard never runs the whole mixer in a
    split's place)."""
    d_inner, nheads, _ = ssm_dims(cfg)
    if nheads % m:
        raise ValueError(f"{cfg.name}: a model extent of {m} does not "
                         f"divide the {nheads} SSM heads")
    return d_inner // m, nheads // m


def apply_mamba2_shard(p: Params, xin: torch.Tensor, cfg: ModelConfig,
                       m: int, j: int, *,
                       cache: Optional[Mapping[str, torch.Tensor]] = None,
                       use_kernel: bool = False):
    """Shard ``j`` of ``m`` of the mixer over (B, S, D), up to the gated
    RMSNorm's statistic.  ``p`` holds the shard's head-aligned pieces
    (``distributed.tensor_parallel``): ``in_proj`` (d, [z, x, dt] of its
    heads, then B and C whole), ``conv_w`` / ``conv_b`` (its x channels,
    then B and C), ``norm_scale`` and ``out_proj`` (its channels), and
    ``a_log``, ``dt_bias`` and ``d_skip`` whole (its heads sliced here).
    z, x and dt are one product; B and C another, of the same shape on
    every shard, so every shard computes the same B and C (and conv
    carry) to the bit.  The SSD runs over the shard's heads (one kernel
    call with ``use_kernel``).  cache: the shard's {'state': (B, h/m, p,
    n), 'conv': (B, W-1, d_inner/m + 2n)}.

    Returns (the gated output y·silu(z) (B, S, d_inner/m) float32, its
    sum of squares over the channels (B, S, 1) float32, the new cache or
    None); :func:`mamba2_shard_out` finishes it from the sums of every
    shard."""
    s = cfg.ssm
    cdt = _dtype(cfg.compute_dtype)
    dis, hs = shard_dims(cfg, m)
    n = s.d_state
    w = p["in_proj"].to(cdt)
    if w.shape[-1] != 2 * dis + hs + 2 * n or p["out_proj"].shape[0] != dis:
        raise ValueError(f"shard {j} of {m}: in_proj {tuple(w.shape)} and "
                         f"out_proj {tuple(p['out_proj'].shape)} are not "
                         f"a head-aligned piece of {dis} channels")
    xc = xin.to(cdt)
    # float32 sums rounded once, as the unsplit product's are: the library
    # splits a bf16 product of a decode step's few rows over k and rounds
    # its partial sums to bf16 (on an H100, 40% of z and x of
    # mamba2-130m's shard at 8 rows then differ from the unsplit's)
    zxdt = _product_f32(xc, w[:, :2 * dis + hs]).to(cdt)
    bc = _product_f32(xc, w[:, 2 * dis + hs:]).to(cdt)
    z, x, dt_raw = zxdt[..., :dis], zxdt[..., dis:2 * dis], zxdt[..., 2 * dis:]
    y, new_cache = _mixer_ssm(cfg, z, x, bc[..., :n], bc[..., n:], dt_raw,
                              p, slice(j * hs, (j + 1) * hs), dis, hs, cache,
                              use_kernel)
    yg = y.float() * F.silu(z.float()).reshape(y.shape)
    return yg, yg.square().sum(dim=-1, keepdim=True), new_cache


def _product_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a`` (..., k) times ``w`` (k, n), both in the compute dtype, with
    the product's float32 sums kept (not rounded to the compute dtype): a
    bf16 product on the card (and on the meta device, which stands for it)
    through ``torch.mm``'s ``out_dtype``, elsewhere on float32 copies of
    the operands.  Under autograd (``out_dtype`` has no backward) the
    product is rounded to the compute dtype, as the unsplit one is."""
    a2 = a.reshape(-1, a.shape[-1])
    if a.dtype == torch.float32:
        out = a2 @ w
    elif torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
        out = (a2 @ w).float()
    elif a.device.type in ("cuda", "meta"):
        out = torch.mm(a2, w, out_dtype=torch.float32)
    else:
        out = a2.float() @ w.float()
    return out.reshape(*a.shape[:-1], w.shape[-1])


def mamba2_shard_out(p: Params, yg: torch.Tensor, sumsq: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """A shard's partial output from its gated ``yg`` and the sum over
    every shard of the squares (``sumsq``, (B, S, 1)): the gated RMSNorm
    over all d_inner channels, then the row-parallel ``out_proj`` -- the
    partial sum of the mixer's output, in float32: the all-reduce adds
    the shards' partials and rounds once, as the unsplit product's sums
    are rounded once (a bf16 rounding a shard would add m roundings'
    noise to every layer's output)."""
    cdt = _dtype(cfg.compute_dtype)
    var = sumsq / ssm_dims(cfg)[0]
    yn = yg * torch.rsqrt(var + cfg.norm_eps) * p["norm_scale"].float()
    return _product_f32(yn.to(cdt), p["out_proj"].to(cdt))


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None, n_shards: int = 1) -> Dict[str, torch.Tensor]:
    """The mixer's zeroed state (B, h, p, n) and conv carry (B, W-1,
    d_inner + 2n); ``n_shards``: one head-aligned shard's, (B, h/m, p,
    n) and (B, W-1, d_inner/m + 2n)."""
    s = cfg.ssm
    d_inner, nheads, hd = ssm_dims(cfg)
    if n_shards > 1:
        d_inner, nheads = shard_dims(cfg, n_shards)
    conv_dim = d_inner + 2 * s.d_state
    return {
        "state": torch.zeros(batch, nheads, hd, s.d_state, dtype=dtype,
                             device=device),
        "conv": torch.zeros(batch, s.conv_width - 1, conv_dim, dtype=dtype,
                            device=device),
    }


class Mamba2Mixer(nn.Module):
    """The Mamba2 mixer's parameters (names of :func:`mamba2_shapes`) and
    :func:`apply_mamba2` over them.  ``gen`` None leaves them uninitialised
    (to be loaded)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        if gen is not None:
            init = init_mamba2(gen, cfg)
        else:
            init = {k: torch.empty(shape, dtype=dt, device="meta")
                    for k, (shape, dt) in mamba2_shapes(cfg).items()}
        for k, v in init.items():
            if gen is not None:
                v = v.to(device)
            self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters(recurse=False))

    def forward(self, x: torch.Tensor, cache=None, use_kernel: bool = False):
        return apply_mamba2(self.params(), x, self.cfg, cache=cache,
                            use_kernel=use_kernel)
