"""Model assembly of the port: init / forward / prefill / decode for the
ssm family (the Mamba2 stack, attention-free), the dense family (the
pre-norm transformer: GQA attention + MLP), the moe family (the same
transformer with a mixture-of-experts block, ``models/moe.py``, in place
of the MLP), the hybrid family (zamba2: a Mamba2 stack with one shared
transformer block applied after every ``shared_attn_every`` layers) and
the encdec family (whisper: an encoder of dense blocks with unmasked
self-attention over the stub frontend's frame embeddings, and a causal
decoder whose layers add cross-attention over the encoder's output).

The port of ``repro/models/model.py`` for every family.  Each stack is an
``nn.Module`` (:class:`Mamba2LM`, :class:`DenseLM`, :class:`HybridLM`,
:class:`EncDecLM`: embedding, a ``ModuleList`` of blocks looped in
Python, final norm; the hybrid model also holds ``shared``, one
:class:`DenseBlock` whose weights every use shares; the encdec model
``enc_blocks``, ``enc_norm`` and ``cross``, one :class:`CrossBlock` a
decoder layer); the JAX version's ``lax.scan`` over stacked parameters
has no counterpart here.  Its remat does, when autograd records the forward
(training): with ``cfg.remat == "full"`` each block runs under
``torch.utils.checkpoint.checkpoint``; with ``"dots"`` under torch's
selective checkpointing with :func:`remat_dots_policy`, which saves the
outputs of the block's products with no batch dimension (the projections)
and recomputes the rest, as ``jax.checkpoint_policies.
checkpoint_dots_with_no_batch_dims`` does.  In the hybrid stack only the
Mamba2 blocks are recomputed; the shared block runs outside the
checkpoint, as in the JAX package, and its gradient is the sum over its
uses.  In the encdec stack each encoder block and each decoder layer
(self-attention, cross-attention and MLP) is recomputed.
:func:`loss_fn` is the training loss, plus the moe block's
load-balancing loss averaged over the layers.  The dense family covers
every dense config
of the registry: olmo-1b, gemma2-27b (alternating local/global windows,
both softcaps, ``(1 + scale)`` rmsnorms and post-block norms),
stablelm-1.6b (LayerNorm with bias, partial RoPE, an untied head),
starcoder2-3b (LayerNorm, plain GELU, a sliding window) and qwen2-vl-7b
(M-RoPE over (B, 3, S) positions; text gives three equal streams); the
moe family olmoe-1b-7b (64 experts, top-8) and deepseek-moe-16b (64
routed top-6 and 2 shared experts); the hybrid family zamba2-7b (81
Mamba2 layers, the shared block after every 6: 13 uses and 3 remainder
layers); the encdec family whisper-large-v3 (32 encoder and 32 decoder
layers, 1,500 frames).

Parameters are built frozen (``requires_grad=False``), as serving wants
them; the training entry points (``repro_torch.train.step``) turn
``requires_grad`` on.  Parameter names follow the JAX pytree:
``embed.tok``, ``blocks.<i>.norm.scale``, ``blocks.<i>.mixer.<name>``
(ssm, hybrid), ``blocks.<i>.attn.wq``, ``blocks.<i>.mlp.w_up``, ...
(dense; the non-parametric norms hold no leaves, LayerNorm adds
``bias``), ``blocks.<i>.moe.router``, ``blocks.<i>.moe.w_up``, ... (moe),
``blocks.<i>.post_attn_norm`` / ``post_mlp_norm`` (gemma2),
``shared.attn_norm.scale``, ``shared.attn.wq``, ``shared.mlp.w_up``, ...
(hybrid), ``enc_blocks.<i>.attn.wq``, ``enc_norm.scale``,
``cross.<i>.norm.scale``, ``cross.<i>.attn.wk``, ... (encdec),
``final_norm.scale``, ``embed.unembed`` (an untied head);
:func:`from_reference` carries the JAX package's ``init_params`` pytree
(as numpy arrays, layer-stacked ``(L, ...)`` leaves under ``blocks``,
``enc_blocks`` and ``cross``, the hybrid's ``shared`` leaves unstacked)
across dtype for dtype.

The serving caches mirror the JAX ones.  ssm: ``{"ssm": {"state": (L, B,
h, p, n), "conv": (L, B, W-1, conv_dim)}, "index": int}``, written in
place layer by layer; the SSM state and conv carry are float32 whatever
``cache_dtype`` prefill is given, as in the JAX package.  dense and moe: ``{"kv": {"k", "v": (L, B, G,
max_seq, hd)},
"index": int}`` in ``cache_dtype``, written in place layer by layer (the
JAX decode path's ``layer_index`` form); with ``kv_cache_quant`` the K/V
are int8 codes beside float32 ``k_scale``/``v_scale`` of (L, B, G,
max_seq), whatever ``cache_dtype``.  hybrid: both, the ``"ssm"`` part for
all L layers and the ``"kv"`` part for the ``L // shared_attn_every``
uses of the shared block, both written in place.  encdec: the dense
``"kv"`` for the decoder's self-attention, and ``"cross_k"`` and
``"cross_v"`` of (L, B, G, enc_seq, hd) in ``cache_dtype``, written once
by the prefill and read by every decode step.  Entry points run on CUDA
unless given ``device="cpu"``.

A model split over a mesh's model axis
(``distributed.tensor_parallel.SplitLM``: one module a mesh position) of
any family runs through the same :func:`forward`, :func:`prefill`,
:func:`decode_step` and :func:`loss_fn`: the global batch split over the
data positions (or run whole by each, where it does not split), and each
block looped over the model positions from one controller, the partial
outputs of the attention, the MLP, the moe block and the Mamba2 mixer
joined by ``distributed.collectives`` (:func:`_split_group` for the
transformer stack, :func:`_split_encdec` for the encdec stack,
:func:`_split_recurrent` for the Mamba2 and hybrid stacks, which run the
data indices in lockstep so that a decode step's attention can combine a
K/V sequence that lies over the data positions).  The attention takes
the rules' layout (:func:`_split_attention`): each shard's heads, or
where the heads do not divide the model axis context parallelism
(``kv_seq``) or the ``head_dim`` split
(``models/parallel_attention.py``).  Its cache holds each position's K/V
(and cross K/V) and SSM state (``SplitLM.init_cache``).
"""
from __future__ import annotations

import functools
import math
import warnings
from typing import Any, Dict, Mapping, Optional, Tuple, Type, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import div, resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import sharding_context
from repro_torch.launch import cost_analysis as CA
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import parallel_attention as PA
from repro_torch.models import ssm as SSM

Cache = Dict[str, Any]


FAMILIES = ("ssm", "dense", "moe", "hybrid", "encdec")
# the families of the transformer stack (DenseLM)
ATTENTION_FAMILIES = ("dense", "moe")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.family == "hybrid" and cfg.post_block_norm:
        raise ValueError(
            "a hybrid config with post_block_norm: the JAX package's shared "
            "block (_shared_block) applies no post-block norms")
    if cfg.family == "encdec" and cfg.post_block_norm:
        raise ValueError(
            "an encdec config with post_block_norm: the JAX package's "
            "encoder and decoder layers (_encoder, _decoder_stack) apply no "
            "post-block norms")
    L.check_ported(cfg)


def _norm(params: Dict[str, torch.Tensor], device=None) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v.to(device), requires_grad=False)
                             for k, v in params.items()})


class Mamba2Block(nn.Module):
    """Pre-norm residual block around a Mamba2 mixer."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.norm = _norm(L.init_norm(gen, cfg, cfg.d_model),
                          device if gen is not None else "meta")
        self.mixer = SSM.Mamba2Mixer(cfg, gen, device)

    def forward(self, x: torch.Tensor, cache=None, use_kernel: bool = False):
        return _apply_ssm_block(self, x, self.cfg, cache=cache,
                                use_kernel=use_kernel)


class Mamba2LM(nn.Module):
    """The mamba2 language model's parameters: embedding, blocks, final
    norm (run by :func:`forward`).  ``gen`` None builds it on the meta
    device, to be loaded (:func:`from_reference`)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        _require_ported(cfg)
        self.cfg = cfg
        dev = device if gen is not None else "meta"
        self.embed = _norm(L.init_embedding(gen, cfg), dev)
        self.blocks = nn.ModuleList(Mamba2Block(cfg, gen, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _norm(L.init_norm(gen, cfg, cfg.d_model), dev)


class DenseBlock(nn.Module):
    """Pre-norm transformer block's parameters: attention and the MLP (the
    moe family: the MoE block, ``moe``), each behind a norm (plus gemma2's
    post-block norms when ``cfg.post_block_norm``); run by
    :func:`_apply_dense_block` under the caller's config."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        dev = device if gen is not None else "meta"
        d = cfg.d_model
        self.attn_norm = _norm(L.init_norm(gen, cfg, d), dev)
        self.attn = _norm(L.init_attention(gen, cfg), dev)
        self.mlp_norm = _norm(L.init_norm(gen, cfg, d), dev)
        if cfg.family == "moe":
            self.moe = _norm(MOE.init_moe(gen, cfg), dev)
        else:
            self.mlp = _norm(L.init_mlp(gen, cfg), dev)
        if cfg.post_block_norm:
            self.post_attn_norm = _norm(L.init_norm(gen, cfg, d), dev)
            self.post_mlp_norm = _norm(L.init_norm(gen, cfg, d), dev)


class DenseLM(nn.Module):
    """The dense (and moe) language model's parameters: embedding, blocks,
    final norm (run by :func:`forward`).  ``gen`` None builds it on the meta
    device, to be loaded (:func:`from_reference`)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        _require_ported(cfg)
        self.cfg = cfg
        dev = device if gen is not None else "meta"
        self.embed = _norm(L.init_embedding(gen, cfg), dev)
        self.blocks = nn.ModuleList(DenseBlock(cfg, gen, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _norm(L.init_norm(gen, cfg, cfg.d_model), dev)


class HybridLM(nn.Module):
    """The hybrid (zamba2) language model's parameters: embedding, the
    shared transformer block (one :class:`DenseBlock`: attention and the
    gated MLP, each behind a norm), the Mamba2 blocks and the final norm
    (run by :func:`forward`), drawn in that order.  ``gen`` None builds it
    on the meta device, to be loaded (:func:`from_reference`)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        _require_ported(cfg)
        self.cfg = cfg
        dev = device if gen is not None else "meta"
        self.embed = _norm(L.init_embedding(gen, cfg), dev)
        self.shared = DenseBlock(cfg, gen, device)
        self.blocks = nn.ModuleList(Mamba2Block(cfg, gen, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _norm(L.init_norm(gen, cfg, cfg.d_model), dev)


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config the encoder's blocks are built and run under, as the JAX
    package's ``cfg.replace(family="dense")``."""
    return cfg.replace(family="dense")


class CrossBlock(nn.Module):
    """One decoder layer's cross-attention parameters: the norm before it
    and the projections ``wq``, ``wk``, ``wv``, ``wo`` (``attn``, shaped
    as self-attention's)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        dev = device if gen is not None else "meta"
        self.norm = _norm(L.init_norm(gen, cfg, cfg.d_model), dev)
        self.attn = _norm(L.init_attention(gen, cfg), dev)


class EncDecLM(nn.Module):
    """The encdec (whisper) model's parameters: embedding, the encoder's
    ``n_enc_layers`` dense blocks and its final norm, one
    :class:`CrossBlock` and one decoder :class:`DenseBlock` a decoder
    layer, and the final norm (run by :func:`forward`), drawn in that
    order.  ``gen`` None builds it on the meta device, to be loaded
    (:func:`from_reference`)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        _require_ported(cfg)
        self.cfg = cfg
        dev = device if gen is not None else "meta"
        enc_cfg = _encoder_cfg(cfg)
        self.embed = _norm(L.init_embedding(gen, cfg), dev)
        self.enc_blocks = nn.ModuleList(DenseBlock(enc_cfg, gen, device)
                                        for _ in range(cfg.n_enc_layers))
        self.enc_norm = _norm(L.init_norm(gen, cfg, cfg.d_model), dev)
        self.cross = nn.ModuleList(CrossBlock(cfg, gen, device)
                                   for _ in range(cfg.n_layers))
        self.blocks = nn.ModuleList(DenseBlock(cfg, gen, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _norm(L.init_norm(gen, cfg, cfg.d_model), dev)


LM = Union[Mamba2LM, DenseLM, HybridLM, EncDecLM]
_CLASSES = {"ssm": Mamba2LM, "dense": DenseLM, "moe": DenseLM,
            "hybrid": HybridLM, "encdec": EncDecLM}


def model_class(cfg: ModelConfig) -> Type[nn.Module]:
    """The module class of ``cfg``'s family."""
    _require_ported(cfg)
    return _CLASSES[cfg.family]


def init_params(gen: Union[int, torch.Generator], cfg: ModelConfig,
                device=None) -> LM:
    """Randomly initialised model on ``device`` (default CUDA).  A seed or
    a CPU ``torch.Generator`` draws on the CPU, so a seed gives the same
    weights on every device; a CUDA generator draws on its card (the
    full-width models: gemma2-27b's 27.2 B draws would take minutes on the
    CPU), with the same formula and in the same order."""
    _require_ported(cfg)
    dev = resolve_device(device)
    if isinstance(gen, int):
        gen = torch.Generator().manual_seed(gen)
    return model_class(cfg)(cfg, gen, dev)


# --------------------------------------------------------------------------- #
# Blocks, caches, stack
# --------------------------------------------------------------------------- #

def _apply_ssm_block(bp: Mamba2Block, x, cfg: ModelConfig, *, cache=None,
                     use_kernel=False):
    h = L.apply_norm(bp.norm, x, cfg)
    mix, new_cache = bp.mixer(h, cache=cache, use_kernel=use_kernel)
    return x + mix, new_cache


def _is_split(params) -> bool:
    return getattr(params, "is_split", False)


def _apply_dense_block(bp: DenseBlock, x, cfg: ModelConfig, *, positions,
                       layer_is_local: bool, causal: bool = True, cache=None,
                       cache_index=None, layer_index=None):
    h = L.apply_norm(bp.attn_norm, x, cfg)
    attn_out, new_cache = L.multi_head_attention(
        bp.attn, h, cfg, positions=positions, layer_is_local=layer_is_local,
        causal=causal, cache=cache, cache_index=cache_index,
        layer_index=layer_index)
    if cfg.post_block_norm:
        attn_out = L.apply_norm(bp.post_attn_norm, attn_out, cfg)
    x = x + attn_out
    h = L.apply_norm(bp.mlp_norm, x, cfg)
    aux = {}
    if cfg.family == "moe":
        ffn_out, aux = MOE.apply_moe(bp.moe, h, cfg)
    else:
        ffn_out = L.apply_mlp(bp.mlp, h, cfg)
    if cfg.post_block_norm:
        ffn_out = L.apply_norm(bp.post_mlp_norm, ffn_out, cfg)
    return x + ffn_out, new_cache, aux


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Cache:
    """Serving cache for the ported families.  ssm: ``max_seq`` and
    ``dtype`` do not enter it (the SSM cache has no sequence axis and is
    float32).  dense and moe: zeroed K and V of (L, B, G, max_seq, hd) in
    ``dtype``; with ``kv_cache_quant``, int8 K and V codes and float32
    scales of (L, B, G, max_seq) set to 1 (``dtype`` does not enter).
    hybrid: the ssm family's cache for its L layers and the K/V for the
    ``L // shared_attn_every`` uses of the shared block.  encdec: the
    decoder's K/V as the dense family's, and the cross-attention's
    ``cross_k`` and ``cross_v`` of (L, B, G, enc_seq, hd) in ``dtype``,
    zeroed, written once by the prefill."""
    _require_ported(cfg)
    dev = resolve_device(device)

    def kv(n_layers: int) -> Dict[str, torch.Tensor]:
        return init_kv_cache(cfg, n_layers, batch, max_seq, dtype, dev)

    if cfg.family in ATTENTION_FAMILIES:
        return {"kv": kv(cfg.n_layers), "index": 0}
    if cfg.family == "encdec":
        a = cfg.attention
        shape = (cfg.n_layers, batch, a.n_kv_heads, cfg.enc_seq, a.head_dim)
        return {"kv": kv(cfg.n_layers),
                "cross_k": torch.zeros(shape, dtype=dtype, device=dev),
                "cross_v": torch.zeros(shape, dtype=dtype, device=dev),
                "index": 0}
    one = SSM.init_ssm_cache(cfg, batch, device=dev)
    st = {k: v[None].repeat(cfg.n_layers, *([1] * v.dim()))
          for k, v in one.items()}
    if cfg.family == "hybrid":
        return {"ssm": st, "kv": kv(cfg.n_layers // cfg.shared_attn_every),
                "index": 0}
    return {"ssm": st, "index": 0}


def init_kv_cache(cfg: ModelConfig, n_layers: int, batch: int, max_seq: int,
                  dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """Zeroed K and V of (n_layers, B, G, max_seq, hd) in ``dtype``; with
    ``kv_cache_quant``, int8 codes and float32 scales of (n_layers, B, G,
    max_seq) set to 1 (``dtype`` does not enter)."""
    a = cfg.attention
    shape = (n_layers, batch, a.n_kv_heads, max_seq, a.head_dim)
    if cfg.kv_cache_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.ones(shape[:4], device=device),
                "v_scale": torch.ones(shape[:4], device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_logical_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical sharding specs matching :func:`init_cache`'s structure (the
    cache keeps the JAX package's stacked ``(L, ...)`` layout)."""
    kv_spec = {"k": ("layers", "batch", "kv_heads", "kv_seq", "head_dim"),
               "v": ("layers", "batch", "kv_heads", "kv_seq", "head_dim")}
    if cfg.kv_cache_quant:
        kv_spec = dict(kv_spec,
                       k_scale=("layers", "batch", "kv_heads", "kv_seq"),
                       v_scale=("layers", "batch", "kv_heads", "kv_seq"))
    idx = ()
    if cfg.family in ATTENTION_FAMILIES:
        return {"kv": kv_spec, "index": idx}
    ssm_spec = {"state": ("layers", "batch", None, None, "state"),
                "conv": ("layers", "batch", None, "inner")}
    if cfg.family == "ssm":
        return {"ssm": ssm_spec, "index": idx}
    if cfg.family == "hybrid":
        return {"ssm": ssm_spec, "kv": kv_spec, "index": idx}
    if cfg.family == "encdec":
        cross = ("layers", "batch", "kv_heads", None, "head_dim")
        return {"kv": kv_spec, "cross_k": cross, "cross_v": cross,
                "index": idx}
    raise ValueError(cfg.family)


# --------------------------------------------------------------------------- #
# Logical sharding specs of the parameters -- resolved against a mesh by
# distributed.sharding's rules; the ZeRO-1 state (train/optimizer.py) widens
# them with the data axis.
# --------------------------------------------------------------------------- #

def _norm_spec(cfg: ModelConfig) -> Dict[str, tuple]:
    if cfg.norm in ("rmsnorm", "rmsnorm_one", "layernorm_nobias"):
        return {"scale": ("embed",)}
    if cfg.norm == "layernorm":
        return {"scale": ("embed",), "bias": ("embed",)}
    return {}  # nonparametric


def _block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """One block's specs (the JAX stacked leaf's without its leading
    ``"layers"``)."""
    if cfg.family in ("ssm", "hybrid"):
        return {"norm": _norm_spec(cfg), "mixer": SSM.mamba2_param_specs()}
    spec: Dict[str, Any] = {
        "attn_norm": _norm_spec(cfg),
        "attn": L.attention_param_specs(),
        "mlp_norm": _norm_spec(cfg),
    }
    if cfg.family == "moe":
        spec["moe"] = MOE.moe_param_specs(cfg)
    else:
        spec["mlp"] = L.mlp_param_specs(cfg)
    if cfg.post_block_norm:
        spec["post_attn_norm"] = _norm_spec(cfg)
        spec["post_mlp_norm"] = _norm_spec(cfg)
    return spec


def _flat_specs(prefix: str, tree: Dict[str, Any]) -> Dict[str, tuple]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(f"{prefix}{k}.", v))
        else:
            out[f"{prefix}{k}"] = v
    return out


def param_logical_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """The logical axes of every parameter, keyed by the port's parameter
    names (``named_parameters()``): a per-layer leaf (``blocks.3.attn.wq``)
    takes the JAX stacked leaf's spec without its leading ``"layers"``."""
    _require_ported(cfg)
    specs = _flat_specs("embed.", L.embedding_param_specs(cfg))
    stacks = [("blocks", cfg.n_layers, _block_spec(cfg))]
    if cfg.family == "encdec":
        stacks += [("enc_blocks", cfg.n_enc_layers,
                    _block_spec(_encoder_cfg(cfg))),
                   ("cross", cfg.n_layers,
                    {"norm": _norm_spec(cfg),
                     "attn": L.attention_param_specs()})]
        specs.update(_flat_specs("enc_norm.", _norm_spec(cfg)))
    if cfg.family == "hybrid":
        specs.update(_flat_specs("shared.", {
            "attn_norm": _norm_spec(cfg),
            "attn": L.attention_param_specs(),
            "mlp_norm": _norm_spec(cfg),
            "mlp": L.mlp_param_specs(cfg),
        }))
    for name, n, block in stacks:
        for i in range(n):
            specs.update(_flat_specs(f"{name}.{i}.", block))
    specs.update(_flat_specs("final_norm.", _norm_spec(cfg)))
    return specs


def sharding_dims(cfg: ModelConfig, global_batch: int,
                  kv_seq: Optional[int] = None,
                  q_seq: Optional[int] = None) -> Dict[str, int]:
    """Dimension sizes for distributed.sharding.resolve_rules divisibility.

    For the SSM 'inner' axis multiple tensors share the logical name with
    different sizes (in_proj out, conv channels, d_inner); the gcd is used
    so one rule fits all of them.
    """
    a = cfg.attention
    dims = {
        "batch": global_batch,
        "heads": a.n_heads,
        "kv_heads": a.n_kv_heads,
        "head_dim": a.head_dim,
        "vocab": cfg.vocab,
        "embed": cfg.d_model,
        "seq": kv_seq or 0,
        "kv_seq": kv_seq or 0,
        # query-sequence length: equals seq for train/prefill, 1 for decode
        "q_seq": q_seq if q_seq is not None else 0,
    }
    if cfg.family == "moe":
        m = cfg.moe
        dims["experts"] = m.n_experts
        dims["mlp"] = (m.n_shared * (m.shared_dff or m.expert_dff)
                       if m.n_shared else 0)
    else:
        dims["mlp"] = cfg.d_ff
    if cfg.ssm is not None:
        s = cfg.ssm
        di = s.expand * cfg.d_model
        nheads = di // s.head_dim
        in_proj_out = 2 * di + 2 * s.d_state + nheads
        conv_dim = di + 2 * s.d_state
        dims["inner"] = math.gcd(math.gcd(in_proj_out, conv_dim), di)
    return dims


def _remat(cfg: ModelConfig) -> str:
    """How each block is recomputed in the backward (the JAX package's
    ``_maybe_remat``): ``cfg.remat`` when autograd records the forward,
    ``"none"`` otherwise."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got "
                         f"{cfg.remat!r}")
    return cfg.remat if torch.is_grad_enabled() else "none"


_aten = torch.ops.aten
# The matrix products and the positions of their two operands.
_PRODUCTS = {_aten.mm.default: (0, 1), _aten.bmm.default: (0, 1),
             _aten.addmm.default: (1, 2), _aten.baddbmm.default: (1, 2)}
# Autograd nodes between a parameter and a product's operand that make
# the operand the parameter still: views and dtype casts.
_VIEW_OR_CAST = frozenset({
    "ViewBackward0", "UnsafeViewBackward0", "ReshapeAliasBackward0",
    "TBackward0", "TransposeBackward0", "PermuteBackward0",
    "ExpandBackward0", "AliasBackward0", "UnsqueezeBackward0",
    "SqueezeBackward0", "SqueezeBackward1", "ToCopyBackward0"})


def _is_weight(t: torch.Tensor) -> bool:
    """Whether a product's operand is a parameter: the parameter itself,
    or a view or dtype cast of one."""
    if isinstance(t, nn.Parameter) or isinstance(t._base, nn.Parameter):
        return True
    fn = t.grad_fn
    while fn is not None and type(fn).__name__ in _VIEW_OR_CAST:
        fn = fn.next_functions[0][0]
    return fn is not None and type(fn).__name__ == "AccumulateGrad"


def remat_dots_policy(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    """``remat="dots"``: save the output of every product with no batch
    dimension, recompute everything else (``jax.checkpoint_policies.
    checkpoint_dots_with_no_batch_dims``).

    A block's products with no batch dimension are its projections
    (``wq``/``wk``/``wv``/``wo``, the MLP's up/gate/down, the SSM's
    in/out projections, the moe router and shared experts); attention's
    score and PV products, the SSD's einsums and the moe expert products
    (``gecd,edf->gecf``: the expert axis is a batch dimension) carry one.
    The rule reads the operands, not the aten name: a product is saved
    when an operand is a parameter and no parameter operand has a batch
    dimension above 1.  ``einsum`` lowers some products with a weight
    operand (``wo``'s ``bhsk,hkd->bsd``) to a ``bmm`` of batch 1, saved;
    the expert products are ``bmm``s over the stacked (E, d, f) weights,
    recomputed."""
    ops = _PRODUCTS.get(func)
    if ops is not None:
        weights = [args[i] for i in ops if _is_weight(args[i])]
        if weights and all(w.dim() < 3 or w.shape[0] == 1 for w in weights):
            return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXTS = functools.partial(create_selective_checkpoint_contexts,
                                   remat_dots_policy)


def _checkpointed(remat: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` recomputed in the backward as ``remat``
    (``"full"`` or ``"dots"``) says."""
    if remat == "dots":
        kwargs["context_fn"] = _DOTS_CONTEXTS
    return checkpoint(fn, *args, use_reentrant=False, **kwargs)


def _layer_is_local_static(cfg: ModelConfig, i: int) -> bool:
    if cfg.attention.pattern == "alternating":
        return i % 2 == 0  # local on even layers (gemma2)
    return cfg.attention.pattern == "local"


def _dense_stack(params: DenseLM, x, cfg: ModelConfig, *, positions,
                 kv_cache=None, cache_index=None):
    """The dense (and moe) block stack, a Python loop over the blocks.
    With a cache (prefill and decode alike) each layer writes its slice of
    the stacked (L, B, G, max_seq, hd) buffers in place.

    Returns (x, cache, aux).  The moe blocks' aux, as the JAX package
    reduces it: without a cache the layers' sum over ``n``; a decode step
    (one token) the sum of each layer's value over ``n``; a prefill none."""
    remat = _remat(cfg) if kv_cache is None else "none"
    n = cfg.n_layers
    decode = kv_cache is not None and x.shape[1] == 1
    aux_tot: Dict[str, torch.Tensor] = {}
    for i, bp in enumerate(params.blocks):
        kw = dict(positions=positions,
                  layer_is_local=_layer_is_local_static(cfg, i))
        if remat != "none":
            x, _, aux = _checkpointed(remat, _apply_dense_block, bp, x, cfg,
                                      **kw)
        else:
            x, kv_cache, aux = _apply_dense_block(
                bp, x, cfg, cache=kv_cache, cache_index=cache_index,
                layer_index=None if kv_cache is None else i, **kw)
        for k, v in aux.items():
            if decode:
                v = div(v, n).to(v.dtype)
            aux_tot[k] = aux_tot[k] + v if k in aux_tot else v
    if kv_cache is not None and not decode:
        return x, kv_cache, {}
    if not decode:
        aux_tot = {k: div(v, n).to(v.dtype) for k, v in aux_tot.items()}
    return x, kv_cache, aux_tot


def _mamba_layer(params: Union[Mamba2LM, HybridLM], i: int, x, *,
                 ssm_cache=None, remat: str = "none", use_kernel=False):
    """Mamba2 block ``i`` of the ssm or hybrid stack.  With a cache
    (prefill and decode alike) its slice of the stacked SSM state and conv
    carry is written in place; without one the block is recomputed in the
    backward as ``remat`` says."""
    bp = params.blocks[i]
    if ssm_cache is not None:
        x, out = bp(x, cache={k: v[i] for k, v in ssm_cache.items()},
                    use_kernel=use_kernel)
        for k, v in out.items():
            ssm_cache[k][i].copy_(v)
        return x
    if remat != "none":
        return _checkpointed(remat, bp, x, use_kernel=use_kernel)[0]
    return bp(x, use_kernel=use_kernel)[0]


def _ssm_stack(params: Mamba2LM, x, cfg: ModelConfig, *, ssm_cache=None,
               use_kernel=False):
    """The Mamba2 block stack.  Returns (x, the cache written in place)."""
    remat = _remat(cfg) if ssm_cache is None else "none"
    for i in range(len(params.blocks)):
        x = _mamba_layer(params, i, x, ssm_cache=ssm_cache, remat=remat,
                         use_kernel=use_kernel)
    return x, ssm_cache


def _hybrid_stack(params: HybridLM, x, cfg: ModelConfig, *, positions,
                  ssm_cache=None, kv_cache=None, cache_index=None,
                  use_kernel=False):
    """Zamba2: for each of the ``n_layers // shared_attn_every`` groups,
    its Mamba2 blocks, then the shared block (the same weights each use,
    the same ``positions``, the g-th slice of the stacked KV cache); after
    the last group the remainder layers.  With a cache (prefill and decode
    alike) each layer's SSM state and conv carry and each use's K/V are
    written in place.  Under autograd ``cfg.remat`` recomputes the Mamba2
    blocks only; the shared block runs plainly, as the JAX package's
    ``_hybrid_stack`` runs it outside ``_maybe_remat``.

    Returns (x, ssm cache, kv cache)."""
    every = cfg.shared_attn_every
    remat = _remat(cfg) if ssm_cache is None else "none"

    def mamba(i: int, x):
        return _mamba_layer(params, i, x, ssm_cache=ssm_cache, remat=remat,
                            use_kernel=use_kernel)

    for g in range(cfg.n_layers // every):
        for i in range(g * every, (g + 1) * every):
            x = mamba(i, x)
        x, kv_cache, _ = _apply_dense_block(
            params.shared, x, cfg, positions=positions, layer_is_local=False,
            cache=kv_cache, cache_index=cache_index,
            layer_index=None if kv_cache is None else g)
    for i in range(cfg.n_layers // every * every, cfg.n_layers):
        x = mamba(i, x)
    return x, ssm_cache, kv_cache


def _encoder(params: EncDecLM, frames, cfg: ModelConfig, *,
             remat: str = "none"):
    """Whisper's encoder over the stub frame embeddings (B, enc_seq,
    d_model): dense blocks with unmasked self-attention (whisper has no
    RoPE, so the positions enter nothing), each recomputed in the backward
    as ``remat`` says, then ``enc_norm``."""
    enc_cfg = _encoder_cfg(cfg)
    x = frames.to(L._dtype(cfg.compute_dtype))
    kw = dict(positions=torch.arange(x.shape[1], device=x.device)[None, :],
              layer_is_local=False, causal=False)
    for bp in params.enc_blocks:
        if remat != "none":
            x = _checkpointed(remat, _apply_dense_block, bp, x, enc_cfg,
                              **kw)[0]
        else:
            x = _apply_dense_block(bp, x, enc_cfg, **kw)[0]
    return L.apply_norm(params.enc_norm, x, cfg)


def _cross_kv(p: L.Params, enc_out, cfg: ModelConfig):
    """The encoder output projected to one layer's cross-attention K and V,
    (B, G, enc_seq, hd) in the compute dtype (once a request: a prefill
    caches them)."""
    a = cfg.attention
    cdt = L._dtype(cfg.compute_dtype)
    B, T, d = enc_out.shape
    e = enc_out.to(cdt)

    def proj(w):
        return (e @ w.to(cdt).reshape(d, a.n_kv_heads * a.head_dim)).reshape(
            B, T, a.n_kv_heads, a.head_dim).transpose(1, 2)

    return proj(p["wk"]), proj(p["wv"])


def _cross_attention(p: L.Params, x, k, v, cfg: ModelConfig, *,
                     flash: bool = False):
    """Unmasked GQA attention of the decoder's (B, S, D) ``x`` over the
    encoder's K and V (B, G, enc_seq, hd), read in the compute dtype.  The
    plain form is the JAX package's step for step: scores multiplied in
    the compute dtype, cast to float32 and divided by sqrt(hd), softmax,
    probabilities cast back before the product with v.  ``flash``: the
    scores and the softmax run through ``kernels.ops.flash_attention``
    with ``causal=False`` (float32 scores and probabilities in the
    kernel)."""
    from repro_torch.kernels import ops

    a = cfg.attention
    cdt = L._dtype(cfg.compute_dtype)
    B, S, d = x.shape
    G, hd = a.n_kv_heads, a.head_dim
    rep = a.n_heads // G
    q = _cross_q(p, x, cfg)
    k, v = k.to(cdt), v.to(cdt)
    T = k.shape[2]
    if flash:
        ctx = ops.flash_attention(
            q.reshape(B * G, rep, S, hd), k.reshape(B * G, T, hd),
            v.reshape(B * G, T, hd), scale=1.0 / math.sqrt(hd), causal=False)
    else:
        s = torch.einsum("bgrsk,bgtk->bgrst", q.reshape(B, G, rep, S, hd),
                         k).float()
        probs = torch.softmax(div(s, math.sqrt(hd)), dim=-1).to(cdt)
        ctx = torch.einsum("bgrst,bgtk->bgrsk", probs, v)
    return _cross_out(p, ctx, cfg, B, x.dtype)


def _cross_q(p: L.Params, x, cfg: ModelConfig):
    """The cross-attention's q (B, H, S, hd) of the decoder's (B, S, D)
    ``x``, in the compute dtype (no RoPE)."""
    a = cfg.attention
    cdt = L._dtype(cfg.compute_dtype)
    B, S, d = x.shape
    return (x.to(cdt) @ p["wq"].to(cdt).reshape(
        d, a.n_heads * a.head_dim)).reshape(B, S, a.n_heads,
                                            a.head_dim).transpose(1, 2)


def _cross_out(p: L.Params, ctx, cfg: ModelConfig, B: int, dtype):
    """The heads' cross context (any shape holding (B, H, S, hd)) through
    ``wo``, in ``dtype``."""
    a = cfg.attention
    ctx = ctx.reshape(B, a.n_heads, ctx.shape[-2], a.head_dim)
    out = torch.einsum("bhsk,hkd->bsd", ctx,
                       p["wo"].to(L._dtype(cfg.compute_dtype)))
    return out.to(dtype)


def _decoder_layer(bp: DenseBlock, cp: CrossBlock, x, cfg: ModelConfig, *,
                   positions, enc_out=None, cross=None, flash=False,
                   kv_cache=None, cache_index=None, layer_index=None):
    """One decoder layer: causal self-attention, cross-attention over the
    encoder (its K/V projected from ``enc_out``, or the cached ``cross``
    pair), the MLP, each behind its norm, as the JAX layer (no post-block
    norms: :func:`_require_ported` refuses them for encdec).  Returns (x,
    cross K, cross V)."""
    h = L.apply_norm(bp.attn_norm, x, cfg)
    attn_out, _ = L.multi_head_attention(
        bp.attn, h, cfg, positions=positions, cache=kv_cache,
        cache_index=cache_index, layer_index=layer_index)
    x = x + attn_out
    h = L.apply_norm(cp.norm, x, cfg)
    ck, cv = cross if cross is not None else _cross_kv(cp.attn, enc_out, cfg)
    x = x + _cross_attention(cp.attn, h, ck, cv, cfg, flash=flash)
    h = L.apply_norm(bp.mlp_norm, x, cfg)
    return x + L.apply_mlp(bp.mlp, h, cfg), ck, cv


def _decoder_stack(params: EncDecLM, x, cfg: ModelConfig, *, positions,
                   enc_out=None, cache: Optional[Cache] = None,
                   cache_index: int = 0):
    """Whisper's decoder in its three forms.  Training (no cache): each
    layer projects the cross K/V from ``enc_out`` and is recomputed in
    the backward as ``cfg.remat`` says.  Prefill (a cache and
    ``enc_out``): the same, with each layer's self K/V written into the
    stacked cache in place and its cross K/V copied into ``cross_k`` /
    ``cross_v`` (rounded to the cache's dtype; this call's cross-attention
    uses the unrounded projection, as the JAX prefill does).  Decode (a
    cache and no ``enc_out``): the cross-attention reads the cached K/V
    through the cache's dtype.  Outside decode, with the kernel knob on,
    the cross-attention runs through the flash kernel (``causal=False``)
    wherever the self-attention's route takes the dtype and head_dim."""
    decode = enc_out is None
    remat = _remat(cfg) if cache is None else "none"
    flash = not decode and L.flash_route(cfg, q_offset=0, seq=x.shape[1],
                                         layer_is_local=False)
    for i, (bp, cp) in enumerate(zip(params.blocks, params.cross)):
        kw = dict(positions=positions, enc_out=enc_out, flash=flash)
        if remat != "none":
            x = _checkpointed(remat, _decoder_layer, bp, cp, x, cfg, **kw)[0]
            continue
        cross = (cache["cross_k"][i], cache["cross_v"][i]) if decode \
            else None
        x, ck, cv = _decoder_layer(
            bp, cp, x, cfg, cross=cross,
            kv_cache=None if cache is None else cache["kv"],
            cache_index=cache_index,
            layer_index=None if cache is None else i, **kw)
        if cache is not None and not decode:
            cache["cross_k"][i].copy_(ck)
            cache["cross_v"][i].copy_(cv)
    return x


# --------------------------------------------------------------------------- #
# The stacks split over a mesh's model axis
# --------------------------------------------------------------------------- #

def _split_attention(split, d: int, blocks, cfg: ModelConfig, positions,
                     caches, cache_index, layer_index: int, local_flag: bool,
                     xs, causal: bool = True):
    """The attention of data index ``d``'s residuals ``xs`` through
    ``blocks`` (one a model position), by the split's layout
    (``SplitLM.attn_layout``): each shard's heads, all-reduced
    (``"heads"``); every head on every position (``"whole"``); the keys
    in parts over the model positions, combined
    (``"kv_seq"``: ``parallel_attention.context_parallel``); each shard's
    channels of every head, the partial scores and outputs all-reduced
    (``"head_dim"``: ``parallel_attention.head_dim_split``)."""
    lcfg, m = split.local_cfg, split.extent
    layout, origin = split.attn_layout, d == 0
    hs = [L.apply_norm(bp.attn_norm, x, cfg) for bp, x in zip(blocks, xs)]
    if layout in ("kv_seq", "head_dim"):
        js = [j for j, _ in split.group(d)]
        kw = dict(cache_index=cache_index, layer_index=layer_index,
                  local_flag=local_flag, causal=causal, origin=origin)
        kvs = [None if c is None else c["kv"] for c in caches]
        ps = [bp.attn for bp in blocks]
        if layout == "kv_seq":
            return PA.context_parallel(js, m, ps, hs, cfg, positions, kvs,
                                       **kw)
        attn = PA.head_dim_split(js, m, ps, hs, cfg, lcfg, positions, kvs,
                                 **kw)
        return C.all_reduce(attn, extent=m, origin=origin)
    attn = []
    for bp, h, pos, c in zip(blocks, hs, positions, caches):
        a, _ = L.multi_head_attention(
            bp.attn, h, lcfg, positions=pos, layer_is_local=local_flag,
            causal=causal, cache=None if c is None else c["kv"],
            cache_index=cache_index,
            layer_index=None if c is None else layer_index)
        attn.append(a)
    if layout == "heads":
        attn = C.all_reduce(attn, extent=m, origin=origin)
    return attn


def _split_ffn(split, d: int, blocks, cfg: ModelConfig, xs, attn):
    """The rest of a transformer block after its attention ``attn``: the
    residual, each shard's feed-forward part (its MLP columns and rows,
    its experts), the partial outputs all-reduced where the rules split
    them.  Returns (the new residuals, each position's aux)."""
    group = split.group(d)
    m, origin = split.extent, d == 0
    res, partial, whole, auxes = [], [], [], []
    for (j, _), bp, x, a in zip(group, blocks, xs, attn):
        if cfg.post_block_norm:
            a = L.apply_norm(bp.post_attn_norm, a, cfg)
        x = x + a
        res.append(x)
        h = L.apply_norm(bp.mlp_norm, x, cfg)
        if cfg.family != "moe":
            f, aux = L.apply_mlp(bp.mlp, h, cfg), {}
            split_parts, own = ([f], []) if split.on_model("mlp") \
                else ([], [f])
        else:
            f, aux = MOE.apply_moe(bp.moe, h, cfg,
                                   expert_offset=split.expert_offset(j),
                                   with_shared=False)
            split_parts, own = ([f], []) if split.on_model("experts") \
                else ([], [f])
            if cfg.moe.n_shared > 0:
                sh = MOE.apply_shared(bp.moe, h, cfg).to(f.dtype)
                (split_parts if split.on_model("mlp") else own).append(sh)
        partial.append(functools.reduce(torch.add, split_parts)
                       if split_parts else None)
        whole.append(own)
        auxes.append(aux)
    if partial[0] is not None:
        partial = C.all_reduce(partial, extent=m, origin=origin)
    out = []
    for bp, x, f, own in zip(blocks, res, partial, whole):
        parts = ([] if f is None else [f]) + own
        f = functools.reduce(torch.add, parts)
        if cfg.post_block_norm:
            f = L.apply_norm(bp.post_mlp_norm, f, cfg)
        out.append(x + f)
    return tuple(out), auxes


def _split_layer(split, d: int, i: int, cfg: ModelConfig, positions, caches,
                 cache_index, *xs):
    """Block ``i`` at every model position of data index ``d``: each
    shard's attention and feed-forward part, the partial outputs
    all-reduced where the rules split them.  Returns (the new residuals,
    each position's aux)."""
    blocks = [p.blocks[i] for _, p in split.group(d)]
    attn = _split_attention(split, d, blocks, cfg, positions, caches,
                            cache_index, i, _layer_is_local_static(cfg, i),
                            xs)
    return _split_ffn(split, d, blocks, cfg, xs, attn)


def _split_mamba(split, d: int, i: int, cfg: ModelConfig, caches, *xs):
    """Mamba2 block ``i`` at every model position of data index ``d``.
    Mixers split over their heads (``split.ssm_split``): each shard's
    gated output and its sum of squares
    (``models.ssm.apply_mamba2_shard``), the sums all-reduced, each
    shard's row-parallel ``out_proj`` (:func:`models.ssm.mamba2_shard_out`)
    and an all-reduce of the float32 partial outputs, rounded once to the
    residual's dtype.  Otherwise every position
    runs the whole block, with no collective.  With caches each
    position's slice of its SSM state and conv carry is written in place.
    Returns the new residuals."""
    group = split.group(d)
    m, use_kernel = split.extent, cfg.use_flash_kernel
    caches = caches or [None] * len(group)
    own = [None if c is None else {k: v[i] for k, v in c["ssm"].items()}
           for c in caches]

    def keep(c, new):
        if c is not None:
            for k, v in new.items():
                c["ssm"][k][i].copy_(v)

    if not split.ssm_split:
        out = []
        for (_, p), x, c, ci in zip(group, xs, caches, own):
            y, new = _apply_ssm_block(p.blocks[i], x, cfg, cache=ci,
                                      use_kernel=use_kernel)
            keep(c, new)
            out.append(y)
        return tuple(out)
    gated, sums, mixers = [], [], []
    for (j, p), x, c, ci in zip(group, xs, caches, own):
        bp = p.blocks[i]
        mixers.append(bp.mixer.params())
        h = L.apply_norm(bp.norm, x, cfg)
        yg, sq, new = SSM.apply_mamba2_shard(mixers[-1], h, cfg, m, j,
                                             cache=ci, use_kernel=use_kernel)
        keep(c, new)
        gated.append(yg)
        sums.append(sq)
    sums = C.all_reduce(sums, extent=m, origin=d == 0)
    parts = [SSM.mamba2_shard_out(mp, yg, sq, cfg)
             for mp, yg, sq in zip(mixers, gated, sums)]
    parts = C.all_reduce(parts, extent=m, origin=d == 0)
    return tuple(x + o.to(x.dtype) for x, o in zip(xs, parts))


def _split_embed(split, d: int, batch: Mapping[str, torch.Tensor],
                 cfg: ModelConfig, cache_index: int):
    """Data index ``d``'s tokens through the vocabulary-parallel embedding
    (a masked lookup a shard, all-reduced where the rules split the
    vocabulary).  Returns (each position's residual, each position's
    positions)."""
    group = split.group(d)
    m, origin = split.extent, d == 0
    devs = [next(p.parameters()).device for _, p in group]
    tokens = [batch["tokens"].to(dev, torch.long) for dev in devs]
    rows = [L.embed_rows(p.embed, t, split.vocab_offset(j))
            for (j, p), t in zip(group, tokens)]
    if split.on_model("vocab"):
        rows = C.all_reduce(rows, extent=m, origin=origin)
    xs = tuple(L.scale_embedding(r, cfg) for r in rows)
    if cfg.family == "ssm":
        return xs, None
    positions = batch.get("positions")
    if positions is None:
        positions = [torch.arange(t.shape[1], device=t.device)[None, :]
                     + cache_index for t in tokens]
    else:
        positions = [positions.to(dev) for dev in devs]
    rope = cfg.attention.rope
    if rope is not None and rope.mrope_sections is not None:
        positions = [q[:, None, :].expand(q.shape[0], 3, q.shape[1])
                     if q.dim() == 2 else q for q in positions]
    return xs, positions


def _split_logits(split, d: int, xs, cfg: ModelConfig, last_only: bool):
    """Each position's whole logits: the final norm, the shard's columns,
    all-gathered along the vocabulary where the rules split it."""
    group = split.group(d)
    if last_only:
        xs = [x[:, -1:] for x in xs]
    logits = [L.logits_from_hidden(p.embed, L.apply_norm(p.final_norm, x,
                                                         cfg), cfg)
              for (j, p), x in zip(group, xs)]
    if split.on_model("vocab"):
        logits = C.all_gather(logits, -1, extent=split.extent,
                              origin=d == 0)
    return logits


def _split_group(split, d: int, batch: Mapping[str, torch.Tensor],
                 cfg: ModelConfig, *, caches=None, cache_index: int = 0,
                 last_only: bool = False):
    """Data index ``d``'s part of the batch through its model positions
    (each on its own device) of a dense or moe model: the embedding
    (:func:`_split_embed`), the blocks (:func:`_split_layer`, recomputed
    in the backward as ``cfg.remat`` says when there is no cache) and the
    logits (:func:`_split_logits`).  Returns (each position's whole
    logits, each position's aux)."""
    group = split.group(d)
    xs, positions = _split_embed(split, d, batch, cfg, cache_index)
    caches = caches or [None] * len(group)
    remat = _remat(cfg) if caches[0] is None else "none"
    n = cfg.n_layers
    decode = caches[0] is not None and batch["tokens"].shape[1] == 1
    aux_tot = [{} for _ in group]
    for i in range(n):
        args = (split, d, i, cfg, positions, caches, cache_index, *xs)
        if remat != "none":
            xs, auxes = _checkpointed(remat, _split_layer, *args)
        else:
            xs, auxes = _split_layer(*args)
        for tot, aux in zip(aux_tot, auxes):
            for k, v in aux.items():
                if decode:
                    v = div(v, n).to(v.dtype)
                tot[k] = tot[k] + v if k in tot else v
    if caches[0] is not None and not decode:
        aux_tot = [{} for _ in group]
    elif not decode:
        aux_tot = [{k: div(v, n).to(v.dtype) for k, v in tot.items()}
                   for tot in aux_tot]
    return _split_logits(split, d, xs, cfg, last_only), aux_tot


def _split_stack(split, d: int, batch: Mapping[str, torch.Tensor],
                 cfg: ModelConfig, **kw):
    """:func:`_split_group` (dense, moe) or :func:`_split_encdec` on data
    index ``d``'s part of the batch: (each position's logits, each
    position's aux)."""
    if cfg.family == "encdec":
        return _split_encdec(split, d, batch, cfg, **kw)
    return _split_group(split, d, batch, cfg, **kw)


# -- the encdec family ------------------------------------------------------

def _split_enc_layer(split, d: int, i: int, cfg: ModelConfig, positions,
                     *xs):
    """Encoder block ``i`` at every model position of data index ``d``:
    the unmasked self-attention by the split's layout, then the MLP."""
    blocks = [p.enc_blocks[i] for _, p in split.group(d)]
    attn = _split_attention(split, d, blocks, cfg, positions,
                            [None] * len(blocks), 0, None, False, xs,
                            causal=False)
    return _split_ffn(split, d, blocks, cfg, xs, attn)[0]


def _split_encoder(split, d: int, frames, cfg: ModelConfig, remat: str):
    """Whisper's encoder at every model position of data index ``d``: the
    frames whole on each, each block by the split's layout (recomputed in
    the backward as ``remat`` says), then ``enc_norm``.  Returns each
    position's encoder output."""
    group = split.group(d)
    cdt = L._dtype(cfg.compute_dtype)
    xs = tuple(frames.to(next(p.parameters()).device).to(cdt)
               for _, p in group)
    positions = [torch.arange(x.shape[1], device=x.device)[None, :]
                 for x in xs]
    enc_cfg = _encoder_cfg(cfg)
    for i in range(cfg.n_enc_layers):
        args = (split, d, i, enc_cfg, positions, *xs)
        xs = (_checkpointed(remat, _split_enc_layer, *args)
              if remat != "none" else _split_enc_layer(*args))
    return [L.apply_norm(p.enc_norm, x, cfg) for (_, p), x in zip(group, xs)]


def _split_cross(split, d: int, cps, cfg: ModelConfig, xs, enc, caches,
                 i: int):
    """Decoder layer ``i``'s cross-attention at every model position of
    data index ``d`` (``cps`` its :class:`CrossBlock` pieces): K and V
    projected from each position's encoder output ``enc`` (and copied
    into the cache's ``cross_k`` / ``cross_v``), or read from the cache
    in decode.  By the split's layout: each shard's heads (``wq``, ``wk``,
    ``wv`` column-parallel, ``wo`` row-parallel, all-reduced); each
    shard's channels of every head (``head_dim``: the partial scores and
    outputs all-reduced, ``parallel_attention.head_dim_core``); or every
    head on every position (``kv_seq`` and ``whole``: the cross K/V's
    spec leaves their sequence unsplit)."""
    lcfg, m, layout, origin = (split.local_cfg, split.extent,
                               split.attn_layout, d == 0)
    hs = [L.apply_norm(cp.norm, x, cfg) for cp, x in zip(cps, xs)]
    kvs = []
    for cp, e, c in zip(cps, enc or [None] * len(cps), caches):
        if e is None:
            kvs.append((c["cross_k"][i], c["cross_v"][i]))
            continue
        ck, cv = _cross_kv(cp.attn, e, lcfg)
        if c is not None:
            c["cross_k"][i].copy_(ck)
            c["cross_v"][i].copy_(cv)
        kvs.append((ck, cv))
    if layout == "head_dim":
        a, cdt = lcfg.attention, L._dtype(cfg.compute_dtype)
        B, S = xs[0].shape[:2]
        G, hd = a.n_kv_heads, a.head_dim
        qs = [_cross_q(cp.attn, h, lcfg).reshape(B, G, a.n_heads // G, S, hd)
              for cp, h in zip(cps, hs)]
        ctx = PA.head_dim_core(
            qs, [k.to(cdt) for k, _ in kvs], [v for _, v in kvs], extent=m,
            origin=origin, scale=1.0 / math.sqrt(cfg.attention.head_dim),
            softcap=None, causal=False, window=None, q_offset=0,
            kv_valid=None, cdt=cdt)
        out = [_cross_out(cp.attn, c, lcfg, B, h.dtype)
               for cp, c, h in zip(cps, ctx, hs)]
        return C.all_reduce(out, extent=m, origin=origin)
    flash = enc is not None and L.flash_route(
        lcfg, q_offset=0, seq=xs[0].shape[1], layer_is_local=False)
    out = [_cross_attention(cp.attn, h, k, v, lcfg, flash=flash)
           for cp, h, (k, v) in zip(cps, hs, kvs)]
    if layout == "heads":
        out = C.all_reduce(out, extent=m, origin=origin)
    return out


def _split_decoder_layer(split, d: int, i: int, cfg: ModelConfig, positions,
                         caches, cache_index, enc, *xs):
    """Decoder layer ``i`` at every model position of data index ``d``:
    the causal self-attention by the split's layout over each position's
    K/V cache, the cross-attention (:func:`_split_cross`) and the MLP."""
    group = split.group(d)
    blocks = [p.blocks[i] for _, p in group]
    attn = _split_attention(split, d, blocks, cfg, positions, caches,
                            cache_index, i, False, xs)
    xs = tuple(x + a for x, a in zip(xs, attn))
    cross = _split_cross(split, d, [p.cross[i] for _, p in group], cfg, xs,
                         enc, caches, i)
    return _split_ffn(split, d, blocks, cfg, xs, cross)[0]


def _split_encdec(split, d: int, batch: Mapping[str, torch.Tensor],
                  cfg: ModelConfig, *, caches=None, cache_index: int = 0,
                  last_only: bool = False):
    """Data index ``d``'s part of the batch through its model positions of
    an encdec model, as :func:`_split_group` runs a dense one: the
    embedding, the encoder over ``batch['frames']`` where they are given
    (a prefill or a forward; a decode step reads the cached cross K/V),
    the decoder layers (recomputed in the backward as ``cfg.remat`` says
    when there is no cache) and the logits.  Returns (each position's
    whole logits, each position's empty aux)."""
    group = split.group(d)
    xs, positions = _split_embed(split, d, batch, cfg, cache_index)
    caches = caches or [None] * len(group)
    frames = batch.get("frames")
    if frames is None and caches[0] is None:
        raise ValueError("an encdec forward without a cache needs "
                         "batch['frames'] (B, enc_seq, d_model)")
    remat = _remat(cfg) if caches[0] is None else "none"
    enc = None if frames is None else _split_encoder(split, d, frames, cfg,
                                                     remat)
    for i in range(cfg.n_layers):
        args = (split, d, i, cfg, positions, caches, cache_index, enc, *xs)
        xs = (_checkpointed(remat, _split_decoder_layer, *args)
              if remat != "none" else _split_decoder_layer(*args))
    return _split_logits(split, d, xs, cfg, last_only), [{} for _ in group]

# -- the KV sequence over the data positions (the hybrid family) ------------

def _seq_split_attention(split, ds, g: int, cfg: ModelConfig, positions,
                         caches, cache_index: int, parts: int, xs):
    """The shared block's attention (use ``g``) where the K/V lie along the
    sequence over the data axis, for the data indices ``ds`` in lockstep
    (every data index runs the whole batch).  Each position writes its
    sequence part's slots (``parallel_attention.seq_part_write``).  A
    prefill (from position 0) attends over the prompt's own K/V, read back
    through the cache's dtype, as the unsplit prefill does; a decode step
    combines the parts (``parallel_attention.part_attention`` a part, and
    ``parallel_attention.combine`` over the data positions).  Then ``wo``
    and the all-reduce over the heads as :func:`_split_attention`.
    Returns {d: each position's attention output}."""
    from repro_torch.kernels import ops

    lcfg, m = split.local_cfg, split.extent
    a = lcfg.attention
    cdt = L._dtype(cfg.compute_dtype)
    if lcfg.kv_cache_quant or a.sliding_window is not None or \
            split.attn_layout not in ("heads", "whole"):
        raise ValueError("a K/V sequence over the data positions takes a "
                         "plain cache, no sliding window, and heads whole "
                         "or split over the model axis")
    scale = L.query_scale(lcfg)
    state, ctx = {}, {}
    for d in ds:
        e = d % parts
        for (j, p), x, pos, c in zip(split.group(d), xs[d], positions[d],
                                     caches[d]):
            bp = p.shared
            h = L.apply_norm(bp.attn_norm, x, cfg)
            q, k, v = L.attention_qkv(bp.attn, h, lcfg, pos)
            ck, cv = c["kv"]["k"][g], c["kv"]["v"][g]
            PA.seq_part_write(ck, k, e, cache_index)
            PA.seq_part_write(cv, v, e, cache_index)
            B, S = x.shape[:2]
            if S > 1:
                if cache_index:
                    raise ValueError("a step of several tokens over a K/V "
                                     "sequence split over the data positions "
                                     "must start at position 0")
                ko, vo = k.to(ck.dtype).to(cdt), v.to(cv.dtype).to(cdt)
                G, hd = a.n_kv_heads, a.head_dim
                rep = a.n_heads // G
                if L.flash_route(lcfg, q_offset=0, seq=S,
                                 layer_is_local=False):
                    out = ops.flash_attention(
                        q.reshape(B * G, rep, S, hd), ko.reshape(B * G, S, hd),
                        vo.reshape(B * G, S, hd), scale=scale, causal=True,
                        softcap=a.softcap)
                else:
                    out = L._attention_core(
                        q.reshape(B, G, rep, S, hd), ko, vo, scale=scale,
                        softcap=a.softcap, causal=True, sliding_window=None,
                        local_flag=False, q_offset=0, kv_valid=None,
                        q_chunk=512, cdt=cdt)
                ctx[(d, j)] = out
            else:
                G, T = a.n_kv_heads, ck.shape[2]
                state[(d, j)] = PA.part_attention(
                    q.reshape(B, G, a.n_heads // G, 1, a.head_dim),
                    ck.to(cdt), cv.to(cdt), scale=scale, softcap=a.softcap,
                    causal=True, window=None,
                    q_pos=torch.full((1,), cache_index, device=q.device),
                    k_pos=torch.arange(T, device=q.device) + e * T,
                    kv_valid=None, cdt=cdt)
    if state:
        # each pod's data positions combine, one model index at a time
        n_pod = split.data_extent // parts
        for pod in range(n_pod):
            members = [d for d in ds if d // parts == pod]
            for j in sorted({j for d in members for j, _ in split.group(d)}):
                tot = PA.combine([state[(d, j)] for d in members],
                                 extent=parts, origin=pod == 0 and j == 0)
                for d, t in zip(members, tot):
                    ctx[(d, j)] = t.to(cdt)
    out = {}
    for d in ds:
        attn = []
        for (j, p), x in zip(split.group(d), xs[d]):
            B, S = x.shape[:2]
            attn.append(L.attention_out(p.shared.attn, ctx[(d, j)], lcfg, B,
                                        S, x.dtype))
        if split.on_model("heads"):
            attn = C.all_reduce(attn, extent=m, origin=d == 0)
        out[d] = attn
    return out


def _split_recurrent(split, ds, batches, cfg: ModelConfig, *, caches=None,
                     cache_index: int = 0, last_only: bool = False,
                     seq_parts: int = 1):
    """The ssm and hybrid stacks of a split model, the data indices ``ds``
    in lockstep (``batches[d]`` each one's part; ``caches[d]`` its
    positions' caches): the embedding, the Mamba2 blocks
    (:func:`_split_mamba`, recomputed in the backward as ``cfg.remat``
    says when there is no cache), for the hybrid family the shared block
    after every ``shared_attn_every`` of them (the Megatron split of
    :func:`_split_attention` and :func:`_split_ffn` over ``params.shared``
    and the g-th slice of each position's KV cache, or
    :func:`_seq_split_attention` where the K/V lie along the sequence;
    run plainly, as the JAX package runs it outside its remat), the
    remainder layers, and the logits.  Returns {d: each position's whole
    logits}."""
    xs, positions = {}, {}
    for d in ds:
        xs[d], positions[d] = _split_embed(split, d, batches[d], cfg,
                                           cache_index)
    cs = {d: (caches[d] if caches is not None
              else [None] * len(split.group(d))) for d in ds}
    remat = _remat(cfg) if caches is None else "none"

    def mamba(i: int):
        for d in ds:
            args = (split, d, i, cfg, None if caches is None else cs[d],
                    *xs[d])
            xs[d] = (_checkpointed(remat, _split_mamba, *args)
                     if remat != "none" else _split_mamba(*args))

    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            mamba(i)
    else:
        every = cfg.shared_attn_every
        for g in range(cfg.n_layers // every):
            for i in range(g * every, (g + 1) * every):
                mamba(i)
            if seq_parts > 1:
                attn = _seq_split_attention(split, ds, g, cfg, positions,
                                            cs, cache_index, seq_parts, xs)
            else:
                attn = {d: _split_attention(
                    split, d, [p.shared for _, p in split.group(d)], cfg,
                    positions[d], cs[d], cache_index, g, False, xs[d])
                    for d in ds}
            for d in ds:
                xs[d] = _split_ffn(split, d, [p.shared for _, p in
                                              split.group(d)], cfg, xs[d],
                                   attn[d])[0]
        for i in range(cfg.n_layers // every * every, cfg.n_layers):
            mamba(i)
    return {d: _split_logits(split, d, xs[d], cfg, last_only) for d in ds}


def _data_part(split, batch: Mapping[str, torch.Tensor], d: int
               ) -> Dict[str, torch.Tensor]:
    """Data index ``d``'s contiguous part of the global batch, or all of
    it where the batch does not split over the data positions (each runs
    the whole batch, as the rules replicate it)."""
    b = batch["tokens"].shape[0]
    if not split.batch_split(b):
        return dict(batch)
    per = b // split.data_extent
    return {k: v[d * per:(d + 1) * per] for k, v in batch.items()}


def _split_forward(split, batch: Mapping[str, torch.Tensor],
                   cfg: ModelConfig, *, cache: Optional[Cache] = None,
                   last_only: bool = False):
    """:func:`forward` of a split model: each data index's group on its
    part of the batch, inside the split's sharding context.  The logits
    are model position 0's, concatenated over the data indices on the
    first position's device (data index 0's where every data index ran
    the whole batch); aux is the data indices' mean."""
    index = 0 if cache is None else int(cache["index"])
    ds = split.data_indices()
    outs, auxes = [], []

    def caches_of(d):
        return None if cache is None else [
            cache["pieces"][(d, j)] for j, _ in split.group(d)]

    with sharding_context(split.mesh, split.rules):
        if cfg.family in ATTENTION_FAMILIES + ("encdec",):
            for d in ds:
                logits, aux = _split_stack(
                    split, d, _data_part(split, batch, d), cfg,
                    caches=caches_of(d), cache_index=index,
                    last_only=last_only)
                outs.append(logits[0])
                auxes.append(aux[0])
        else:
            got = _split_recurrent(
                split, ds, {d: _data_part(split, batch, d) for d in ds}, cfg,
                caches=None if cache is None else {d: caches_of(d)
                                                   for d in ds},
                cache_index=index, last_only=last_only,
                seq_parts=1 if cache is None else cache["seq_parts"])
            outs = [got[d][0] for d in ds]
            auxes = [{} for _ in ds]
    # assembling the global result is the controller's, no device's work
    with CA.paused():
        dev = outs[0].device
        if not split.batch_split(batch["tokens"].shape[0]):
            outs = outs[:1]
        logits = torch.cat([o.to(dev) for o in outs]) if len(outs) > 1 \
            else outs[0]
        aux = {k: sum(a[k].to(dev) for a in auxes) / len(auxes)
               for k in auxes[0]}
    new_cache = None if cache is None else dict(
        cache, index=index + batch["tokens"].shape[1])
    return logits, new_cache, aux


def _split_loss_terms(split, batch: Mapping[str, torch.Tensor],
                      cfg: ModelConfig, d: int):
    """Data index ``d``'s group on ``batch`` (its microbatch): every model
    position computes the loss on its own copy of the gathered logits, as
    each device of a partitioned program does, scaled by ``1/m`` (each
    position's gradient ``1/m`` of the whole, summed by the collectives'
    backward) -- unscaled where the model positions are replicas, each
    then holding the whole gradient of its own copy.  Returns (the
    losses, one a position, to run the backward from; position 0's
    metrics)."""
    with sharding_context(split.mesh, split.rules):
        if cfg.family in ATTENTION_FAMILIES + ("encdec",):
            logits, auxes = _split_stack(split, d, batch, cfg)
        else:
            logits = _split_recurrent(split, [d], {d: batch}, cfg)[d]
            auxes = [{} for _ in logits]
        terms = [_loss(lg, batch["labels"].to(lg.device, torch.long), aux)
                 for lg, aux in zip(logits, auxes)]
    if split.replicas:
        return [t for t, _ in terms], terms[0][1]
    return [t * (1.0 / split.extent) for t, _ in terms], terms[0][1]


def _split_loss(split, batch: Mapping[str, torch.Tensor], cfg: ModelConfig,
                d: Optional[int] = None):
    """:func:`loss_fn` of a split model on data index ``d``'s group (the
    only one present, by default): the sum of
    :func:`_split_loss_terms`' scaled losses (one position's, where the
    model positions are replicas), and position 0's metrics."""
    if d is None:
        (d,) = split.data_indices()
    scaled, metrics = _split_loss_terms(split, batch, cfg, d)
    with CA.paused():           # the controller's sum of the positions'
        dev = scaled[0].device
        if split.replicas:      # each replica's gradient, one loss's value
            return scaled[0] + sum((t - t.detach()).to(dev)
                                   for t in scaled[1:]), metrics
        total = sum(t.to(dev) for t in scaled)
    return total, metrics


# --------------------------------------------------------------------------- #
# Public API
# --------------------------------------------------------------------------- #

def forward(params: LM, batch: Mapping[str, torch.Tensor],
            cfg: ModelConfig, *, cache: Optional[Cache] = None,
            last_only: bool = False
            ) -> Tuple[torch.Tensor, Optional[Cache], Dict]:
    """Compute (logits (float32), the new cache, aux).  aux holds the moe
    blocks' ``moe_aux_loss`` and ``moe_dropped_frac`` averaged over the
    layers, without a cache and in a decode step (empty for a prefill and
    for the other families).

    batch: {'tokens': (B, S) integer; dense, moe, hybrid, encdec: optional
    'positions', (B, S) or, for M-RoPE, (B, 3, S); encdec: 'frames' (B,
    enc_seq, d_model), the stub frontend's frame embeddings}.  Without
    positions they count from the cache's index (0 without a cache); an
    M-RoPE model given (B, S) positions runs three equal streams (text).
    With ``cache`` the call is a serving step writing at
    ``cache['index']``; for encdec a step with 'frames' is the prefill (the
    encoder runs and its cross K/V are cached) and one without is a decode
    step over the cached cross K/V, whatever its length; without a cache
    'frames' are required.  ``last_only`` computes logits for the final
    position only (prefill -- avoids a (B, S, V) tensor).
    """
    _require_ported(cfg)
    if _is_split(params):
        return _split_forward(params, batch, cfg, cache=cache,
                              last_only=last_only)
    tokens = batch["tokens"]
    x = L.embed_tokens(params.embed, tokens, cfg)
    new_cache, aux = None, {}
    cache_index = int(cache["index"]) if cache is not None else 0
    if cfg.family != "ssm":
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device
                                     )[None, :] + cache_index
        rope = cfg.attention.rope
        if rope is not None and rope.mrope_sections is not None \
                and positions.dim() == 2:
            positions = positions[:, None, :].expand(
                positions.shape[0], 3, positions.shape[1])
    if cfg.family in ATTENTION_FAMILIES:
        kv = cache["kv"] if cache is not None else None
        x, new_kv, aux = _dense_stack(params, x, cfg, positions=positions,
                                      kv_cache=kv, cache_index=cache_index)
        if cache is not None:
            new_cache = {"kv": new_kv,
                         "index": cache_index + tokens.shape[1]}
    elif cfg.family == "hybrid":
        x, new_ssm, new_kv = _hybrid_stack(
            params, x, cfg, positions=positions,
            ssm_cache=cache["ssm"] if cache is not None else None,
            kv_cache=cache["kv"] if cache is not None else None,
            cache_index=cache_index, use_kernel=cfg.use_flash_kernel)
        if cache is not None:
            new_cache = {"ssm": new_ssm, "kv": new_kv,
                         "index": cache_index + tokens.shape[1]}
    elif cfg.family == "encdec":
        frames = batch.get("frames")
        if frames is None and cache is None:
            raise ValueError("an encdec forward without a cache needs "
                             "batch['frames'] (B, enc_seq, d_model)")
        enc_out = None if frames is None else _encoder(
            params, frames, cfg, remat=_remat(cfg) if cache is None
            else "none")
        x = _decoder_stack(params, x, cfg, positions=positions,
                           enc_out=enc_out, cache=cache,
                           cache_index=cache_index)
        if cache is not None:
            new_cache = dict(cache, index=cache_index + tokens.shape[1])
    else:
        ssm_c = cache["ssm"] if cache is not None else None
        x, new_ssm = _ssm_stack(params, x, cfg, ssm_cache=ssm_c,
                                use_kernel=cfg.use_flash_kernel)
        if cache is not None:
            new_cache = {"ssm": new_ssm,
                         "index": cache["index"] + tokens.shape[1]}
    if last_only:
        x = x[:, -1:]
    x = L.apply_norm(params.final_norm, x, cfg)
    logits = L.logits_from_hidden(params.embed, x, cfg)
    return logits, new_cache, aux


def loss_fn(params: LM, batch: Mapping[str, torch.Tensor],
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy, plus the moe aux loss.  batch['labels']
    (B, S); entries < 0 are ignored.  Returns (loss, {'loss', 'ce'} and,
    moe, {'moe_aux_loss', 'moe_dropped_frac'})."""
    if _is_split(params):
        return _split_loss(params, batch, cfg)
    logits, _, aux = forward(params, batch, cfg)
    return _loss(logits, batch["labels"], aux)


def _loss(logits: torch.Tensor, labels: torch.Tensor, aux: Dict
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    valid = labels >= 0
    labels_safe = labels.clamp(min=0).long()
    # logsumexp form: no second (B, S, V) log-softmax buffer
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = lse - gold
    denom = valid.sum().clamp(min=1)
    ce = torch.where(valid, nll, 0.0).sum() / denom
    total = ce + aux["moe_aux_loss"] if "moe_aux_loss" in aux else ce
    return total, {"loss": total, "ce": ce, **aux}


def _batch(tokens: torch.Tensor, positions: Optional[torch.Tensor],
           frames: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    batch = {"tokens": tokens}
    if positions is not None:
        batch["positions"] = positions
    if frames is not None:
        batch["frames"] = frames
    return batch


def prefill(params: LM, tokens: torch.Tensor, cfg: ModelConfig,
            max_seq: int, *, frames: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt (encdec: and the ``frames`` through the encoder)
    through the model, returning (last_logits, cache)."""
    if cfg.family == "encdec" and frames is None:
        raise ValueError("an encdec prefill needs frames (B, enc_seq, "
                         "d_model)")
    cache = serving_cache(params, cfg, tokens.shape[0], max_seq, cache_dtype,
                          device=tokens.device)
    logits, cache, _ = forward(params, _batch(tokens, positions, frames),
                               cfg, cache=cache, last_only=True)
    return logits, cache


def serving_cache(params, cfg: ModelConfig, batch: int, max_seq: int,
                  dtype=torch.bfloat16, device=None) -> Cache:
    """:func:`init_cache` for ``params``: a split model's holds each
    position's part (``SplitLM.init_cache``)."""
    if _is_split(params):
        return params.init_cache(batch, max_seq, dtype)
    return init_cache(cfg, batch, max_seq, dtype, device=device)


def decode_step(params: LM, cache: Cache, tokens: torch.Tensor,
                cfg: ModelConfig, *,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One serving step: tokens (B, 1) -> (logits (B,1,V), new cache)."""
    logits, new_cache, _ = forward(params, _batch(tokens, positions), cfg,
                                   cache=cache)
    return logits, new_cache


# --------------------------------------------------------------------------- #
# Weights from the JAX package
# --------------------------------------------------------------------------- #

def _tensor(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch without a copy; bfloat16 arrays (ml_dtypes) go
    through their 16-bit pattern."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # read-only arrays
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)


def reference_state(params_np: Mapping[str, Any],
                    cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The JAX ``init_params`` pytree flattened to the port's parameter
    names (layer-stacked leaves split per layer: ``blocks`` and, encdec,
    ``enc_blocks`` and ``cross``; the hybrid's ``shared`` leaves, one
    block, under ``shared.<part>.<leaf>``; a non-parametric norm's empty
    dict gives no name)."""
    _require_ported(cfg)
    flat, stacks = ("embed", "final_norm"), {"blocks": cfg.n_layers}
    if cfg.family == "encdec":
        flat += ("enc_norm",)
        stacks.update(enc_blocks=cfg.n_enc_layers, cross=cfg.n_layers)
    out = {f"{part}.{k}": v for part in flat
           for k, v in params_np[part].items()}
    if cfg.family == "hybrid":
        out.update({f"shared.{part}.{k}": v
                    for part, leaves in params_np["shared"].items()
                    for k, v in leaves.items()})
    for name, n in stacks.items():
        for part, leaves in params_np[name].items():
            for k, v in leaves.items():
                for i in range(n):
                    out[f"{name}.{i}.{part}.{k}"] = v[i]
    return out


def from_reference(params_np: Mapping[str, Any], cfg: ModelConfig,
                   device=None) -> LM:
    """The port's model holding the JAX package's parameters (the
    ``init_params`` pytree as numpy arrays), dtype for dtype, on
    ``device`` (default CUDA; ``"meta"`` checks shapes and dtypes only)."""
    dev = resolve_device(device)
    model = model_class(cfg)(cfg)               # on the meta device
    want = dict(model.named_parameters())
    got = reference_state(params_np, cfg)
    if set(got) != set(want):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(want) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(want))}")
    sd = {}
    for k, a in got.items():
        t = _tensor(np.asarray(a))
        if tuple(t.shape) != tuple(want[k].shape) or t.dtype != want[k].dtype:
            raise ValueError(f"{k}: reference {tuple(t.shape)} {t.dtype}, "
                             f"port {tuple(want[k].shape)} {want[k].dtype}")
        sd[k] = t.to(device=dev, copy=True).contiguous()
    model.load_state_dict(sd, strict=True, assign=True)
    return model
