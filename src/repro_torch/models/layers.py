"""Layer library of the port: the parts of ``repro/models/layers.py`` that
the ssm family uses (rmsnorm, tied embedding and unembedding, bfloat16
and float32).

Conventions, as in the JAX package: parameters are mappings of name to
tensor (``nn.ParameterDict`` inside the modules), ``init_*`` functions
build them and the ``apply`` logic is plain functions; compute runs in
``cfg.compute_dtype`` and norm statistics in float32.  Initialisation
draws from an explicit CPU ``torch.Generator``, so a seed gives the same
weights on every device.  Attention, RoPE and the MLPs wait for a later
slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

from repro_torch.configs.base import ModelConfig

Params = Mapping[str, torch.Tensor]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise NotImplementedError(
            f"dtype {name!r} is not ported yet (ROADMAP Queue 1)")
    return _DTYPES[name]


def check_ported(cfg: ModelConfig) -> None:
    """The ssm family's layer options are the only ones ported; the other
    norms, an untied unembedding and the logit softcap wait for the slices
    that need them (ROADMAP Queue 1)."""
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"norm {cfg.norm!r} is not ported yet (ROADMAP Queue 1)")
    if not cfg.tie_embeddings:
        raise NotImplementedError(
            "untied embeddings are not ported yet (ROADMAP Queue 1)")
    if cfg.logit_softcap is not None:
        raise NotImplementedError(
            "logit softcap is not ported yet (ROADMAP Queue 1)")


def truncated_normal_init(gen: torch.Generator, shape, scale: float,
                          dtype: torch.dtype) -> torch.Tensor:
    """Normal draws truncated to [-2, 2], times ``scale``, cast to ``dtype``
    (inverse CDF of uniforms from ``gen``, in float32 on the CPU)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = lo + (1.0 - 2.0 * lo) * torch.rand(shape, generator=gen,
                                           dtype=torch.float32)
    x = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp_(-2.0, 2.0)
    return (x * scale).to(dtype)


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #

def init_norm(gen: torch.Generator, cfg: ModelConfig,
              dim: int) -> Dict[str, torch.Tensor]:
    check_ported(cfg)
    return {"scale": torch.ones(dim, dtype=_dtype(cfg.param_dtype))}


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"].float()
    return y.to(x.dtype)


# --------------------------------------------------------------------------- #
# Embedding / unembedding
# --------------------------------------------------------------------------- #

def init_embedding(gen: torch.Generator,
                   cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    check_ported(cfg)
    return {"tok": truncated_normal_init(gen, (cfg.vocab, cfg.d_model), 0.02,
                                         _dtype(cfg.param_dtype))}


def embed_tokens(p: Params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    x = p["tok"][tokens].to(_dtype(cfg.compute_dtype))
    # gemma-style embedding scaling for tied embeddings under an rmsnorm, in
    # the compute dtype (sqrt(d_model) rounded to it first, as the JAX
    # package does)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                            device=x.device)


def logits_from_hidden(p: Params, x: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    cdt = _dtype(cfg.compute_dtype)
    return torch.einsum("bsd,vd->bsv", x.to(cdt), p["tok"].to(cdt)).float()
