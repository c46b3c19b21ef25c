"""Model assembly of the port: init / forward / prefill / decode for the
ssm family (the Mamba2 stack, attention-free).

The port of ``repro/models/model.py`` for ``family == "ssm"``.  The stack
is an ``nn.Module`` (:class:`Mamba2LM`: embedding, a ``ModuleList`` of
blocks looped in Python, final norm); the JAX version's ``lax.scan`` over
stacked parameters has no counterpart here.  Its remat does: with
``cfg.remat == "full"`` each block runs under
``torch.utils.checkpoint.checkpoint`` when autograd records the forward
(training); ``"dots"`` raises.  :func:`loss_fn` is the training loss.  The dense,
moe, hybrid and encdec families wait for later slices (ROADMAP Queue 1)
and raise.

Parameters are built frozen (``requires_grad=False``), as serving wants
them; the training entry points (``repro_torch.train.step``) turn
``requires_grad`` on.  Parameter names follow the JAX pytree: ``embed.tok``,
``blocks.<i>.norm.scale``, ``blocks.<i>.mixer.<name>``,
``final_norm.scale``; :func:`from_reference` carries the JAX package's
``init_params`` pytree (as numpy arrays, layer-stacked ``(L, ...)``
leaves under ``blocks``) across dtype for dtype.

The serving cache mirrors the JAX one: ``{"ssm": {"state": (L, B, h, p,
n), "conv": (L, B, W-1, conv_dim)}, "index": int}``; the SSM state and
conv carry are float32 whatever ``cache_dtype`` prefill is given, as in
the JAX package.  Entry points run on CUDA unless given ``device="cpu"``.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM

Cache = Dict[str, Any]


def _require_ssm(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet; only "
            f"'ssm' is (the others are in ROADMAP Queue 1)")
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
        _require_ssm(cfg)
        self.cfg = cfg
        dev = device if gen is not None else "meta"
        if gen is not None:
            embed = L.init_embedding(gen, cfg)
        else:
            embed = {"tok": torch.empty(cfg.vocab, cfg.d_model, device="meta",
                                        dtype=L._dtype(cfg.param_dtype))}
        self.embed = _norm(embed, dev)
        self.blocks = nn.ModuleList(Mamba2Block(cfg, gen, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _norm(L.init_norm(gen, cfg, cfg.d_model), dev)


def init_params(gen: Union[int, torch.Generator], cfg: ModelConfig,
                device=None) -> Mamba2LM:
    """Randomly initialised model from a seed or a CPU ``torch.Generator``
    (draws on the CPU, so a seed gives the same weights on every device),
    moved to ``device`` (default CUDA)."""
    _require_ssm(cfg)
    dev = resolve_device(device)
    if isinstance(gen, int):
        gen = torch.Generator().manual_seed(gen)
    return Mamba2LM(cfg, gen, dev)


# --------------------------------------------------------------------------- #
# Blocks, caches, stack
# --------------------------------------------------------------------------- #

def _apply_ssm_block(bp: Mamba2Block, x, cfg: ModelConfig, *, cache=None,
                     use_kernel=False):
    h = L.apply_norm(bp.norm, x, cfg)
    mix, new_cache = bp.mixer(h, cache=cache, use_kernel=use_kernel)
    return x + mix, new_cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Cache:
    """Serving cache for the ssm family.  ``max_seq`` and ``dtype`` do not
    enter it: the SSM cache has no sequence axis and is float32."""
    _require_ssm(cfg)
    one = SSM.init_ssm_cache(cfg, batch, device=resolve_device(device))
    st = {k: v[None].repeat(cfg.n_layers, *([1] * v.dim()))
          for k, v in one.items()}
    return {"ssm": st, "index": 0}


def _remat(cfg: ModelConfig) -> bool:
    """Whether each block is recomputed in the backward (the JAX package's
    ``_maybe_remat``): only when autograd records the forward."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got "
                         f"{cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return False
    if cfg.remat == "dots":
        raise NotImplementedError(
            "remat='dots' (save only the matrix products) is not ported yet "
            "(ROADMAP Queue 1 item 9); use 'full' or 'none'")
    return True


def _ssm_stack(params: Mamba2LM, x, cfg: ModelConfig, *, ssm_cache=None,
               use_kernel=False):
    if ssm_cache is None:
        remat = _remat(cfg)
        for bp in params.blocks:
            if remat:
                x, _ = checkpoint(bp, x, use_kernel=use_kernel,
                                  use_reentrant=False)
            else:
                x, _ = bp(x, use_kernel=use_kernel)
        return x, None
    new = {k: [] for k in ssm_cache}
    for i, bp in enumerate(params.blocks):
        layer_cache = {k: v[i] for k, v in ssm_cache.items()}
        x, out = bp(x, cache=layer_cache, use_kernel=use_kernel)
        for k in new:
            new[k].append(out[k])
    return x, {k: torch.stack(v) for k, v in new.items()}


# --------------------------------------------------------------------------- #
# Public API
# --------------------------------------------------------------------------- #

def forward(params: Mamba2LM, batch: Mapping[str, torch.Tensor],
            cfg: ModelConfig, *, cache: Optional[Cache] = None,
            last_only: bool = False
            ) -> Tuple[torch.Tensor, Optional[Cache], Dict]:
    """Compute logits (float32).

    batch: {'tokens': (B, S) integer}.  With ``cache`` the call is a
    serving step; ``last_only`` computes logits for the final position
    only (prefill -- avoids a (B, S, V) tensor).
    """
    _require_ssm(cfg)
    tokens = batch["tokens"]
    x = L.embed_tokens(params.embed, tokens, cfg)
    ssm_c = cache["ssm"] if cache is not None else None
    x, new_ssm = _ssm_stack(params, x, cfg, ssm_cache=ssm_c,
                            use_kernel=cfg.use_flash_kernel)
    new_cache = None
    if cache is not None:
        new_cache = {"ssm": new_ssm, "index": cache["index"] + tokens.shape[1]}
    if last_only:
        x = x[:, -1:]
    x = L.apply_norm(params.final_norm, x, cfg)
    logits = L.logits_from_hidden(params.embed, x, cfg)
    return logits, new_cache, {}


def loss_fn(params: Mamba2LM, batch: Mapping[str, torch.Tensor],
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy.  batch['labels'] (B, S); entries < 0 are
    ignored.  Returns (loss, {'loss', 'ce'})."""
    logits, _, _ = forward(params, batch, cfg)
    labels = batch["labels"]
    valid = labels >= 0
    labels_safe = labels.clamp(min=0).long()
    # logsumexp form: no second (B, S, V) log-softmax buffer
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = lse - gold
    denom = valid.sum().clamp(min=1)
    ce = torch.where(valid, nll, 0.0).sum() / denom
    return ce, {"loss": ce, "ce": ce}


def prefill(params: Mamba2LM, tokens: torch.Tensor, cfg: ModelConfig,
            max_seq: int, *, cache_dtype=torch.bfloat16
            ) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt through the model, returning (last_logits, cache)."""
    cache = init_cache(cfg, tokens.shape[0], max_seq, cache_dtype,
                       device=tokens.device)
    logits, cache, _ = forward(params, {"tokens": tokens}, cfg, cache=cache,
                               last_only=True)
    return logits, cache


def decode_step(params: Mamba2LM, cache: Cache, tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
    """One serving step: tokens (B, 1) -> (logits (B,1,V), new cache)."""
    logits, new_cache, _ = forward(params, {"tokens": tokens}, cfg,
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
    names (layer-stacked leaves split per layer)."""
    _require_ssm(cfg)
    out = {"embed.tok": params_np["embed"]["tok"],
           "final_norm.scale": params_np["final_norm"]["scale"]}
    blocks = params_np["blocks"]
    for i in range(cfg.n_layers):
        out[f"blocks.{i}.norm.scale"] = blocks["norm"]["scale"][i]
        for k, v in blocks["mixer"].items():
            out[f"blocks.{i}.mixer.{k}"] = v[i]
    return out


def from_reference(params_np: Mapping[str, Any], cfg: ModelConfig,
                   device=None) -> Mamba2LM:
    """The port's model holding the JAX package's parameters (the
    ``init_params`` pytree as numpy arrays), dtype for dtype, on
    ``device`` (default CUDA; ``"meta"`` checks shapes and dtypes only)."""
    dev = resolve_device(device)
    model = Mamba2LM(cfg)                       # on the meta device
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
