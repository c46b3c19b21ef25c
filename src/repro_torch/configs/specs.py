"""Input stand-ins for every (arch x shape) cell: the port of
``repro/configs/specs.py`` without JAX.

``*_input_specs`` give each input's ``(shape, dtype)``.  Modality
frontends are stubs, as in the JAX package: whisper receives precomputed
audio frame embeddings ('frames', (B, enc_seq, d_model) bf16, for a train
step and a prefill; a decode step reads the cached cross K/V instead),
qwen2-vl token ids plus (B, 3, S) M-RoPE position triples.
:func:`params_struct` and :func:`cache_struct` build the model and the
serving cache on the meta device (shapes and dtypes, no allocation), for
every family.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

Spec = Tuple[Tuple[int, ...], torch.dtype]


def _mrope(cfg: ModelConfig) -> bool:
    rope = cfg.attention.rope
    return rope is not None and rope.mrope_sections is not None


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Spec]:
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": ((B, S), torch.int32), "labels": ((B, S), torch.int32)}
    if cfg.family == "encdec":
        specs["frames"] = ((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    if _mrope(cfg):
        specs["positions"] = ((B, 3, S), torch.int32)
    return specs


def prefill_input_specs(cfg: ModelConfig,
                        shape: ShapeConfig) -> Dict[str, Spec]:
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": ((B, S), torch.int32)}
    if cfg.family == "encdec":
        specs["frames"] = ((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    if _mrope(cfg):
        specs["positions"] = ((B, 3, S), torch.int32)
    return specs


def decode_input_specs(cfg: ModelConfig,
                       shape: ShapeConfig) -> Dict[str, Spec]:
    """One new token per sequence; the KV/state cache holds shape.seq_len."""
    B = shape.global_batch
    specs = {"tokens": ((B, 1), torch.int32)}
    if _mrope(cfg):
        specs["positions"] = ((B, 3, 1), torch.int32)
    return specs


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Spec]:
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    if shape.kind == "decode":
        return decode_input_specs(cfg, shape)
    raise ValueError(shape.kind)


def params_struct(cfg: ModelConfig):
    """The model on the meta device: every parameter's shape and dtype,
    nothing allocated."""
    from repro_torch.models.model import model_class
    return model_class(cfg)(cfg)


def cache_struct(cfg: ModelConfig, batch: int, max_seq: int,
                 dtype=torch.bfloat16):
    """The serving cache on the meta device (no allocation)."""
    from repro_torch.models.model import init_cache
    return init_cache(cfg, batch, max_seq, dtype, device="meta")
