"""Architecture registry of the port: the ten configs of ``repro.configs``,
the (arch x shape) cells and the input stand-ins.

Every config is field for field the JAX package's, except that the
serving configs turn ``use_flash_kernel`` on (the port's hand-written
kernels are their serving path).  Every family builds, serves and trains:
ssm, dense, moe, hybrid and encdec.
"""
from __future__ import annotations

import importlib
from typing import List, Tuple

from repro_torch.configs.base import (
    ALL_SHAPES,
    LONG_CONTEXT_ARCHS,
    SHAPES_BY_NAME,
    AttentionConfig,
    ModelConfig,
    MoEConfig,
    RopeConfig,
    ShapeConfig,
    SSMConfig,
    shape_applicable,
)
from repro_torch.configs.specs import cache_struct, input_specs, params_struct

_ARCH_MODULES = {
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_ARCH_MODULES)


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE


def all_cells() -> List[Tuple[str, ShapeConfig, bool]]:
    """All 40 (arch, shape, applicable) cells in a stable order."""
    return [(arch, shape, shape_applicable(arch, shape, get_config(arch)))
            for arch in ARCH_IDS for shape in ALL_SHAPES]


__all__ = [
    "ALL_SHAPES", "ARCH_IDS", "LONG_CONTEXT_ARCHS", "SHAPES_BY_NAME",
    "AttentionConfig", "ModelConfig", "MoEConfig", "RopeConfig",
    "SSMConfig", "ShapeConfig", "all_cells", "cache_struct", "get_config",
    "get_smoke_config", "input_specs", "params_struct", "shape_applicable",
]
