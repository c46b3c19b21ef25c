"""Architecture registry of the port: the configs ported so far.

Ported: ``mamba2-130m`` (the ssm family) and ``olmo-1b`` (the dense
family); the other architectures of ``repro.configs`` are listed in
ROADMAP Queue 1 and raise here.
"""
from __future__ import annotations

import importlib
from typing import Tuple

from repro_torch.configs.base import (
    AttentionConfig,
    ModelConfig,
    MoEConfig,
    RopeConfig,
    ShapeConfig,
    SSMConfig,
)

_ARCH_MODULES = {
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "olmo-1b": "repro_torch.configs.olmo_1b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_ARCH_MODULES)


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(
            f"arch {arch_id!r} is not ported to repro_torch yet (ported: "
            f"{sorted(_ARCH_MODULES)}); the other families are in ROADMAP "
            f"Queue 1")
    return importlib.import_module(_ARCH_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE


__all__ = [
    "ARCH_IDS", "AttentionConfig", "ModelConfig", "MoEConfig", "RopeConfig",
    "SSMConfig", "ShapeConfig", "get_config", "get_smoke_config",
]
