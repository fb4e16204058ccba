"""Architecture registry, limited to the archs the port runs.

Public ids use dashes (``--arch qwen3-1.7b``); modules use underscores.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (
    ModelConfig,
    SpecDecodeConfig,
    SpecInFConfig,
    TrainConfig,
    draft_config,
)

_ARCH_MODULES = {
    "qwen3-1.7b": "qwen3_1p7b",
    "olmo-1b": "olmo_1b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced config: same family and block layout, tiny dims, CPU-runnable
    (the same reduction as ``repro.configs.smoke_config``)."""
    full = get_config(arch)
    reduced = dict(
        name=full.name + "-smoke",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        rope_theta=full.rope_theta,
        num_heads=4,
        num_kv_heads=4 if full.num_kv_heads == full.num_heads else 2,
    )
    return dataclasses.replace(full, **reduced)


__all__ = [
    "ARCH_IDS",
    "ModelConfig",
    "SpecDecodeConfig",
    "SpecInFConfig",
    "TrainConfig",
    "draft_config",
    "get_config",
    "smoke_config",
]
