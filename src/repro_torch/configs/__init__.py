"""Architecture registry, the reference's ten archs: the dense family
(qwen3-1.7b, olmo-1b, qwen2-7b, deepseek-coder-33b), the Mixture-of-Experts
family (moonshot-v1-16b-a3b, dbrx-132b), Mamba1 (falcon-mamba-7b), the
Zamba2 hybrid (zamba2-2.7b), and the dense backbones over stub-frontend
embeddings: audio (musicgen-large) and VLM (pixtral-12b).

Public ids use dashes (``--arch qwen3-1.7b``); modules use underscores.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    SpecDecodeConfig,
    SpecInFConfig,
    TrainConfig,
    draft_config,
    shape_applicable,
)

_ARCH_MODULES = {
    "zamba2-2.7b": "zamba2_2p7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "dbrx-132b": "dbrx_132b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen2-7b": "qwen2_7b",
    "qwen3-1.7b": "qwen3_1p7b",
    "olmo-1b": "olmo_1b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "musicgen-large": "musicgen_large",
    "pixtral-12b": "pixtral_12b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_shape(shape: str) -> ShapeConfig:
    if shape not in SHAPES:
        raise KeyError(f"unknown shape {shape!r}; known: {sorted(SHAPES)}")
    return SHAPES[shape]


def all_cells(include_skipped: bool = False):
    """Yield (arch_id, shape_name, applicable, reason) for the 40-cell matrix."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, reason = shape_applicable(cfg, shape)
            if ok or include_skipped:
                yield arch, shape.name, ok, reason


def smoke_config(arch: str) -> ModelConfig:
    """Reduced config: same family and block layout, tiny dims, CPU-runnable
    (the same reduction as ``repro.configs.smoke_config``)."""
    full = get_config(arch)
    reduced = dict(
        name=full.name + "-smoke",
        num_layers=2 if full.family != "hybrid" else 4,
        d_model=64,
        d_ff=128 if full.d_ff else 0,
        vocab_size=256,
        head_dim=16 if full.num_heads else 0,
        rope_theta=full.rope_theta,
    )
    if full.num_heads:
        reduced["num_heads"] = 4
        reduced["num_kv_heads"] = 4 if full.num_kv_heads == full.num_heads else 2
    if full.family == "moe":
        reduced["num_experts"] = 4
        reduced["experts_per_token"] = 2
    if full.ssm_version:
        reduced["ssm_state"] = 8
        reduced["ssm_head_dim"] = 16
        reduced["dt_rank"] = 8
    if full.shared_attn_every:
        reduced["shared_attn_every"] = 2
    return dataclasses.replace(full, **reduced)


__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "SpecDecodeConfig",
    "SpecInFConfig",
    "TrainConfig",
    "all_cells",
    "draft_config",
    "get_config",
    "get_shape",
    "shape_applicable",
    "smoke_config",
]
