"""Per-cell runtime settings and constructors for the (arch x shape) matrix
(counterpart of ``repro.launch.cells``).

``microbatches`` per train cell keep the remat'd activation footprint
small at global_batch=256 over data=16; ``zero1`` + ``fsdp`` shard the
fp32 state for the 33B / 132B configs.  The reference lowers each cell
with XLA; eager PyTorch compiles nothing, so ``Cell.count`` runs one step
of one rank on ``meta`` tensors under ``launch.cost.analyze``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import configs
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch import cost
from repro_torch.runtime import sharding as S
from repro_torch.runtime import step as ST
from repro_torch.tree import tree_map

# arch id -> gradient-accumulation microbatches for train_4k
TRAIN_MICROBATCHES = {
    "zamba2-2.7b": 4,
    "moonshot-v1-16b-a3b": 8,
    "dbrx-132b": 16,
    "deepseek-coder-33b": 16,
    "qwen2-7b": 8,
    "qwen3-1.7b": 4,
    "olmo-1b": 4,
    "falcon-mamba-7b": 16,
    "musicgen-large": 8,
    "pixtral-12b": 8,
}


def train_config_for(arch: str, **overrides: Any) -> TrainConfig:
    base = dict(
        microbatches=TRAIN_MICROBATCHES.get(arch, 8),
        remat_policy="full",
        zero1=True,
        fsdp=True,
        param_dtype="float32",
        compute_dtype="bfloat16",
    )
    base.update(overrides)
    return TrainConfig(**base)


def own(tree):
    """Each leaf with storage of its own (a shard of a ``meta`` tree is a
    view of the whole leaf's storage, which the memory count would see)."""
    return tree_map(lambda t: t.clone(), tree)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    cfg: ModelConfig
    kind: str  # "train" | "prefill" | "decode"
    artifacts: Any  # ShardedTrainStep | ServeStepArtifacts
    impl: str = "auto"

    def inputs(self) -> tuple:
        """One rank's abstract arguments of the step, sharded by the cell's
        specs, each leaf with storage of its own (``meta``)."""
        if self.kind == "train":
            step: ST.ShardedTrainStep = self.artifacts
            full = ST.abstract_train_state(self.cfg, step.tcfg)
            state = own(step._place(lambda t, s, m: S.shard_tensor(t, s, m), full,
                                     {k: step.state_specs[k] for k in full}))
            tree_map(lambda p: p.requires_grad_(True), state["params"])
            batch = own(step.shard_batch(ST.abstract_batch(self.cfg, self.shape)))
            return state, batch
        art: ST.ServeStepArtifacts = self.artifacts
        params, inputs, *cache = art.abstract_inputs()
        args = (own(art.shard_params(params)), own(art.shard_inputs(inputs)))
        if cache:
            args += (own(art.shard_cache(cache[0])),)
        return args

    def count(self, table: bool = False) -> dict:
        """``launch.cost.analyze`` of one step of this rank."""
        step = self.artifacts if self.kind == "train" else self.artifacts.step
        return cost.analyze(step, *self.inputs(), impl=self.impl, table=table)


def build_cell(
    arch: str,
    shape_name: str,
    mesh,
    *,
    train_overrides: dict | None = None,
    options: dict | None = None,
) -> Cell:
    """``options`` select beyond-baseline variants:
    pad_heads      -- physical TP head padding for non-divisible GQA
    cache_dtype    -- KV-cache storage dtype ("bfloat16" | "float8_e4m3fn")
    layout         -- "tp" (default) | "dp256" (model axis joins data: pure
                      DP+ZeRO-3; right call for small archs)
    impl           -- "auto" (the hand-written kernels) | "torch" (their
                      plain versions)
    The reference's ``moe_dispatch`` has no counterpart: the port keeps one
    dispatch (``models/moe.py``)."""
    options = options or {}
    cfg = configs.get_config(arch)
    shape = configs.get_shape(shape_name)
    ok, reason = configs.shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"cell ({arch}, {shape_name}) skipped: {reason}")
    if options.get("pad_heads"):
        cfg = cfg.padded_for_tp(mesh.shape.get("model", 1))
    impl = options.get("impl", "auto")
    cache_dtype = getattr(torch, options.get("cache_dtype", "bfloat16"))
    if shape.kind == "train":
        overrides = dict(train_overrides or {})
        if options.get("layout"):
            overrides["layout"] = options["layout"]
            if options["layout"] == "dp256":
                # B_local is 1 per device: grad accumulation is meaningless
                overrides.setdefault("microbatches", 1)
        tcfg = train_config_for(arch, **overrides)
        step = ST.ShardedTrainStep(cfg, tcfg, mesh, device=mesh.device)
        return Cell(arch, shape, cfg, "train", step, impl)
    if shape.kind == "prefill":
        art = ST.make_prefill_step(cfg, mesh, shape, compute_dtype=torch.bfloat16,
                                   impl=impl, cache_dtype=cache_dtype)
        return Cell(arch, shape, cfg, "prefill", art, impl)
    art = ST.make_serve_step(cfg, mesh, shape, compute_dtype=torch.bfloat16,
                             cache_dtype=cache_dtype)
    return Cell(arch, shape, cfg, "decode", art, impl)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful model FLOPs per step: 6*N_active*D for training, 2*N_active*D
    for inference (D = tokens processed by the step)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per slot
