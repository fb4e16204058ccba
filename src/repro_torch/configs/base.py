"""Model, training and SpecInF configuration (own copies of
``repro.configs.base``'s ``ModelConfig``, ``TrainConfig`` and
``SpecInFConfig``).

Only the fields and derived properties of the ``dense`` family, the one
family the port runs, are kept; the MoE, SSM, hybrid and frontend fields
return with the slices that run those families.  ``TrainConfig`` keeps the
reference's fields and defaults except the mesh layout (``zero1``,
``fsdp``, ``layout``), which returns with scale-out.  ``SpecInFConfig``
keeps what the runtime and the collocation planner read (the simulator's
busy hold and the revocation knob stay behind) and budgets the H100's
memory.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters for one decoder-style backbone of the
    ``dense`` family (attention + MLP every layer)."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention options ---
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    #: physical q-head padding for tensor parallelism (0 = disabled); padded
    #: slots are masked by ``layers.head_mask``
    pad_heads_to: int = 0

    # --- norm options ---
    norm_type: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    parametric_norm: bool = True

    tie_embeddings: bool = False

    @property
    def num_heads_physical(self) -> int:
        """Physical q-head slots (>= num_heads when padded for TP)."""
        if self.pad_heads_to:
            if self.pad_heads_to < self.num_heads or (
                self.pad_heads_to % max(self.num_kv_heads, 1)
            ):
                raise ValueError(
                    f"pad_heads_to={self.pad_heads_to} must be >= num_heads "
                    f"and a multiple of num_kv_heads"
                )
            return self.pad_heads_to
        return self.num_heads

    @property
    def padded_heads(self) -> bool:
        return self.num_heads_physical != self.num_heads

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads == 0:
            return 0
        return self.d_model // self.num_heads


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip_norm: float = 1.0
    schedule: str = "cosine"  # "cosine" | "linear" | "constant"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat_policy: str = "none"  # "none" | "full" ("dots" is not ported yet)
    grad_compression: str = "none"  # "none" ("int8_ef" is not ported yet)
    microbatches: int = 1  # gradient accumulation
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class SpecInFConfig:
    """Algorithm-1 and monitor parameters (paper §3.3)."""

    alpha: int = 2  # conservative-phase threshold on the zero-count
    beta: int = 3  # incremental/stable boundary
    gamma: float = 2.0  # multiplicative token growth
    lower_limit: float = 8.0  # LL: token cap in the incremental phase
    upper_limit: float = 64.0  # UL: token cap in the stable phase
    token_seed: float = 1.0  # tokens restart from this after a zero
    window_ms: float = 2.0  # monitor sliding-window period (paper: 2ms)
    window_len: int = 64  # sliding-window capacity
    #: Principle-I memory budget: one NVIDIA H100 SXM's 80 GB of HBM3
    #: (data sheet)
    hbm_limit_bytes: int = 80 * 10**9
    max_instances: int = 8
    #: cap on the tokens one engine step may consume (decode tokens plus
    #: prefill chunk tokens); 0 = unmetered
    step_token_budget: float = 0.0
    #: profiled per-prefill-token step cost in microstep-equivalents; 0
    #: keeps prefill free in the cost model
    prefill_token_cost_steps: float = 0.0
