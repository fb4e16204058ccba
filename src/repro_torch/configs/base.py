"""Model configuration (own copy of ``repro.configs.base.ModelConfig``).

Only the fields and derived properties of the ``dense`` family, the one
family the port serves, are kept; the MoE, SSM, hybrid and frontend fields
return with the slices that serve those families.
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
