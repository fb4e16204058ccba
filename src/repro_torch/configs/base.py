"""Model, training, speculative-decoding and SpecInF configuration (own
copies of ``repro.configs.base``'s ``ModelConfig``, ``TrainConfig``,
``SpecDecodeConfig`` / ``draft_config`` and ``SpecInFConfig``).

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


# ---------------------------------------------------------------------------
# Speculative decoding (draft / target pairing)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpecDecodeConfig:
    """Draft/target speculative-decoding pairing (``repro_torch.spec``).

    The draft shares the target's family and vocabulary (verification is
    token for token) but runs a fraction of its depth and width; acceptance
    measures how well the draft tracks the target, while correctness comes
    from the verify pass alone."""

    draft_layers: int = 1  # draft depth
    draft_width_factor: float = 0.5  # d_model / d_ff / head-count shrink
    gamma_buckets: tuple[int, ...] = (1, 2, 4)  # draft lengths the engine runs
    mode: str = "greedy"  # "greedy" | "sample" | "simulated"
    sim_accept_p: float = 0.9  # Bernoulli acceptance of "simulated" mode
    draft_cost_ratio: float = 0.25  # draft step cost / target step cost
    accept_ewma: float = 0.5  # acceptance smoothing of the gamma controller

    # --- pluggable proposers (repro_torch.spec.proposers) ---
    #: "auto" registers the draft model and the n-gram lookup on a
    #: draft-paired engine (nothing on a plain one) and routes per quantum;
    #: "draft" / "ngram" pin one ("ngram" speculates without a draft model);
    #: "none" disables routing (the draft pairing alone decides)
    proposer: str = "auto"
    ngram_order: int = 3  # trailing n-gram the lookup proposer matches
    tree_width: int = 1  # candidate branches per host-proposed round
    router_ewma: float = 0.5  # router acceptance smoothing
    router_init_acceptance: float = 0.7  # optimistic seed: try every proposer


def draft_config(
    target: ModelConfig, spec: SpecDecodeConfig = SpecDecodeConfig()
) -> ModelConfig:
    """A cheap draft model derived from ``target``: same family, vocabulary
    and head dim, ``spec.draft_layers`` layers, and d_model, d_ff and the
    head counts scaled by ``spec.draft_width_factor`` (GQA grouping kept
    exact).  For qwen3-1.7b: 1 layer, d_model 1024, 8 q / 8 kv heads of
    128, d_ff 3072."""
    changes: dict = {
        "name": target.name + "-draft",
        "num_layers": min(max(1, spec.draft_layers), target.num_layers),
    }
    wf = spec.draft_width_factor
    if wf != 1.0:
        hd = target.resolved_head_dim
        heads = max(1, int(round(target.num_heads * wf)))
        kv = max(1, min(target.num_kv_heads, heads))
        while heads % kv:  # GQA grouping must stay exact
            kv -= 1
        changes.update(
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_model=max(hd, int(round(target.d_model * wf))),
            d_ff=max(16, int(round(target.d_ff * wf))),
        )
    return dataclasses.replace(target, **changes)
