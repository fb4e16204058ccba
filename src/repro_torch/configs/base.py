"""Model, training, speculative-decoding and SpecInF configuration (own
copies of ``repro.configs.base``'s ``ModelConfig``, ``TrainConfig``,
``SpecDecodeConfig`` / ``draft_config`` and ``SpecInFConfig``).

``ModelConfig`` keeps every field of the reference's: the ``dense``,
Mixture-of-Experts (``moe``), Mamba1 (``ssm``) and Zamba2 ``hybrid``
families' and the stub frontend's (``embed_inputs``: the ``audio`` and
``vlm`` families take precomputed d_model embeddings, as in the
reference), and its derived properties (``attention_free`` and
``sub_quadratic`` for the shape matrix, ``shape_applicable``).
``ShapeConfig`` and the four assigned input shapes are the reference's.  ``TrainConfig`` keeps the
reference's fields and defaults (the mesh layout ``zero1``, ``fsdp`` and
``layout`` is read only by a train step built on a mesh).  ``SpecInFConfig``
keeps what the runtime and the collocation planner read (the simulator's
busy hold and the revocation knob stay behind) and budgets the H100's
memory.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters for one decoder-style backbone:
    ``dense`` (attention + MLP every layer), ``moe`` (attention + a top-k
    Mixture-of-Experts every layer), ``ssm`` (a Mamba1 block every layer,
    attention-free), ``hybrid`` (Mamba2 blocks with ONE shared attention +
    MLP block applied before every ``shared_attn_every`` of them, Zamba2
    style), ``audio`` (the dense backbone over precomputed EnCodec frame
    embeddings) or ``vlm`` (the dense backbone over precomputed ViT patch
    embeddings)."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # --- SSM (Mamba) ---
    ssm_state: int = 0
    ssm_version: int = 0  # 1 = Mamba1 (falcon-mamba), 2 = Mamba2 (zamba2)
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64  # Mamba2 only
    dt_rank: int = 0  # Mamba1 only; 0 -> ceil(d_model / 16)

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

    # --- hybrid (Zamba2) ---
    shared_attn_every: int = 0  # the shared attn + MLP block every N layers

    # --- modality frontend ---
    embed_inputs: bool = False  # True: inputs are precomputed d_model embeddings

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

    def padded_for_tp(self, tp: int) -> "ModelConfig":
        """A config whose physical q-head count divides ``tp`` (each GQA
        group padded with masked slots); self when already divisible or no
        padding within 4x the group exists."""
        if self.num_heads == 0 or self.num_heads % tp == 0:
            return self
        kv = max(self.num_kv_heads, 1)
        group = -(-self.num_heads // kv)  # logical heads per kv group
        group_phys = group
        while (kv * group_phys) % tp != 0:
            group_phys += 1
            if group_phys > 4 * group:  # no sane padding exists
                return self
        return dataclasses.replace(self, pad_heads_to=kv * group_phys)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads == 0:
            return 0
        return self.d_model // self.num_heads

    @property
    def resolved_dt_rank(self) -> int:
        if self.dt_rank:
            return self.dt_rank
        return int(math.ceil(self.d_model / 16))

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        """Mamba2 head count (d_inner / ssm_head_dim); 0 for Mamba1."""
        if self.ssm_version != 2:
            return 0
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True when the arch can run the 500k long-context decode shape."""
        return self.family in ("ssm", "hybrid")

    # --- analytic parameter counts (the reference's, for these families) ---
    def param_count(self) -> int:
        """Total parameters of the tree ``init_params`` builds."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.parametric_norm:
            n += d  # final norm
        if self.family == "ssm":
            per_layer = self._mamba1_params() + (d if self.parametric_norm else 0)
        elif self.family == "hybrid":
            per_layer = self._mamba2_params() + (d if self.parametric_norm else 0)
            if self.shared_attn_every:  # the one shared block, counted once
                n += self._attn_params(d, hd) + 3 * d * self.d_ff + 2 * d
        else:
            per_layer = self._attn_params(d, hd)
            if self.family == "moe":
                per_layer += self.num_experts * 3 * d * self.d_ff  # gate/up/down
                per_layer += d * self.num_experts  # router
            else:
                per_layer += 3 * d * self.d_ff
            per_layer += 2 * d if self.parametric_norm else 0  # two norms
        return n + self.num_layers * per_layer

    def _attn_params(self, d: int, hd: int, physical: bool = True) -> int:
        h = self.num_heads_physical if physical else self.num_heads
        q = d * h * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = h * hd * d
        b = (h + 2 * self.num_kv_heads) * hd if self.qkv_bias else 0
        qk = 2 * hd if self.qk_norm else 0
        return q + kv + o + b + qk

    def _mamba1_params(self) -> int:
        d, di, ds = self.d_model, self.d_inner, self.ssm_state
        dtr = self.resolved_dt_rank
        n = d * 2 * di  # in_proj -> (x, z)
        n += di * self.ssm_conv + di  # depthwise conv + bias
        n += di * (dtr + 2 * ds)  # x_proj -> (dt, B, C)
        n += dtr * di + di  # dt_proj
        n += di * ds + di  # A_log, D
        n += di * d  # out_proj
        return n

    def _mamba2_params(self) -> int:
        d, di, ds = self.d_model, self.d_inner, self.ssm_state
        nh = self.ssm_num_heads
        n = d * (2 * di + 2 * ds + nh)  # in_proj -> (z, x, B, C, dt)
        n += (di + 2 * ds) * (self.ssm_conv + 1)  # conv over (x, B, C) + bias
        n += nh * 3  # A_log, D, dt_bias
        n += di  # gated RMSNorm weight
        n += di * d  # out_proj
        return n

    def active_param_count(self) -> int:
        """Parameters a token's forward uses: the MoE family counts its
        ``experts_per_token`` routed experts, not all of them; masked
        padding heads are left out."""
        d, l = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        if self.family != "moe":
            if not self.padded_heads:
                return self.param_count()
            pad = self._attn_params(d, hd, True) - self._attn_params(d, hd, False)
            if self.family == "hybrid" and self.shared_attn_every:
                return self.param_count() - pad  # one shared block
            return self.param_count() - l * pad
        per_layer = self._attn_params(d, hd, physical=False)
        per_layer += self.experts_per_token * 3 * d * self.d_ff
        per_layer += d * self.num_experts
        per_layer += 2 * d if self.parametric_norm else 0
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.parametric_norm:
            n += d
        return n + l * per_layer


# ---------------------------------------------------------------------------
# Input shapes (assigned shape set for the LM family)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch, shape) cell is runnable; reason string when skipped
    (the reference's words)."""
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False, "long_500k skipped: pure full-attention arch (see DESIGN.md §5)"
    return True, ""


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
    remat_policy: str = "none"  # "none" | "dots" | "full"
    zero1: bool = False  # shard optimizer state over the data axis
    fsdp: bool = True  # additionally shard big params over the data axis
    layout: str = "tp"  # "tp" | "dp256" (model axis joins data parallelism)
    grad_compression: str = "none"  # "none" | "int8_ef" (local error feedback)
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
    #: per-instance busy hold after an online pull, read by the timeline
    #: simulator (``core.simulator``); 0 = no hold
    busy_hold_ms: float = 25.0
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
    #: revocable grants: > 0 splits each bubble quantum into sub-dispatches
    #: of at most this many microsteps with ``Grant.revocation`` re-checked
    #: between them; 0 keeps one dispatch a quantum
    revocation_check_steps: int = 0


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
    and head dim, ``spec.draft_layers`` layers, and d_model, d_ff, the head
    counts and an explicit Mamba1 ``dt_rank`` scaled by
    ``spec.draft_width_factor`` (GQA grouping kept exact; a family without
    heads keeps none; a hybrid's depth rounded up to whole cycles and its
    d_model to whole Mamba2 heads), as the reference's.  For qwen3-1.7b: 1
    layer, d_model 1024, 8 q / 8 kv heads of 128, d_ff 3072."""
    layers = max(1, spec.draft_layers)
    changes: dict = {"name": target.name + "-draft"}
    if target.shared_attn_every:
        every = target.shared_attn_every
        changes["num_layers"] = max(every, -(-layers // every) * every)
    else:
        changes["num_layers"] = min(layers, target.num_layers)
    wf = spec.draft_width_factor
    if wf != 1.0:
        if target.num_heads:
            hd = target.resolved_head_dim
            heads = max(1, int(round(target.num_heads * wf)))
            kv = max(1, min(target.num_kv_heads, heads))
            while heads % kv:  # GQA grouping must stay exact
                kv -= 1
            changes.update(num_heads=heads, num_kv_heads=kv, head_dim=hd,
                           d_model=max(hd, int(round(target.d_model * wf))))
        else:  # Mamba1: no heads
            changes["d_model"] = max(16, int(round(target.d_model * wf)))
        if target.ssm_version == 2:  # Mamba2 heads must divide d_inner
            di = target.ssm_expand * changes["d_model"]
            changes["d_model"] = (
                -(-di // target.ssm_head_dim) * target.ssm_head_dim
            ) // target.ssm_expand
        if target.d_ff:
            changes["d_ff"] = max(16, int(round(target.d_ff * wf)))
        if target.dt_rank:
            changes["dt_rank"] = max(1, int(round(target.dt_rank * wf)))
    return dataclasses.replace(target, **changes)
