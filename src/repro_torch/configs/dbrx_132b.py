"""dbrx-132b — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base;
unverified].

40 layers, d_model=6144, 48H GQA (kv=8), per-expert d_ff=10752, vocab=100352.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    head_dim=128,
    num_experts=16,
    experts_per_token=4,
    norm_type="layernorm",
)
