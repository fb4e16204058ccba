"""zamba2-2.7b -- hybrid Mamba2 + shared attention blocks [arXiv:2411.15242; hf].

54 Mamba2 layers (d_model=2560, d_inner=5120, ssm_state=64, 80 SSM heads of
64) with a single *shared* attention (32 MHA heads of 80) + MLP (d_ff=10240)
block applied before every 6 layers (weights shared across its 9
applications, Zamba2 style); vocab 32000, untied.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    ssm_state=64,
    ssm_version=2,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_every=6,
)
