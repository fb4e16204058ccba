"""pixtral-12b -- pixtral-ViT + mistral-nemo decoder
[hf:mistralai/Pixtral-12B-2409; unverified].

40 layers, d_model=5120, 32 heads of 128 over 8 KV heads (GQA group 4),
d_ff=14336, vocab=131072, rope theta 1e6.  The ViT patch frontend is a
stub, as in the reference: the model takes precomputed patch embeddings of
width d_model (``embed_inputs``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    rope_theta=1_000_000.0,
    embed_inputs=True,
)
